"""synth24's brick layout (2 lattices) over a long run: ``tools/torch_quality_synth24.py``'s
``train`` against the JAX tool's loop for 256 steps (16 spans of 16 steps, a grid refresh
after each), on ``tests/test_torch_quality.py``'s small scene and network. The vertex layout
runs the same, as the yardstick.

Both sides take the deterministic march (op by op on the JAX side, ``ngp_march``) and the
refreshes take JAX's draws, injected as ``GridDraws``; the JAX loop's optimizer state
carries across spans, as the JAX tool's does.

Two f32 loops that agree step for step still drift apart here, in both layouts: Adam's
eps of 1e-15 turns a gradient that differs by rounding into a step of full size, so the
parameters' per-leaf cosine falls from > 0.99999 after the first span to ~0.92 (vertex)
and ~0.90 (brick, whose table rows see fewer points) by step 256. So the bars are the
first span's parameters per leaf (cosine > 0.999, norm ratio within 1e-3 of 1, the bars of
``tests/test_torch_quality.py``), the grid's occupancy bits under 1 % of cells apart after
every refresh, and, after the run, the last step's train PSNR within 0.5 dB of JAX's, and
each held-out view at most 0.5 dB (half the quality rows' 1.0 dB bar) and 0.01 SSIM under
JAX's, the quality rows' one-sided form: the question is whether the port's brick learns
worse than JAX's (a spread of the drift alone reached +0.27 dB and +0.027 SSIM, the port
above).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from test_torch_quality import (  # noqa: F401  (scene24 and ngp_march are fixtures)
    _MARCH,
    NGP_KW,
    _grid_draws,
    _init,
    _jax_metrics,
    _jb,
    _load,
    _same_params,
    _tool,
    ngp_march,
    scene24,
)

torch = pytest.importorskip("torch")

SPANS = 16  # 256 steps
PSNR_DB, SSIM_TOL, BITS_OFF = 0.5, 1e-2, 1e-2


def _min_leaf_cos(net, params):
    """The smallest per-leaf cosine of the port's parameters against a JAX tree."""
    from xrnerf_torch.utils.weights import state_dict_from_jax

    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    cos = []
    for k, p in net.named_parameters():
        a, b = p.detach().double().flatten(), torch.from_numpy(want[k]).double().flatten()
        if a.any() or b.any():
            cos.append(float(a @ b / (a.norm() * b.norm() + 1e-30)))
    return min(cos)


@pytest.mark.parametrize("layout", ["vertex", "brick"])
def test_synth24_long_run_matches_jax(scene24, ngp_march, layout, capsys):
    from xrnerf_tpu.datasets.hashnerf import HashNerfDataset as JDS
    from xrnerf_tpu.models.networks.hashnerf import HashNerfNetwork as JNet

    from xrnerf_torch.datasets.hashnerf import HashNerfDataset
    from xrnerf_torch.models.networks.hashnerf import HashNerfNetwork

    tool = _tool("synth24")
    kw = dict(NGP_KW, hash_layout=layout, n_lattices=2 if layout == "brick" else 1)
    jds = JDS(scene24, half_res=False, testskip=1, N_rand=256)
    ds = HashNerfDataset(scene24, half_res=False, testskip=1, N_rand=256)
    jnet = JNet(**kw, dtype=jnp.float32)
    params = _init(jnet, jds.train_batch(0))
    net = HashNerfNetwork(**kw, dtype=torch.float32)
    params = _load(net, params)
    jgrid = jnet.init_aux(params, jds)
    net.init_aux(ds)

    # the JAX tool's loop: spans of 16 steps, one optimizer state, update_aux after each span
    tx = optax.adam(1e-2, b2=0.99, eps=1e-15)
    opt = tx.init(params)

    @jax.jit
    def step(p, o, b, m, aux):
        _MARCH["m"] = m

        def lf(p):
            loss, logs = jnet.loss(jnet.apply({"params": p}, b, rng=None, train=True, aux=aux), b)
            return loss, logs["psnr"]

        (_, psnr), g = jax.value_and_grad(lf, has_aux=True)(p)
        u, o = tx.update(g, o)
        return optax.apply_updates(p, u), o, psnr

    refresh = jax.jit(jnet.update_aux)
    half = jnet.grid_update_samples // 2
    spans, draws = [], []
    for d in range(SPANS):
        march = ngp_march(jnet, jgrid)
        for i in range(d * tool.SPAN, (d + 1) * tool.SPAN):
            b = _jb(jds.train_batch(i))
            params, opt, jpsnr = step(params, opt, b, march(b), jgrid)
        key = jax.random.fold_in(jax.random.PRNGKey(0), 2**30 + d)
        draws.append(_grid_draws(key, jgrid, half, jnet.grid_update_samples - half))
        jgrid = refresh(params, jgrid, jnp.asarray(d * tool.SPAN), key)
        spans.append((jax.tree_util.tree_map(np.asarray, params), np.asarray(jgrid.bitfield)))

    bits_off, leaf_cos = [], []

    def on_span(d):
        want, jbits = spans[d]
        if d == 0:
            _same_params(net, want)
        leaf_cos.append(_min_leaf_cos(net, want))
        bits_off.append(float((net.grid_bitfield.numpy() != jbits).mean()))
        assert bits_off[-1] < BITS_OFF, f"span {d}: occupancy bits apart on {bits_off[-1]:.2%} of cells"

    psnr, psnrs, _ = tool.train(net, ds, SPANS * tool.SPAN, "cpu", step_gen=lambda i: None,
                                refresh_draws=lambda d: draws[d], log_every=0, on_span=on_span)
    assert len(bits_off) == SPANS and psnrs[-1] > psnrs[0] + 5  # it learns
    assert abs(psnr - float(jpsnr)) < PSNR_DB, (psnr, float(jpsnr))

    # the held-out views after the run (768-ray chunks, the last of each view padded)
    chunk = 768

    @jax.jit
    def render_chunk(p, b, m):
        _MARCH["m"] = m
        return jnet.apply({"params": p}, b, rng=None, train=False, aux=jgrid)["rgb"]

    march = ngp_march(jnet, jgrid)
    want = []
    for vi in jds.i_val:
        rays, gt = jds.image_rays(vi), jds.imgs[vi]
        n = rays["rays_o"].shape[0]
        pad = (-n) % chunk
        rays = {k: np.concatenate([v, np.repeat(v[-1:], pad, 0)]) for k, v in rays.items()}
        chunks = [_jb({k: v[s:s + chunk] for k, v in rays.items()}) for s in range(0, n + pad, chunk)]
        jimg = np.concatenate([np.asarray(render_chunk(spans[-1][0], c, march(c))) for c in chunks])[:n]
        want.append(_jax_metrics(jimg.reshape(gt.shape), gt))
    vp, vs = tool.evaluate(net, ds, "cpu", chunk)
    with capsys.disabled():
        print(f"\n{layout}: smallest leaf cosine after spans 1/4/8/16 "
              f"{[round(leaf_cos[i], 5) for i in (0, 3, 7, SPANS - 1)]}, bits apart at most {max(bits_off):.3%}, "
              f"train PSNR {psnr:.3f} (JAX {float(jpsnr):.3f}), held-out PSNR / SSIM "
              f"{[(round(a, 3), round(b, 4)) for a, b in zip(vp, vs)]} (JAX "
              f"{[(round(a, 3), round(b, 4)) for a, b in want]})")
    for got, w in zip(zip(vp, vs), want):
        assert got[0] > w[0] - PSNR_DB and got[1] > w[1] - SSIM_TOL, (layout, got, w)
