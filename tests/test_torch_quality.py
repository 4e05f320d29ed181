"""The port's quality tools (``tools/torch_quality_synth24.py``,
``torch_quality_neuralbody.py``, ``torch_quality_gnr.py``) held against the
JAX tools' loops on the CPU at small widths.

For each tool the JAX side is the JAX tool's loop recomposed here from
``xrnerf_tpu`` modules with the tool's own optimizer settings (Instant-NGP:
optax Adam 1e-2, b2 0.99, eps 1e-15, a grid refresh after 16 steps;
NeuralBody: Adam 5e-4; GNR: Adam 1e-4), and the port's side is the tool's
own ``train`` / ``evaluate`` (/ ``mesh_error``) on the same numpy data, from
the JAX init carried across by ``utils/weights.py``. Both sides take the
deterministic paths (no march, sample or noise jitter); the grid refresh
takes JAX's draws, injected as ``GridDraws``. Each tool's ``main`` also runs
end to end on the CPU at a tiny size with JAX, optax, flax and
``xrnerf_tpu`` hidden, and raises on a host without a card unless asked for
the CPU.

Tolerances (f32 on both sides): parameters after the steps per leaf cosine
> 0.999 and norm ratio within 1e-3 of 1; held-out PSNR within 0.05 dB and
SSIM within 1e-3; the train PSNR of the last step within 0.05 dB; the
refreshed grid's occupancy bits apart on under 0.1 % of cells, its densities
within 1 % (+ 1e-5, from parameters that agree to the bars above); GNR's mesh
(``n_grid`` 16): the same face count, radial MAE within 1e-3, and vertex
counts within 1 % (``marching_tetrahedra`` welds the copies of an edge's
vertex by their position quantized at 1e-5 of a cell, and values that agree
to rounding put a few copies on either side of a step).
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from xrnerf_torch.datasets.load.synthetic import (  # noqa: E402
    make_synthetic_blender,
    make_synthetic_genebody,
    make_synthetic_zju,
)
from xrnerf_torch.models.samplers.occupancy import GridDraws  # noqa: E402
from xrnerf_torch.utils.weights import state_dict_from_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_COS, RATIO_TOL = 0.999, 1e-3
PSNR_DB, SSIM_TOL, MESH_MAE, MESH_VERTS = 0.05, 1e-3, 1e-3, 0.01
HIDDEN = ("jax", "jaxlib", "optax", "flax", "xrnerf_tpu")
TOOLS = ("synth24", "neuralbody", "gnr")

NGP_KW = dict(n_levels=4, log2_table_size=12, base_res=4, max_res=64, grid_res=16, n_candidates=64, n_keep=16,
              grid_update_samples=512)
NB_KW = dict(n_verts=6890, code_dim=4, grid_dims=(16, 16, 16), conv_widths=(8, 8, 8), num_frames=4,
             appearance_dim=8, hidden=32, n_samples=16)
GNR_KW = dict(num_views=4, n_samples=16, load_size=32, num_stack=1, num_hourglass=1, hourglass_dim=32, mlp_depth=3,
              mlp_width=32, skips=(1,), mesh_chunk=256)


def _tool(name):
    """``tools/torch_quality_<name>.py`` as a fresh module."""
    path = os.path.join(ROOT, "tools", f"torch_quality_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_quality_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _init(jnet, batch):
    """flax's init of the JAX network at ``PRNGKey(0)``, as the JAX tools draw it."""
    return jax.jit(lambda b: jnet.init(jax.random.PRNGKey(0), b, rng=None, train=False))(_jb(batch))["params"]


def _load(net, params):
    params = jax.tree_util.tree_map(np.asarray, params)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(params).items()}, strict=False)
    return params


def _same_params(net, params, null=()):
    """Every parameter of the port's network against the JAX tree's, per
    leaf. A ``null`` leaf's gradient is zero in exact arithmetic, so Adam
    moves it by rounding alone (up to lr a step, either way) on each side:
    it is not compared."""
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    got = {k: v.detach() for k, v in net.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k in null:
            continue
        a, b = got[k].double().flatten(), torch.from_numpy(w).double().flatten()
        if not (a.any() or b.any()):
            continue
        cos = float(a @ b / (a.norm() * b.norm() + 1e-30))
        ratio = float(a.norm() / (b.norm() + 1e-30))
        assert cos > MIN_COS and abs(ratio - 1) < RATIO_TOL, (k, cos, ratio)


_MARCH = {}  # the march a jitted Instant-NGP step reads (see ``ngp_march``)


def _jax_steps(jnet, params, tx, batches, march=None, **apply_kw):
    """The JAX tools' jitted step (``value_and_grad`` of the loss, optax
    update) on each batch in turn, deterministic path: (params, last step's
    psnr). ``march(batch)``, when given, marches the batch outside the step
    (``ngp_march``)."""
    opt = tx.init(params)

    @jax.jit
    def step(p, o, b, m):
        _MARCH["m"] = m

        def lf(p):
            out = jnet.apply({"params": p}, b, rng=None, train=True, **apply_kw)
            loss, logs = jnet.loss(out, b)
            return loss, logs["psnr"]

        (_, psnr), g = jax.value_and_grad(lf, has_aux=True)(p)
        u, o = tx.update(g, o)
        return optax.apply_updates(p, u), o, psnr

    psnr = None
    for b in batches:
        b = _jb(b)
        params, opt, psnr = step(params, opt, b, march(b) if march else None)
    return params, float(psnr)


def _jax_metrics(img, gt):
    from xrnerf_tpu.utils.metrics import mse2psnr, ssim

    return (float(mse2psnr(jnp.asarray(float(np.mean((img - gt) ** 2))))),
            float(ssim(jnp.asarray(img), jnp.asarray(gt))))


def _close_metrics(got, want):
    assert abs(got[0] - want[0]) < PSNR_DB, (got, want)
    assert abs(got[1] - want[1]) < SSIM_TOL, (got, want)


# --- synth24: one span of 16 steps and the refresh after it, both layouts ----------


@pytest.fixture(scope="module")
def scene24(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth24") / "scene"
    return make_synthetic_blender(str(out), n_train=24, n_val=2, n_test=2, H=32, W=32)


def _grid_draws(key, jgrid, n_uniform, n_biased):
    """The random numbers JAX's ``generate_grid_samples`` draws from ``key``."""
    k1, k2, k3, _ = jax.random.split(key, 4)
    cells = int(np.asarray(jgrid.density).size)
    total = int((np.asarray(jgrid.density) > 0.0).sum())

    def t(x):
        return torch.from_numpy(np.array(x))

    return GridDraws(uni_cells=t(jax.random.randint(k1, (n_uniform,), 0, cells)).long(),
                     rank=t(jax.random.randint(k2, (n_biased,), 1, max(total, 1) + 1)).long(),
                     fallback_cells=t(jax.random.randint(k2, (n_biased,), 0, cells)).long(),
                     jitter=t(jax.random.uniform(k3, (n_uniform + n_biased, 3))))


@pytest.fixture
def ngp_march(monkeypatch):
    """``march(jnet, grid)``: a function that marches a batch op by op for
    the JAX network's jitted steps and renders, which read it in place of
    their own march. Inside a jitted step XLA contracts ``o + d t`` into an
    FMA, which moves the first candidate (on the cube's face) across the face
    on about one ray in 256 and shifts that ray's kept samples by a step; the
    port's march computes the op-by-op form (``tests/test_torch_ngp.py``
    holds it to that), so both sides march alike and the rest of the step is
    compiled, as in the JAX tool."""
    import xrnerf_tpu.models.networks.hashnerf as jhn
    from xrnerf_tpu.models.samplers.ngp_march import march_rays

    monkeypatch.setitem(_MARCH, "m", None)  # jnet.init marches itself
    monkeypatch.setattr(jhn, "march_rays", lambda *a, **k: march_rays(*a, **k) if _MARCH["m"] is None else _MARCH["m"])

    def march(jnet, grid):
        kw = dict(n_candidates=jnet.n_candidates, n_keep=jnet.n_keep, cone_angle=jnet.cone_angle, res=jnet.grid_res)
        return lambda b: march_rays(None, b["rays_o"], b["rays_d"], grid, **kw)

    return march


@pytest.mark.parametrize("layout", ["vertex", "brick"])
def test_synth24_span_and_refresh_match_jax(scene24, ngp_march, layout):
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
    np.testing.assert_array_equal(net.grid_density.numpy(), np.asarray(jgrid.density))

    # the JAX tool: a span of 16 steps, then update_aux(step 16 d)
    tx = optax.adam(1e-2, b2=0.99, eps=1e-15)
    params, jpsnr = _jax_steps(jnet, params, tx, [jds.train_batch(i) for i in range(tool.SPAN)],
                               ngp_march(jnet, jgrid), aux=jgrid)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 2**30)
    half = jnet.grid_update_samples // 2
    draws = _grid_draws(key, jgrid, half, jnet.grid_update_samples - half)
    jgrid = jax.jit(jnet.update_aux)(params, jgrid, jnp.asarray(0), key)  # as the JAX tool runs it

    psnr, psnrs, _ = tool.train(net, ds, tool.SPAN, "cpu", step_gen=lambda i: None, refresh_draws=lambda d: draws,
                                log_every=0)
    assert len(psnrs) == tool.SPAN and psnrs[-1] > psnrs[0]  # it learns
    assert abs(psnr - jpsnr) < PSNR_DB, (psnr, jpsnr)
    _same_params(net, params)
    # the refreshed grid
    bits, jbits = net.grid_bitfield.numpy(), np.asarray(jgrid.bitfield)
    assert 0 < jbits.sum() < jbits.size and (bits != jbits).mean() < 1e-3
    np.testing.assert_allclose(net.grid_density.numpy(), np.asarray(jgrid.density), rtol=1e-2, atol=1e-5)

    # held-out: the 2 val views in padded chunks (768 rays: the last chunk of each view is padded)
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
        jimg = np.concatenate([np.asarray(render_chunk(params, c, march(c))) for c in chunks])[:n]
        want.append(_jax_metrics(jimg.reshape(gt.shape), gt))
    vp, vs = tool.evaluate(net, ds, "cpu", chunk)
    for got, w in zip(zip(vp, vs), want):
        _close_metrics(got, w)


# --- NeuralBody: a few steps on the 3 training cameras, the held-out camera --------------


@pytest.fixture(scope="module")
def zju():
    return make_synthetic_zju(n_frames=4, n_cams=4, H=32, W=32, n_verts=6890)


def test_neuralbody_steps_and_heldout_match_jax(zju):
    from xrnerf_tpu.datasets.neuralbody import NeuralBodyDataset as JDS
    from xrnerf_tpu.models.networks.neuralbody import NeuralBodyNetwork as JNet

    from xrnerf_torch.datasets.neuralbody import NeuralBodyDataset
    from xrnerf_torch.models.networks.neuralbody import NeuralBodyNetwork

    tool = _tool("neuralbody")
    steps, lr = 4, 5e-4
    jds = JDS(arrays=zju, N_rand=128, training_view=(0, 1, 2))
    ds = NeuralBodyDataset(arrays=zju, N_rand=128, training_view=(0, 1, 2))
    jnet = JNet(**NB_KW)
    params = _init(jnet, jds.train_batch(0))
    net = NeuralBodyNetwork(**NB_KW)
    params = _load(net, params)  # flax's init, no density bias: as the tools start

    params, jpsnr = _jax_steps(jnet, params, optax.adam(lr), [jds.train_batch(i) for i in range(steps)])
    psnr, psnrs, acc_max, _ = tool.train(net, ds, steps, lr, "cpu", step_gen=lambda i: None, log_every=0)
    assert len(psnrs) == steps and acc_max > 0  # the init renders something
    assert abs(psnr - jpsnr) < PSNR_DB, (psnr, jpsnr)
    _same_params(net, params)

    # the held-out camera of every frame, context keys whole in each chunk (200 rays: padded)
    chunk, keys = 200, ("rays_o", "rays_d", "near", "far")

    @jax.jit
    def render_chunk(p, b):
        return jnet.apply({"params": p}, b, rng=None, train=False)["rgb"]

    want = []
    assert [c for _, c in ds.test_pairs] == [3] * 4
    for i in range(len(jds.test_pairs)):
        rays, gt = jds.eval_item(i)
        n = rays["rays_o"].shape[0]
        pad = (-n) % chunk
        ctx = {k: jnp.asarray(v) for k, v in rays.items() if k not in keys}
        per_ray = {k: np.concatenate([rays[k], np.repeat(rays[k][-1:], pad, 0)]) for k in keys}
        jimg = np.concatenate([np.asarray(render_chunk(params, dict(ctx, **_jb({k: v[s:s + chunk]
                                                                                 for k, v in per_ray.items()}))))
                               for s in range(0, n + pad, chunk)])[:n]
        want.append(_jax_metrics(jimg.reshape(gt.shape), gt))
    vp, vs = tool.evaluate(net, ds, "cpu", chunk)
    assert len(vp) == len(want) == 4
    for got, w in zip(zip(vp, vs), want):
        _close_metrics(got, w)


# --- GNR: a few steps on cameras 4-6, camera 7 held out, the mesh -------------------------


def test_gnr_steps_heldout_and_mesh_match_jax():
    from xrnerf_tpu.datasets.genebody import GeneBodyDataset as JDS
    from xrnerf_tpu.models.networks.gnr import GnrNetwork as JNet
    from xrnerf_tpu.models.renders.gnr_render import reconstruct_gnr as jreconstruct

    from xrnerf_torch.datasets.genebody import GeneBodyDataset
    from xrnerf_torch.models.networks.gnr import GnrNetwork

    tool = _tool("gnr")
    steps, lr, size = 3, 1e-4, GNR_KW["load_size"]
    arrays = make_synthetic_genebody(n_frames=1, n_cams=8, H=size, W=size)
    kw = dict(arrays=arrays, num_views=4, input_views=(0, 1, 2, 3), N_rand=64)
    jds, ds = JDS(**kw), GeneBodyDataset(**kw)
    for d in (jds, ds):
        d.query_views = [4, 5, 6]
    assert jds.test_pairs == ds.test_pairs and (0, tool.HELD_OUT) in ds.test_pairs
    jnet = JNet(**GNR_KW)
    params = _init(jnet, jds.train_batch(0))
    net = GnrNetwork(**GNR_KW)
    params = _load(net, params)

    params, _ = _jax_steps(jnet, params, optax.adam(lr), [jds.train_batch(i) for i in range(steps)])
    losses, psnrs, _ = tool.train(net, ds, steps, lr, "cpu", step_gen=lambda i: None, log_every=0)
    assert len(losses) == len(psnrs) == steps and all(np.isfinite(losses + psnrs))
    # nerf.value2.bias: the attention's softmax cancels a shift common to every candidate
    _same_params(net, params, null=("nerf.value2.bias",))

    # camera 7 in padded chunks (600 rays), the context whole
    chunk = 600
    rays, gt = jds.eval_item(jds.test_pairs.index((0, tool.HELD_OUT)))
    ctx = {k: jnp.asarray(v) for k, v in rays.items() if k.startswith("ctx_")}

    @jax.jit
    def render_chunk(p, rs, re):
        return jnet.apply({"params": p}, dict(ctx, rays_s=rs, rays_e=re), rng=None, train=False)["rgb"]

    n = rays["rays_s"].shape[0]
    pad = (-n) % chunk
    rs = np.concatenate([rays["rays_s"], np.zeros((pad, 3), np.float32)])
    re = np.concatenate([rays["rays_e"], np.ones((pad, 3), np.float32)])
    jimg = np.concatenate([np.asarray(render_chunk(params, jnp.asarray(rs[s:s + chunk]), jnp.asarray(re[s:s + chunk])))
                           for s in range(0, n + pad, chunk)])[:n]
    _close_metrics(tool.evaluate(net, ds, "cpu", chunk), _jax_metrics(jimg.reshape(gt.shape), gt))

    # the mesh through the queries on step 0's context, n_grid 16. The sweep's box (load_size / 2 over the
    # spatial frequency: +-0.025 here) lies inside the body, so the density bias is moved on both sides alike until
    # the median logit over the sweep's points is 0, and the surface is the field's level set through the box
    b0 = _jb(jds.train_batch(0))
    density = jax.jit(lambda p, x: jnet.apply({"params": p}, b0, x, method=jnet.query_density))
    lin = np.linspace(-size / 2, size / 2, 16, dtype=np.float32)
    pts = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3) / float(b0["ctx_spatial_freq"])
    occ = np.asarray(density(params, jnp.asarray(pts + np.asarray(b0["ctx_center"]))), np.float64)
    shift = np.float32(np.median(np.log(occ / (1 - occ))))
    params["nerf"]["alpha_out"]["bias"] = params["nerf"]["alpha_out"]["bias"] - shift
    with torch.no_grad():
        net.nerf.alpha_out.bias.sub_(float(shift))
    assert np.array_equal(net.nerf.alpha_out.bias.detach().numpy(), params["nerf"]["alpha_out"]["bias"])
    verts, faces, _ = jreconstruct(
        lambda x: density(params, x),
        jax.jit(lambda p, nrm: jnet.apply({"params": params}, b0, p, nrm, method=jnet.query_color)),
        center=np.asarray(b0["ctx_center"]), spatial_freq=float(b0["ctx_spatial_freq"]), load_size=size, n_grid=16,
        chunk=65536, laplacian=2)
    got = tool.mesh_error(net, ds, arrays, "cpu", n_grid=16)
    r = np.linalg.norm(verts - arrays["smpl_verts"][0].mean(0), axis=-1)
    assert len(faces) and got["n_faces"] == len(faces) and abs(got["n_verts"] - len(verts)) <= MESH_VERTS * len(verts)
    assert abs(got["radius_mae_vs_0.3"] - float(np.abs(r - tool.RADIUS).mean())) < MESH_MAE


# --- the tools' main: without JAX, on the CPU; none without a card -----------------------


def _hide_jax(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in HIDDEN:
            monkeypatch.setitem(sys.modules, name, None)
    for name in HIDDEN:
        monkeypatch.setitem(sys.modules, name, None)


def _tiny(monkeypatch, name):
    """The tool with its network cut to a small width, and the argv of a
    run of a few steps at a tiny size."""
    tool = _tool(name)
    if name == "synth24":
        monkeypatch.setattr(tool, "NETWORK", {k: v for k, v in NGP_KW.items()})
        monkeypatch.setattr(tool, "EVAL_CHUNK", 256)
        return tool, ["--hw", "16", "--iters", "16", "--batch", "64"]
    if name == "neuralbody":
        monkeypatch.setattr(tool, "NETWORK", {k: v for k, v in NB_KW.items() if k != "n_verts"})
        return tool, ["--size", "16", "--iters", "2", "--n_rand", "64", "--chunk", "100"]
    monkeypatch.setattr(tool, "NETWORK", {k: v for k, v in GNR_KW.items() if k != "load_size"})
    monkeypatch.setattr(tool, "MESH", dict(tool.MESH, n_grid=12))
    return tool, ["--size", "32", "--iters", "2", "--n_rand", "32", "--chunk", "512"]


JSON_KEYS = {
    "synth24": ["iters", "layout", "train_psnr", "train_seconds", "val_psnr", "val_ssim"],
    "neuralbody": ["heldout_cam_psnr", "heldout_cam_ssim", "iters", "n_eval_imgs", "train_psnr", "train_seconds"],
    "gnr": ["held_out_view", "iters", "mesh", "train_seconds", "val_psnr", "val_ssim"],
}


@pytest.mark.parametrize("name", TOOLS)
def test_tool_imports_without_jax(monkeypatch, name):
    _hide_jax(monkeypatch)
    with pytest.raises(ImportError):
        import jax  # noqa: F401
    tool = _tool(name)
    assert callable(tool.main) and callable(tool.train) and callable(tool.evaluate)


@pytest.mark.parametrize("name", TOOLS)
def test_main_runs_end_to_end_on_the_cpu_without_jax(monkeypatch, capsys, name):
    tool, argv = _tiny(monkeypatch, name)
    _hide_jax(monkeypatch)
    out = tool.main(argv + ["--device", "cpu"])
    printed = capsys.readouterr().out
    results = out if name == "synth24" else [out]
    assert len(results) == (2 if name == "synth24" else 1)
    extra = {"step0_acc_max"} if name == "neuralbody" else set()  # the one key the JAX tool lacks
    for r in results:
        assert set(r) == set(JSON_KEYS[name]) | extra and all(np.isfinite(v) for v in r.values() if isinstance(v, float))
    # the JSON comes last: synth24's list (after a line per layout), the others' object
    assert json.loads(printed[printed.rindex("\n[" if name == "synth24" else "\n{") + 1:]) == out
    if name == "synth24":
        assert [r["layout"] for r in results] == ["vertex", "brick"]
    if name == "neuralbody":
        assert out["n_eval_imgs"] == 4 and out["step0_acc_max"] >= 0
    if name == "gnr":
        assert out["held_out_view"] == 7


@pytest.mark.parametrize("name", TOOLS)
def test_main_refuses_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _tool(name).main(["--device", "cuda"])
