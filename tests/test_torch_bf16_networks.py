"""The port's networks in bf16 end to end against the JAX package's, on
each network's deterministic path with the same numpy batch and the same
parameters (``utils/weights.py:state_dict_from_jax``): each output at
cosine > 0.97, the loss gradients per leaf at cosine > 0.99 and norm ratio
0.93-1.07 (``tests/test_fused_nerf_mlp.py:45-131``). The cases and helpers
are in ``tests/test_torch_bf16.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_bf16 import (  # noqa: E402
    GRAD_COS, NET_COS, NETWORKS, RATIO, RTOL, TORCH_OF, _bridged_pair, _cos, _np, _t,
)
from xrnerf_torch.utils.weights import state_dict_from_jax  # noqa: E402


@pytest.fixture(scope="module", params=NETWORKS)
def pair(request):
    return _bridged_pair(request.param)


def test_network_bf16_outputs_match_jax(pair):
    jnet, params, net, b, jextra, _ = pair
    want = jax.jit(lambda p, bb: jnet.apply({"params": p}, bb, rng=None, train=False, **jextra))(params, b)
    got = net({k: _t(v) for k, v in b.items()}, train=False)
    keys = [k for k in want if np.asarray(want[k]).dtype.kind == "f" and np.asarray(want[k]).size > 1]
    assert keys and set(keys) <= set(got)
    for k in keys:
        assert got[k].dtype == TORCH_OF[jnp.dtype(want[k].dtype)] == torch.float32, k
        assert _cos(_np(got[k]), want[k]) > NET_COS, f"{k}: cos {_cos(_np(got[k]), want[k])}"


def test_network_bf16_gradients_match_jax(pair):
    """Loss gradients per leaf on the deterministic path (JAX ``rng=None``,
    the port ``generator=None``); GNR's JAX path is ``train=False``, as its
    f32 test holds it. A leaf that is zero in JAX is zero here."""
    jnet, params, net, b, jextra, rounding = pair
    jtrain = type(net).__name__ != "GnrNetwork"
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def jloss(p):
        return jnet.loss(jnet.apply({"params": p}, jb, rng=None, train=jtrain, **jextra), jb)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    net.zero_grad(set_to_none=True)
    tb = {k: _t(v) for k, v in b.items()}
    loss = net.loss(net(tb, generator=None, train=True), tb)[0]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    got = {k: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
           for k, p in net.named_parameters()}
    assert set(got) == set(want)
    f32_grads = []
    for k in sorted(want):
        w, g = want[k], got[k]
        assert g.dtype == np.float32, k
        if k in rounding or not np.any(w):
            if not np.any(w):
                assert not np.any(g), f"{k}: zero in JAX, max {np.abs(g).max()} here"
            continue
        ratio = float(np.linalg.norm(g) / np.linalg.norm(w))
        if _cos(g, w) > GRAD_COS and RATIO[0] < ratio < RATIO[1]:
            continue
        # A one-element leaf (a head's bias: one sum over every sample) can miss the ratio by rounding alone:
        # its summands cancel, so a bf16 ulp in each moves the sum by several per cent, in JAX's bf16 gradient
        # as in the port's. There the port is held to the f32 gradient, within the bar widened by JAX's own
        # bf16 distance from it.
        assert w.size == 1 and np.sign(g) == np.sign(w), f"{k}: cos {_cos(g, w)}, ratio {ratio}"
        if not f32_grads:
            jl32 = jax.jit(jax.grad(lambda p: jnet.clone(dtype=jnp.float32).loss(jnet.clone(dtype=jnp.float32).apply(
                {"params": p}, jb, rng=None, train=jtrain, **jextra), jb)[0]))
            f32_grads.append(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jl32(params))))
        f = f32_grads[0][k]
        jax_off, port_off = abs(w.item() / f.item() - 1), abs(g.item() / f.item() - 1)
        assert port_off < RATIO[1] - 1 + jax_off, f"{k}: {port_off:.3f} off f32, JAX bf16 {jax_off:.3f}"


def test_gnr_full_width_bf16_gradients_match_jax():
    """GNR at its config's widths (``configs/gnr/gnr_genebody.py``: the
    4-stack hourglass encoder at 256 channels, the 8 x 256 trunk with skips
    2 / 4 / 6), cut to 128 x 128 sources, 128 samples per ray and 64 rays,
    at flax's init: the loss gradients per leaf at cosine > 0.99 and norm
    ratio 0.93-1.07 against JAX's, no leaf excepted but ``value2.bias``
    (zero in exact arithmetic: the softmax cancels it)."""
    from xrnerf_tpu.datasets.genebody import GeneBodyDataset as JDS
    from xrnerf_tpu.models.networks.gnr import GnrNetwork as J
    from xrnerf_torch import build_network, load_config
    from xrnerf_torch.datasets.load.synthetic import make_synthetic_genebody

    cfg = load_config("configs/gnr/gnr_genebody.py", dataname="synthetic")["model"]
    kw = {k: v for k, v in cfg.items() if k != "type"}
    kw.update(load_size=128, n_samples=128, mesh_chunk=128)
    assert (kw["num_stack"], kw["hourglass_dim"], kw["mlp_depth"], kw["mlp_width"], tuple(kw["skips"])) == \
        (4, 256, 8, 256, (2, 4, 6))
    b = JDS(arrays=make_synthetic_genebody(n_frames=2, n_cams=6, H=128, W=128), N_rand=64, num_views=4,
            input_views=(0, 1, 2, 3)).train_batch(1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    params = jax.tree_util.tree_map(np.asarray, J(**kw).init(jax.random.PRNGKey(0), jb, rng=None,
                                                             train=False)["params"])
    jnet = J(**kw, dtype=jnp.bfloat16)
    jg = jax.jit(jax.grad(lambda p: jnet.loss(jnet.apply({"params": p}, jb, rng=None, train=False), jb)[0]))(params)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    net = build_network(dict(type="GnrNetwork", **kw, dtype="bfloat16"), device="cpu")
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(params).items()})
    tb = {k: _t(v) for k, v in b.items()}
    net.loss(net(tb, generator=None, train=True), tb)[0].backward()
    got = {k: p.grad.numpy() for k, p in net.named_parameters() if p.grad is not None}
    assert set(got) == {k for k in want if k.startswith("nerf.")}  # the encoder is frozen (train_encoder=False)
    scale = max(np.abs(w).max() for w in want.values())
    for k in sorted(got):
        g, w = got[k], want[k]
        if k == "nerf.value2.bias":
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-2 * scale, k
            continue
        ratio = float(np.linalg.norm(g) / np.linalg.norm(w))
        assert _cos(g, w) > GRAD_COS and RATIO[0] < ratio < RATIO[1], f"{k}: cos {_cos(g, w)}, ratio {ratio}"
