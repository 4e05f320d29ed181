"""The serving slice of the PyTorch port end to end, against the JAX package:
NerfNetwork eval, the chunked renderer and the ``--test_only`` CLI, with
the same (bridged) weights and the same rays."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import xrnerf_torch.models.networks.nerf as tnerf  # noqa: E402
import xrnerf_tpu.models.networks.nerf as jnerf  # noqa: E402
from xrnerf_tpu.core.renderer import render_image as jrender_image  # noqa: E402
from xrnerf_tpu.models.networks.nerf import NerfNetwork as JNerfNetwork  # noqa: E402
from xrnerf_torch import build_dataset, build_network  # noqa: E402
from xrnerf_torch.core.renderer import render_image  # noqa: E402
from xrnerf_torch.models.samplers.pdf import sample_pdf as real_sample_pdf  # noqa: E402
from xrnerf_torch.utils.weights import state_dict_from_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET_KW = dict(n_samples=16, n_importance=16, netdepth=8, netwidth=64)


def _batch(n, seed=0):
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {
        "rays_o": (0.3 * rng.randn(n, 3)).astype(np.float32),
        "rays_d": d,
        "near": np.full((n, 1), 2.0, np.float32),
        "far": np.full((n, 1), 6.0, np.float32),
    }


def _eval(jnet):
    return jax.jit(lambda p, b: jnet.apply({"params": p}, b, rng=None, train=False))


@pytest.fixture(scope="module")
def unfused():
    return _pair(False, seed=0)


def _pair(fused, seed=0, **kw):
    """(flax module, its params, the port's network holding the same weights)."""
    cfg = dict(NET_KW, fused=fused, **kw)
    jnet = JNerfNetwork(**cfg)
    init = jax.jit(lambda key, b: jnet.init(key, b, rng=None, train=False))  # jit: ~3x faster than eager
    params = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed), _batch(8))["params"])
    net = build_network(dict(type="NerfNetwork", **cfg), device="cpu")
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(params).items()})
    return jnet, params, net


def _close_fine(got, want, atol, what):
    """Fine outputs of two independent runs go through sample_pdf, where
    t = (u - cdf_below) / denom divides by bin masses near the 1e-5 floor:
    last-ulp cdf differences (XLA sums in another order) move a sample
    along such a bin. A few rays move by more than the coarse tolerance;
    on average the outputs agree to it. Measured on the CPU (these tests'
    inputs): 0-4.3 % of values exceed ``atol`` (2.2-3.0 % for the unfused
    eval batch, 3.1 % / 4.3 % for the rendered rgb / acc, 0 % fused) and
    the largest error is 14.3x ``atol``. Bounds: at most 5 % of values
    above ``atol``, none above 20x, mean within ``atol``, so a localised
    error cannot hide under the mean. Every ray is held to the coarse
    tolerance when both sides share the samples (``shared_samples``)."""
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert err.max() <= 20 * atol, f"{what}: max abs err {err.max()}"
    assert err.mean() <= atol, f"{what}: mean abs err {err.mean()}"
    share = float((err > atol).mean())
    assert share <= 0.05, f"{what}: {share:.1%} of values above atol {atol}"


@pytest.fixture
def shared_samples(monkeypatch):
    """Record JAX's ``sample_pdf`` outputs call by call (run JAX under
    ``jax.disable_jit()`` so they are concrete) and make the port's network
    draw those, in the same order, instead of its own. Its fine pass then
    runs on exactly JAX's sample positions and is held ray by ray."""
    recorded = []
    real = jnerf.sample_pdf

    def record(*args, **kw):
        z = real(*args, **kw)
        if not isinstance(z, jax.core.Tracer):  # flax init under jit records nothing
            recorded.append(np.array(z))
        return z

    replay = iter(recorded)
    monkeypatch.setattr(jnerf, "sample_pdf", record)
    monkeypatch.setattr(tnerf, "sample_pdf", lambda *args, **kw: torch.from_numpy(next(replay)))
    return recorded


def _with_own_samples(fn):
    """Run the port with its own ``sample_pdf`` inside a ``shared_samples`` test."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnerf, "sample_pdf", real_sample_pdf)
        return fn()


# Coarse outputs: unfused is float32 on both sides; fused runs bf16 operands
# on both sides (Pallas interpret mode vs the plain version) summed in other
# orders, so the fused-MLP tolerance applies.
@pytest.mark.parametrize("fused,atol", [(False, 1e-4), (True, 8e-3)])
def test_network_eval_matches_jax(fused, atol, unfused, shared_samples):
    jnet, params, net = unfused if not fused else _pair(True)
    b = _batch(200, seed=1)
    with jax.disable_jit():
        want = jnet.apply({"params": params}, b, rng=None, train=False)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    got = net(tb, train=False)  # on JAX's samples
    assert len(shared_samples) == 1 and not got["rgb"].requires_grad
    tols = dict(coarse_rgb=atol, coarse_acc=atol, rgb=atol, acc=atol, depth=10 * atol)  # depth: z in [2, 6]
    for k, tol in tols.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=tol, rtol=0, err_msg=k)
    own = _with_own_samples(lambda: net(tb, train=False))
    for k in ("rgb", "acc", "depth"):
        _close_fine(own[k].numpy(), want[k], tols[k], k)


def test_eval_field_and_loss_match_jax(unfused):
    jnet, params, net = unfused
    rng = np.random.RandomState(3)
    pts = rng.randn(50, 3).astype(np.float32)
    dirs = rng.randn(50, 3).astype(np.float32)
    want = jnet.apply({"params": params}, jnp.asarray(pts), jnp.asarray(dirs), method=JNerfNetwork.eval_field)
    with torch.no_grad():
        got = net.eval_field(torch.from_numpy(pts), torch.from_numpy(dirs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)

    b = _batch(64, seed=4)
    b["target"] = rng.rand(64, 3).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jout = _eval(jnet)(params, jb)
    jloss, jlog = jnet.loss(jout, jb)
    out = net({k: torch.from_numpy(v) for k, v in b.items()}, train=False)
    loss, log = net.loss(out, {"target": torch.from_numpy(b["target"])})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(float(log["psnr"]), float(jlog["psnr"]), rtol=1e-4)


def test_train_mode_draws_from_generator():
    _, _, net = _pair(False, seed=5, raw_noise_std=1.0)
    b = {k: torch.from_numpy(v) for k, v in _batch(32, seed=6).items()}
    a = net(b, generator=torch.Generator().manual_seed(0), train=True)["rgb"]
    a2 = net(b, generator=torch.Generator().manual_seed(0), train=True)["rgb"]
    c = net(b, train=False)["rgb"]
    assert torch.equal(a, a2) and not torch.allclose(a, c)


def test_render_image_matches_jax(synthetic_scene, unfused, shared_samples):
    """Chunk 100 does not divide 24*24 = 576 rays: the last chunk is padded
    by repeating the last ray, and the pad is dropped. On JAX's samples,
    chunk by chunk, every pixel agrees at 1e-4."""
    jnet, params, net = unfused
    ds = build_dataset(dict(type="SceneDataset", datadir=synthetic_scene, testskip=1))
    rays, gt = ds.eval_item(int(ds.i_test[0]))
    H, W = gt.shape[:2]

    def apply_fn(p, batch, rng):
        return jnet.apply({"params": p}, batch, rng=None, train=False)

    with jax.disable_jit():
        want = jrender_image(apply_fn, params, rays, H, W, chunk=100)
    got = render_image(net, rays, H, W, chunk=100)
    assert len(shared_samples) == 6
    assert set(got) == {"rgb", "disp", "acc"}
    assert got["rgb"].shape == (H, W, 3) and isinstance(got["rgb"], np.ndarray)
    for k in ("rgb", "acc"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-4, rtol=0, err_msg=k)
    own = _with_own_samples(lambda: render_image(net, rays, H, W, chunk=100))
    for k in ("rgb", "acc"):
        _close_fine(own[k], want[k], 1e-4, k)


def test_cli_test_only_matches_jax_test_hook(synthetic_scene, tmp_path):
    """``python -m xrnerf_torch.run_nerf --test_only --device cpu`` with
    weights converted from the JAX trainer scores the JAX TestHook's PSNR."""
    import run_nerf as jrun_nerf

    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        f"""
eval_chunk = 256
work_dir = r"{tmp_path}/wd_#DATANAME#"
model = dict(type="NerfNetwork", n_samples=8, n_importance=8, netdepth=2,
             netwidth=16, multires=4, multires_dirs=2)
data = dict(type="SceneDataset", datadir=r"{synthetic_scene}", N_rand=32, testskip=1)
"""
    )
    jtr = jrun_nerf.main(
        ["--config", str(cfg), "--dataname", "sphere", "--test_only", "--work_dir", str(tmp_path / "jax")]
    )
    jres = json.load(open(tmp_path / "jax" / "test" / "test_results.json"))
    params = jax.tree_util.tree_map(np.asarray, jtr.state.params)
    pt = tmp_path / "weights.pt"
    torch.save({k: torch.from_numpy(v) for k, v in state_dict_from_jax(params).items()}, pt)

    out = subprocess.run(
        [sys.executable, "-m", "xrnerf_torch.run_nerf", "--config", str(cfg), "--dataname", "sphere",
         "--test_only", "--device", "cpu", "--load_from", str(pt), "--work_dir", str(tmp_path / "torch")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.load(open(tmp_path / "torch" / "test" / "test_results.json"))
    assert abs(res["psnr"]["0"] - jres["psnr"]["0"]) < 0.05
    assert abs(res["ssim"]["0"] - jres["ssim"]["0"]) < 1e-3
    assert os.path.exists(tmp_path / "torch" / "test" / "test_0.png")


def test_cli_render_only_and_elapsed_time(synthetic_scene, tmp_path):
    """``--render_only`` renders the 40-pose orbit and writes it as a video;
    ElapsedTimeHook records ms/frame."""
    from xrnerf_torch import run_nerf
    from xrnerf_torch.core.hooks import ElapsedTimeHook

    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        f"""
eval_chunk = 300
model = dict(type="NerfNetwork", n_samples=4, n_importance=4, netdepth=2,
             netwidth=8, multires=2, multires_dirs=1)
data = dict(type="SceneDataset", datadir=r"{synthetic_scene}", testskip=1)
"""
    )
    tr = run_nerf.main(["--config", str(cfg), "--render_only", "--device", "cpu", "--work_dir", str(tmp_path)])
    assert [p for p in os.listdir(tmp_path) if p.startswith("spiral_0.")]
    ElapsedTimeHook(n_images=2).on_eval(tr, 0)
    assert tr.eval_metrics["ms_per_frame"] > 0
