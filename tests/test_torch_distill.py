"""KiloNeRF's distillation phase in the PyTorch port, held against the JAX
package: ``error_metrics``, ``equal_error_split_threshold``,
``nodes_fixed_resolution``, the ``DistillDriver`` (the same examples drawn,
the same initial weights injected, then the node errors, splits, queues,
fitted volume and ``lookup`` against the JAX driver's), its checkpoint and
resume, ``assemble_grid`` into the finetune field, the student fitting an
analytic teacher, and ``tools/torch_kilonerf_pipeline.py`` end to end on a
24x24 scene in both distillation modes.

Tolerances: metrics rtol 1e-5; per-node errors after 150 Adam steps rtol 2e-2
(two f32 optimizers drift apart); splits, queues and leaves equal.
"""

import os
import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import xrnerf_tpu.core.distill as jdistill  # noqa: E402
import xrnerf_torch.core.distill as tdistill  # noqa: E402
from xrnerf_torch.models.fields.kilonerf_field import GroupedMultiMLP  # noqa: E402
from xrnerf_torch.utils.weights import state_dict_from_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("quantile", [0.99, 0.5])
def test_error_metrics_match_jax(quantile):
    rng = np.random.RandomState(0)
    tgt = rng.rand(5, 64, 4).astype(np.float32)
    out = tgt + 0.05 * rng.randn(5, 64, 4).astype(np.float32)
    out[2, :, :3] = 0.0  # saturated at 0
    out[3, :, :3] = 1.0  # saturated at 1
    want = jdistill.error_metrics(out, tgt, quantile)
    got = tdistill.error_metrics(out, tgt, quantile)
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert list(got[2]) == [False, False, True, True, False]


def test_equal_error_split_and_fixed_nodes_match_jax():
    rng = np.random.RandomState(1)
    pts = rng.rand(200, 3).astype(np.float32)
    errors = rng.rand(200) ** 4
    for axis in range(3):
        assert tdistill.equal_error_split_threshold(pts, errors, axis) == jdistill.equal_error_split_threshold(
            pts, errors, axis)
    want = jdistill.nodes_fixed_resolution((2, 3, 1), (-0.7,) * 3, (0.7,) * 3)
    got = tdistill.nodes_fixed_resolution((2, 3, 1), (-0.7,) * 3, (0.7,) * 3)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.domain_min, w.domain_min)
        np.testing.assert_array_equal(g.domain_max, w.domain_max)
    assert sum(tdistill.calculate_volume(n.domain_min, n.domain_max) for n in got) == pytest.approx(1.4**3)


DRIVER_KW = dict(domain_min=(-1, -1, -1), domain_max=(1, 1, 1), fixed_resolution=(2, 2, 2), max_num_networks=8,
                 num_examples_per_network=256, test_examples_per_network=64, iters_per_batch=150, lr=5e-3,
                 max_error=2e-3, test_error_metric="mse", hidden=16, multires=4, multires_dirs=2, seed=3)


def _jteacher(pts, dirs):
    rgb = 0.5 + 0.4 * jnp.sin(3 * pts) * (1 + 0.1 * dirs)
    return rgb, jnp.maximum(2.0 + 3 * jnp.sum(pts * jnp.abs(pts), -1), 0.0)


def _tteacher(pts, dirs):
    rgb = 0.5 + 0.4 * torch.sin(3 * pts) * (1 + 0.1 * dirs)
    return rgb, torch.clamp(2.0 + 3 * torch.sum(pts * torch.abs(pts), -1), min=0.0)


def _inject_jax_init(driver, jdriver):
    """The port's driver starts every batch from the JAX driver's initial
    weights for the same seed (the first ``n_active`` of its networks)."""

    def init_student(n_active, seed):
        shape = (jdriver.N, 4, 3)
        p = jdriver.student.init(jax.random.PRNGKey(seed), jnp.zeros(shape), jnp.zeros(shape))["params"]
        student = GroupedMultiMLP(n_active, **driver.mlp_kw)
        student.load_state_dict({k: torch.from_numpy(np.array(v[:n_active]))
                                 for k, v in state_dict_from_jax(jax.tree_util.tree_map(np.asarray, p)).items()})
        return student

    driver.init_student = init_student


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    """Two cycles of each driver from the same seed, recording each cycle's per-node errors."""
    jwork, twork = (str(tmp_path_factory.mktemp(n)) for n in ("jax_distill", "torch_distill"))
    jdriver = jdistill.DistillDriver(_jteacher, work_dir=jwork, **DRIVER_KW)
    driver = tdistill.DistillDriver(_tteacher, work_dir=twork, device="cpu", **DRIVER_KW)
    _inject_jax_init(driver, jdriver)
    jerrs, terrs = [], []
    real = jdistill.error_metrics

    def record(out, tgt, *a):
        res = real(out, tgt, *a)
        jerrs.append(res[0]["mse"])
        return res

    jdistill.error_metrics = record
    try:
        for _ in range(2):
            jdriver.run_cycle(log=lambda *a: None)
            driver.run_cycle(log=lambda *a: None)
            terrs.append(driver.last_cycle["errors"])
    finally:
        jdistill.error_metrics = real
    return jdriver, driver, jerrs, terrs


def _leaves(node, out):
    if node.leq_child is None:
        out.append(node)
    else:
        _leaves(node.leq_child, out)
        _leaves(node.gt_child, out)
    return out


def test_driver_cycles_match_jax(drivers):
    """Same draws, same initial weights: per-node errors within 2 %, and so the
    same accepted nodes, splits, queues and fitted volume."""
    jdriver, driver, jerrs, terrs = drivers
    assert driver.teacher_rows == 8 * (256 + 64) * 2
    for je, te in zip(jerrs, terrs):
        np.testing.assert_allclose(te, je[: len(te)], rtol=2e-2)
        # the accept/split decision is not near its threshold in this case
        assert np.all(np.abs(np.log(te / DRIVER_KW["max_error"])) > 0.1)
    jcp, cp = jdriver.cp, driver.cp
    assert cp["num_networks_fitted"] == jcp["num_networks_fitted"] > 0
    assert cp["fitted_volume"] == pytest.approx(jcp["fitted_volume"])
    assert len(cp["nodes_to_process"]) == len(jcp["nodes_to_process"]) > 0
    for q in ("nodes_to_process", "saturated_nodes_to_process"):
        for g, w in zip(cp[q], jcp[q]):
            np.testing.assert_array_equal(g.domain_min, w.domain_min)
            np.testing.assert_array_equal(g.domain_max, w.domain_max)
    for groot, wroot in zip(cp["root_nodes"], jcp["root_nodes"]):
        gl, wl = _leaves(groot, []), _leaves(wroot, [])
        assert [(n.split_axis, n.split_threshold) for n in gl] == [(n.split_axis, n.split_threshold) for n in wl]
        assert [n.params is None for n in gl] == [n.params is None for n in wl]
    pts = np.random.RandomState(4).uniform(-1, 1, (200, 3)).astype(np.float32)
    for p in pts:
        g, w = driver.lookup(p), jdriver.lookup(p)
        np.testing.assert_array_equal(g.domain_min, w.domain_min)
        np.testing.assert_array_equal(g.domain_max, w.domain_max)
    assert driver.lookup(np.array([2.0, 0, 0], np.float32)) is None


def test_driver_checkpoint_resume(drivers):
    """A second driver on the same work dir resumes the pickled tree and fits on from its queue."""
    _, driver, _, _ = drivers
    path = os.path.join(driver.work_dir, "distill_checkpoint.pkl")
    with open(path, "rb") as fh:
        cp = pickle.load(fh)
    assert cp["num_networks_fitted"] == driver.cp["num_networks_fitted"]
    assert isinstance(cp["root_nodes"][0], tdistill.Node)
    resumed = tdistill.DistillDriver(_tteacher, work_dir=driver.work_dir, device="cpu",
                                     **{**DRIVER_KW, "iters_per_batch": 20, "max_error": 1e9})
    queued = len(resumed.cp["nodes_to_process"])
    assert queued == len(driver.cp["nodes_to_process"]) > 0
    assert resumed.run_cycle(log=lambda *a: None) == (queued > 8)
    assert resumed.cp["num_networks_fitted"] == cp["num_networks_fitted"] + min(queued, 8)


def test_assemble_grid_seeds_the_finetune_field(drivers):
    """Every cell of a 4^3 grid takes its leaf's weights (zeros where the leaf
    is not fitted); the stack loads into ``KiloNerfNetwork``'s field."""
    from xrnerf_torch.models.networks.kilonerf import KiloNerfNetwork

    _, driver, _, _ = drivers
    grid = driver.assemble_grid((4, 4, 4))
    net = KiloNerfNetwork(resolution=(4, 4, 4), hidden=16, multires=4, multires_dirs=2)
    assert sorted(grid) == sorted(net.mlp.state_dict())
    net.mlp.load_state_dict({k: torch.from_numpy(v) for k, v in grid.items()})
    cell = 2.0 / 4
    for flat, (i, j, k) in enumerate(np.ndindex(4, 4, 4)):
        node = driver.lookup(np.float32(-1 + cell * (np.array([i, j, k]) + 0.5)))
        want = node.params["hidden_0_w"] if node.params else np.zeros_like(grid["hidden_0_w"][0])
        np.testing.assert_array_equal(grid["hidden_0_w"][flat], want)


def test_assemble_grid_before_any_fit_is_zeros():
    """Before any node is fitted both drivers refuse to assemble: the same
    ``RuntimeError("no fitted nodes")``, and neither tree has a fitted leaf."""
    jdriver = jdistill.DistillDriver(_jteacher, **DRIVER_KW)
    driver = tdistill.DistillDriver(_tteacher, device="cpu", **DRIVER_KW)
    errors = []
    for d in (jdriver, driver):
        with pytest.raises(RuntimeError) as err:
            d.assemble_grid((2, 2, 2))
        errors.append(str(err.value))
        assert all(d.lookup(np.float32(c)).params is None for c in ((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5)))
    assert errors == ["no fitted nodes"] * 2


def test_student_fits_an_analytic_teacher():
    """``StudentNerfNetwork`` on ``KiloNerfDistillDataset`` batches: the loss halves in 60 Adam steps."""
    from xrnerf_torch.datasets.kilonerf import KiloNerfDistillDataset
    from xrnerf_torch.models.networks.kilonerf import StudentNerfNetwork

    def teacher(pts, dirs):
        return 0.5 + 0.5 * torch.tanh(pts), 5.0 * torch.exp(-4.0 * torch.sum(pts**2, -1))

    ds = KiloNerfDistillDataset(resolution=(2, 2, 2), points_per_net=32, teacher_fn=teacher, device="cpu")
    net = StudentNerfNetwork(resolution=(2, 2, 2), hidden=16, multires=4, multires_dirs=0, capacity_factor=8.0)
    net.reset_parameters(torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(net.parameters(), lr=5e-3)
    losses = []
    for i in range(60):
        batch = {k: torch.from_numpy(v) for k, v in ds.train_batch(i).items()}
        loss, _ = net.loss(net(batch, train=True), batch)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])


def _pipeline_cfgs(tmp_path, datadir, mode):
    """Tiny copies of the three configs, their work dirs under ``tmp_path``."""
    pre = tmp_path / "pre.py"
    pre.write_text(open(os.path.join(ROOT, "configs", "nerf", "nerf_blender.py")).read() + f"""
model.update(n_samples=8, n_importance=8, netdepth=2, netwidth=32)
data.update(datadir=r"{datadir}", N_rand=64, testskip=2, precrop_iters=0)
hooks = []
max_iters = 4
ckpt_interval = 4
log_interval = 2
work_dir = r"{tmp_path / 'pre'}"
""")
    dis = tmp_path / "dis.py"
    dis.write_text(open(os.path.join(ROOT, "configs", "kilonerf", "kilonerf_distill.py")).read() + f"""
mode = "{mode}"
tree.update(fixed_resolution=(2, 2, 2), max_num_networks=8, num_examples_per_network=64,
            test_examples_per_network=32, iters_per_batch=10, max_error=1e9, hidden=8, multires=2, multires_dirs=2)
model.update(resolution=(4, 4, 4), hidden=8, multires=2, multires_dirs=2)
data.update(resolution=(4, 4, 4))
max_iters = 3
ckpt_interval = 3
log_interval = 1
work_dir = r"{tmp_path / 'dis'}"
""")
    fin = tmp_path / "fin.py"
    fin.write_text(open(os.path.join(ROOT, "configs", "kilonerf", "kilonerf_finetune.py")).read() + f"""
model.update(resolution=(4, 4, 4), hidden=8, multires=2, multires_dirs=2, n_samples=32, eval_budget=2048,
             occupancy_path=r"{tmp_path / 'fin' / 'occupancy.npy'}")
data.update(datadir=r"{datadir}", N_rand=64, testskip=2)
hooks = []
max_iters = 2
ckpt_interval = 2
log_interval = 1
work_dir = r"{tmp_path / 'fin'}"
""")
    return pre, dis, fin


@pytest.mark.parametrize("mode", ["tree", "uniform"])
def test_pipeline_tool_end_to_end(synthetic_scene, tmp_path, monkeypatch, mode):
    """``tools/torch_kilonerf_pipeline.py`` runs pretrain, occupancy, distill
    and finetune on the CPU; the finetune network starts from the distilled
    weights and marches the grid the occupancy phase wrote."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch_kilonerf_pipeline as pipeline

    monkeypatch.setattr(pipeline, "OCC_RES", 8)
    pre, dis, fin = _pipeline_cfgs(tmp_path, synthetic_scene, mode)
    tr = pipeline.main(["--pretrain_cfg", str(pre), "--distill_cfg", str(dis), "--finetune_cfg", str(fin),
                        "--device", "cpu"])
    occ = np.load(tmp_path / "fin" / "occupancy.npy")
    assert occ.shape == (8, 8, 8) and occ.dtype == bool
    np.testing.assert_array_equal(tr.network.occupancy.numpy(), occ)
    assert tr.step == 2 and np.isfinite(tr.last_logs["loss"])
    if mode == "tree":
        grid = np.load(tmp_path / "dis" / "distill_grid.npz")
        assert grid["hidden_0_w"].shape == (64, 15, 8) and np.abs(grid["hidden_0_w"]).sum() > 0
    else:
        assert os.path.exists(tmp_path / "dis" / "ckpt_3.pt")
    assert os.path.exists(tmp_path / "fin" / "ckpt_2.pt")
