"""The port's multi-rank training and rendering (``xrnerf_torch.parallel``)
against one process and against the JAX trainer under its mesh.

The workers are real processes over gloo on the CPU, as
``tests/test_distributed.py`` spawns them: this file runs itself as the
worker (``python tests/test_torch_parallel.py <world> <rank> <port> <out>
<n_model>``), imports nothing of JAX there, and checks at its end that JAX
was never imported. Worlds, each started once per test run:

- ``ref``: one process, no mesh: every scenario on the global batch;
- ``dp``: 2 ranks, data axis only;
- ``mp``: 2 x 2 ranks (n_model 2): KiloNeRF and both Instant-NGP layouts
  with their expert stacks / hash tables cut over the model axis, the
  model-axis scatter, a KiloNeRF resume from the ``ref`` world's
  checkpoint, and deterministic one-step runs for the JAX comparison.

The tests read the workers' ``.npz`` files: (a) mesh shapes against the JAX
``make_mesh``, (b) data-parallel steps against one process (losses and logs
at 1e-6 relative, per-leaf gradients), (c) KiloNeRF's capacity mask and
Instant-NGP's budget mask bit for bit, (d) the model axis's gradients and
scatter, (e) the JAX trainer under ``make_mesh(n_model=2)``, (f) sharded
frames bit for bit, (g) checkpoints across world sizes, (h) the CLI under
torchrun's environment.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GLOBAL = 96  # rays of a step's global batch
STEPS = 2
SCENARIOS = ("nerf", "mip", "bungee", "ani", "ngp", "kilo")  # the data-parallel world's
MP_SCENARIOS = ("kilo", "ngp", "ngp_brick")  # the model-parallel world's
KILO_KW = dict(resolution=(4, 4, 4), domain_min=(-0.7,) * 3, domain_max=(0.7,) * 3, hidden=8, n_hidden_layers=1,
               multires=2, multires_dirs=2, n_samples=16, n_keep=8, capacity_factor=1.25, view_dep_reg=1e-3)
NGP_KW = dict(n_levels=4, n_features=2, log2_table_size=10, base_res=4, max_res=32, hidden_dim=64, geo_feat_dim=15,
              n_cascades=1, grid_res=16, n_candidates=64, n_keep=16, grid_update_samples=512, sample_budget=700)


_ANI = []


def _ani_dataset():
    """AniNeRF's dataset on seeded ZJU-MoCap arrays with 3 joints (its batch
    carries ``ctx_*`` keys, which every rank holds whole)."""
    if not _ANI:
        from xrnerf_torch import build_dataset
        from xrnerf_torch.datasets.load.synthetic import make_synthetic_zju

        arr = make_synthetic_zju(n_frames=2, n_cams=3, H=20, W=20, n_verts=100)
        arr["joints"] = np.array([[0.0, 0.0, 0.0], [0.15, 0.0, 0.0], [0.0, 0.15, 0.05]], np.float32)
        arr["parents"] = np.array([-1, 0, 1])
        w = np.exp(-np.linalg.norm(arr["verts"][0][:, None] - arr["joints"][None], axis=-1) / 0.1)
        arr["weights"] = (w / w.sum(-1, keepdims=True)).astype(np.float32)
        arr["poses"] = (0.3 * np.random.RandomState(3).randn(2, 3, 3)).astype(np.float32)
        _ANI.append(build_dataset(dict(type="AniNeRFDataset", arrays=arr, N_rand=N_GLOBAL, training_view=(0, 1))))
    return _ANI[0]


def _rays(step: int, kind: str):
    """The step's global batch for a scenario, from a seed."""
    if kind == "ani":
        return _ani_dataset().train_batch(step)
    rng = np.random.RandomState(1000 + step)
    n = N_GLOBAL
    if kind.startswith("ngp"):
        o = (0.5 + rng.uniform(-1.5, 1.5, (n, 3))).astype(np.float32)
        d = ((0.5 + rng.uniform(-0.4, 0.4, (n, 3))) - o).astype(np.float32)
        return {"rays_o": o, "rays_d": d, "target": rng.uniform(size=(n, 3)).astype(np.float32)}
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near, far = (0.1, 2.0) if kind.startswith("kilo") else (1.0, 4.0)
    b = {"rays_o": (rng.randn(n, 3) * (0.1 if kind.startswith("kilo") else 0.3)).astype(np.float32), "rays_d": d,
         "near": np.full((n, 1), near, np.float32), "far": np.full((n, 1), far, np.float32),
         "target": rng.rand(n, 3).astype(np.float32)}
    if kind in ("mip", "bungee"):
        b["radii"] = rng.uniform(5e-3, 2e-2, (n, 1)).astype(np.float32)
    if kind == "mip":
        b["lossmult"] = (4.0 ** rng.randint(0, 4, (n, 1))).astype(np.float32)
    if kind == "bungee":
        b["scale_code"] = rng.randint(0, 3, (n, 1)).astype(np.float32)
        b["stage"] = np.asarray(1, np.int32)
    return b


class GlobalBatch:
    """A dataset whose step batch is fixed by the seed: a host gets its rows
    of it (``train_batch(step, host_id, num_hosts)``), as the datasets give
    each data rank its part."""

    def __init__(self, kind: str, n_hosts: int = 1):
        self.kind, self.N_rand = kind, N_GLOBAL // n_hosts

    def train_batch(self, step, host_id=0, num_hosts=1):
        from xrnerf_torch.parallel.mesh import shard_batch

        return shard_batch(_rays(step, self.kind), host_id, num_hosts)


def _network(kind: str, occ_path: str = ""):
    from xrnerf_torch import build_network

    cfg = {
        "nerf": dict(type="NerfNetwork", n_samples=8, n_importance=8, netdepth=2, netwidth=32, multires=4,
                     multires_dirs=2, raw_noise_std=1.0),
        "mip": dict(type="MipNerfNetwork", num_levels=2, n_samples=8, netdepth=2, netwidth=32, density_noise=1.0),
        "bungee": dict(type="BungeeNerfNetwork", n_stages=3, n_samples=8, netwidth=32, max_deg_point=6),
        "ani": dict(type="AniNeRFNetwork", n_joints=3, num_frames=4, n_samples=8, hidden=32, smpl_dist_threshold=0.2),
        "kilo": dict(type="KiloNerfNetwork", occupancy_path=occ_path, **KILO_KW),
        "ngp": dict(type="HashNerfNetwork", dtype="float32", **NGP_KW),
        "ngp_brick": dict(type="HashNerfNetwork", dtype="float32", hash_layout="brick", n_lattices=2, **NGP_KW),
    }[kind.replace("_det", "")]
    cfg = dict(cfg)
    if cfg.get("dtype") == "float32":
        import torch

        cfg["dtype"] = torch.float32
    return build_network(cfg, device="cpu")


def _optimizer(kind: str):
    opt = dict(type="adam", lr=1e-3)
    if kind == "mip":
        opt["grad_clip"] = 1e-3  # binds: the clip's global norm is checked too
    if kind.endswith("_det"):
        opt = dict(type="sgd", lr=1.0, momentum=0.0)  # parameters after one step = weights - gradient
    return opt


# --------------------------------------------------------------------------------------
# the worker
# --------------------------------------------------------------------------------------


def _deterministic() -> None:
    """Training without jitter, as the JAX networks train with ``rng=None``:
    the marches and stratified samples see no generator (the step's rows
    still reach the capacity and budget rules)."""
    import xrnerf_torch.models.networks.hashnerf as hashnerf
    import xrnerf_torch.models.networks.kilonerf as kilonerf

    march, strat = hashnerf.march_rays, kilonerf.sample_along_rays
    hashnerf.march_rays = lambda generator, *a, **k: march(None, *a, **k)
    hashnerf.HashNerfNetwork.update_aux = lambda self, generator=None, draws=None: self.grid  # JAX's: no refresh
    kilonerf.sample_along_rays = lambda near, far, n, perturb=False, generator=None: strat(near, far, n)


def _train(kind, world, mesh, out, rec_prefix, work_dir, occ_path, max_iters, resume_from=None, load_from=None,
           ckpt_interval=0, frame=False):
    """Train a scenario; record each step's logs, the first step's gradients
    (this rank's, after the all-reduce), the last parameters and with
    ``frame`` a frame of the initial weights, which every world shares (after
    a step, the summed gradients differ from one process's in the last bit)."""
    from xrnerf_torch.core.hooks import Hook
    from xrnerf_torch.core.trainer import Trainer

    class Recorder(Hook):
        def after_step(self, tr, step, logs):
            for k, v in logs.items():
                out[f"{rec_prefix}/log{step}/{k}"] = np.asarray(float(v))
            if step == tr.start_step + 1:
                for n, p in tr.network.named_parameters():
                    if p.grad is not None:
                        out[f"{rec_prefix}/grad/{n}"] = p.grad.detach().numpy().copy()

    n_hosts = mesh.data_size if mesh is not None else 1
    tr = Trainer(_network(kind, occ_path), GlobalBatch(kind.replace("_det", ""), n_hosts),
                 optimizer=_optimizer(kind), work_dir=work_dir, max_iters=max_iters, ckpt_interval=ckpt_interval,
                 log_interval=1, hooks=[Recorder()], seed=3, device="cpu", mesh=mesh, resume_from=resume_from,
                 load_from=load_from, ema_decay=0.9 if kind in ("ngp", "ngp_brick") else 0.0)
    if frame:
        _frame(tr, out, f"frame/{rec_prefix}")
    tr.run()
    for n, p in tr.network.named_parameters():
        out[f"{rec_prefix}/param/{n}"] = p.detach().numpy().copy()
    out[f"{rec_prefix}/sharded"] = np.asarray(sorted(tr.sharded.items()), dtype=object)
    return tr


def _frame(tr, out, key):
    """A 20 x 24 frame in chunks of 64 rays (8 chunks: uneven over the ranks);
    for KiloNeRF also culled by its strip prepass (strips of 16) with half the
    rays pointed away from the domain."""
    import torch

    from xrnerf_torch.core.renderer import render_rays_chunked
    from xrnerf_torch.models.networks.kilonerf import kilonerf_strip_active

    rays = {k: v for k, v in _rays(99, tr.dataset.kind).items() if k != "target"}
    rays = {k: v if v.ndim == 0 else np.resize(v, (480,) + v.shape[1:]) for k, v in rays.items()}
    net = tr.eval_network
    ret = render_rays_chunked(net, rays, chunk=64, keys=("rgb", "acc"), mesh=tr.mesh)
    for k, v in ret.items():
        out[f"{key}/{k}"] = v
    if tr.dataset.kind == "kilo":
        away = dict(rays, rays_o=rays["rays_o"].copy(), rays_d=rays["rays_d"].copy())
        away["rays_o"][240:] = 2.0
        away["rays_d"][240:] = 3 ** -0.5

        def active(r):
            return kilonerf_strip_active(r["rays_o"], r["rays_d"], r["near"], r["far"], net.occ_dist, net.domain_lo,
                                         net.domain_hi, strip=16)

        ret = render_rays_chunked(net, away, chunk=64, keys=("rgb", "acc"), active_fn=active, mesh=tr.mesh)
        for k, v in ret.items():
            out[f"{key}_culled/{k}"] = v
        out[f"{key}_culled/n_active"] = np.asarray(int(active({k: torch.from_numpy(v) for k, v in away.items()}).sum()))


def _masks(mesh, out):
    """KiloNeRF's capacity mask and Instant-NGP's budget mask of a global
    batch, this rank's rows (one process: all of them)."""
    import torch

    from xrnerf_torch.models.fields.kilonerf_field import moe_dispatch
    from xrnerf_torch.models.networks.hashnerf import HashNerfNetwork

    rows = mesh.rows if mesh is not None else None
    d, D = (rows.rank, rows.size) if rows is not None else (0, 1)
    rng = np.random.RandomState(5)
    n_nets, b = 64, 4096
    idx = np.where(rng.rand(b) < 0.2, -1, rng.randint(0, n_nets, b) % (n_nets // 4 * (1 + rng.randint(0, 4, b))))
    idx = torch.from_numpy(idx.astype(np.int32))
    part = idx.reshape(D, -1)[d]
    cap = max(8, int(1.25 * b / n_nets))
    _, keep, order = moe_dispatch(part, n_nets, cap, rows) if rows is not None else moe_dispatch(part, n_nets, cap)
    kept = torch.zeros_like(keep).index_put((order,), keep)
    out["mask/kilo"] = kept.numpy()
    live = torch.from_numpy(rng.rand(b * 4) < 0.3).reshape(D, -1)[d]
    net = HashNerfNetwork(**dict(NGP_KW, sample_budget=1000))
    sel, slot = net.budget_slots(live, rows)
    out["mask/ngp"] = (live & (slot < sel.shape[0])).numpy()


def _model_scatter(mesh, out):
    """The model axis's scatter (ids shifted into the slice, the slice's level
    row counts) of one set of rows, this rank's slice of the table."""
    import torch

    from xrnerf_torch.ops.scatter_rows import scatter_add_rows_levels, shard_rows

    rng = np.random.RandomState(9)
    L, M, T, W = 4, 3000, 1024, 2
    rows = [64, 512, 1024, 1024]
    idx = torch.from_numpy(rng.randint(0, T, (L, M)).astype(np.int64)) % torch.tensor(rows)[:, None]
    vals = torch.from_numpy(rng.randn(L, M, W).astype(np.float32))
    if mesh is None:
        out["scatter/full"] = scatter_add_rows_levels(idx, vals, rows, T).numpy()
        return
    t = T // mesh.model_size
    off = mesh.model_rank * t
    out["scatter/slice"] = scatter_add_rows_levels(idx - off, vals, shard_rows(rows, off, t), t).numpy()


def worker(world: str, rank: int, port: int, out_dir: str, n_model: int) -> None:
    import torch

    torch.set_num_threads(1)
    from xrnerf_torch.parallel import mesh as pm

    size = {"ref": 1, "dp": 2, "mp": 4}[world]
    mesh = None
    if size > 1:
        assert pm.init_distributed(f"tcp://127.0.0.1:{port}", backend="gloo", world_size=size, rank=rank)
        mesh = pm.make_mesh(n_model=n_model)
        assert mesh.shape == {"data": size // n_model, "model": n_model}, mesh.shape
    out = {}
    wd = os.path.join(out_dir, f"{world}_work")
    occ = os.path.join(out_dir, "occupancy.npy")
    if world in ("ref", "dp"):
        for kind in SCENARIOS + (("ngp_brick",) if world == "ref" else ()):
            # the one-process run trains a step more, with a checkpoint at each, for the resumes
            steps = STEPS + 1 if world == "ref" else STEPS
            _train(kind, world, mesh, out, kind, os.path.join(wd, kind), occ, steps, ckpt_interval=1,
                   frame=kind in ("nerf", "kilo"))
        _masks(mesh, out)
    if world in ("ref", "mp"):
        _model_scatter(mesh, out)
    if world == "mp":
        for kind in MP_SCENARIOS:
            _train(kind, world, mesh, out, kind, os.path.join(wd, kind), occ, STEPS, ckpt_interval=STEPS,
                   frame=kind == "kilo")
        # a one-process checkpoint resumed with the expert stacks cut in two, and saved whole again
        _train("kilo", world, mesh, out, "kilo_resumed", os.path.join(wd, "kilo_resumed"), occ, STEPS + 1,
               resume_from=os.path.join(out_dir, "ref_work", "kilo", f"ckpt_{STEPS}.pt"), ckpt_interval=STEPS + 1)
        _deterministic()
        for kind in ("kilo_det", "ngp_det"):
            _train(kind, world, mesh, out, kind, os.path.join(wd, kind), occ, 1,
                   load_from=os.path.join(out_dir, f"{kind}.pt"))
    assert "jax" not in sys.modules and not any(m.startswith("xrnerf_tpu") for m in sys.modules)
    np.savez(os.path.join(out_dir, f"{world}_{rank}.npz"), **out)
    if size > 1:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    w, r, p, o, m = sys.argv[1:6]
    worker(w, int(r), int(p), o, int(m))
    sys.exit(0)


# --------------------------------------------------------------------------------------
# the tests (the JAX package is imported inside them only)
# --------------------------------------------------------------------------------------

import pytest  # noqa: E402

torch = pytest.importorskip("torch")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(world: str, out_dir: str, n_model: int = 1, timeout: int = 150):
    """Start a world's ranks; returns the processes (``_join`` waits)."""
    size = {"ref": 1, "dp": 2, "mp": 4}[world]
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    return [_popen([sys.executable, os.path.abspath(__file__), world, str(r), str(port), out_dir, str(n_model)], env,
                   os.path.join(out_dir, f"{world}_{r}.log")) for r in range(size)]


def _popen(cmd, env, log):
    """A process whose output goes to ``log`` (a full pipe would stall a rank
    inside a collective)."""
    with open(log, "w") as fh:
        p = subprocess.Popen(cmd, env=env, stdout=fh, stderr=subprocess.STDOUT)
    p.log = log
    return p


def _join(procs, timeout: int = 150):
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p in procs:
        assert p.returncode == 0, f"worker failed rc={p.returncode}\n{open(p.log).read()[-4000:]}"


def _jax_inputs(out_dir: str):
    """The occupancy grid and the JAX initial weights of the deterministic
    scenarios, as the port's weight files; returns (JAX nets, params)."""
    import jax

    from xrnerf_torch.utils.weights import grid_state_from_jax, state_dict_from_jax

    occ = np.zeros((8, 8, 8), bool)
    occ[1:7, 1:7, 1:7] = True
    occ[3:5, :, 3:5] = False
    np.save(os.path.join(out_dir, "occupancy.npy"), occ)
    nets, params = _jax_nets(out_dir), {}
    for kind, net in nets.items():
        b = {k: jax.numpy.asarray(v[:8]) for k, v in _rays(0, kind.replace("_det", "")).items()}
        aux = net.init_aux(None, None)
        p = net.init(jax.random.PRNGKey(7), b, rng=None, train=False, aux=aux)["params"]
        params[kind] = jax.tree_util.tree_map(np.asarray, p)
        sd = state_dict_from_jax(params[kind])
        if kind == "ngp_det":  # the fresh grid JAX starts from
            sd.update(grid_state_from_jax(jax.tree_util.tree_map(np.asarray, aux)))
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, os.path.join(out_dir, f"{kind}.pt"))
    return nets, params


def _jax_nets(out_dir: str):
    import jax.numpy as jnp

    from xrnerf_tpu.models.networks.hashnerf import HashNerfNetwork as JHash
    from xrnerf_tpu.models.networks.kilonerf import KiloNerfNetwork as JKilo

    class JKiloDet(JKilo):
        def __call__(self, batch, rng=None, train=False, aux=None):
            return super().__call__(batch, rng=None, train=train, aux=aux)

    class JHashDet(JHash):
        def __call__(self, batch, rng=None, train=False, aux=None):
            return super().__call__(batch, rng=None, train=train, aux=aux)

        def update_aux(self, params, aux, step, rng):  # the port's deterministic run refreshes nothing either
            return aux

    return {"kilo_det": JKiloDet(occupancy_path=os.path.join(out_dir, "occupancy.npy"), **KILO_KW),
            "ngp_det": JHashDet(dtype=jnp.float32, **NGP_KW)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world, each once: ``ref`` and ``dp`` side by side, then ``mp``
    (it resumes a ``ref`` checkpoint). {world: [per-rank dict]}."""
    out = str(tmp_path_factory.mktemp("parallel"))
    nets, params = _jax_inputs(out)
    ref, dp = _spawn("ref", out), _spawn("dp", out)
    _join(ref)
    mp = _spawn("mp", out, n_model=2)
    _join(dp)
    _join(mp)
    load = lambda w, n: [dict(np.load(os.path.join(out, f"{w}_{r}.npz"), allow_pickle=True)) for r in range(n)]  # noqa
    return {"ref": load("ref", 1), "dp": load("dp", 2), "mp": load("mp", 4), "dir": out, "jax": (nets, params)}


def _leaves(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _assert_grads(got, want, what, atol=1e-5):
    """Per leaf: cosine > 0.999, norm ratio in (0.999, 1.001), and each
    element within 1e-4 relative or ``atol`` of the leaf's largest."""
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k, w in want.items():
        a, b = np.asarray(got[k], np.float64).ravel(), np.asarray(w, np.float64).ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if nb == 0:
            assert na == 0, (what, k)
            continue
        cos, ratio = a @ b / (na * nb), na / nb
        assert cos > 0.999 and 0.999 < ratio < 1.001, (what, k, cos, ratio)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol * np.abs(b).max(), err_msg=f"{what} {k}")


def _reassemble(ranks, prefix, dims, n_model=2):
    """The full tensors of model group 0 (ranks 0..n_model-1) from their slices."""
    parts = [_leaves(r, prefix) for r in ranks[:n_model]]
    return {k: np.concatenate([p[k] for p in parts], axis=dims[k]) if k in dims else parts[0][k] for k in parts[0]}


# --- (a) ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_ranks", [8, 4, 3])
@pytest.mark.parametrize("n_model", [1, 2])
def test_mesh_layout_matches_jax_make_mesh(n_ranks, n_model):
    import jax

    from xrnerf_torch.parallel.mesh import mesh_ranks, mesh_shape
    from xrnerf_tpu.parallel.mesh import make_mesh

    devices = jax.devices()[:n_ranks]
    jm = make_mesh(n_model=n_model, devices=devices)
    assert mesh_shape(n_ranks, n_model) == (jm.shape["data"], jm.shape["model"])
    ids = np.vectorize(lambda dev: devices.index(dev))(jm.devices)
    np.testing.assert_array_equal(mesh_ranks(n_ranks, n_model), ids)
    if n_ranks % n_model:
        with pytest.raises(ValueError):
            mesh_shape(n_ranks, n_model, allow_fewer=False)


def test_one_process_mesh_and_collectives_are_the_identity():
    from xrnerf_torch.parallel import mesh as pm

    m = pm.make_mesh(n_model=2)
    assert m.shape == {"data": 1, "model": 1} and m.data_group is None and m.model_group is None
    x = torch.arange(6.0, requires_grad=True)
    y = pm.copy_to(pm.reduce_from(pm.gather_rows(x, None), None), None)
    assert y is x
    g = pm.StepGenerator().manual_seed(4)
    want = torch.rand((5, 3), generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(pm.draw(torch.rand, (5, 3), g), want, rtol=0, atol=0)
    g = pm.StepGenerator().manual_seed(4)
    g.rows = pm.RowShard(1, 2, None)  # rows 5..9 of the 10-row draw one process makes
    want = torch.rand((10, 3), generator=torch.Generator().manual_seed(4))[5:]
    torch.testing.assert_close(pm.draw(torch.rand, (5, 3), g), want, rtol=0, atol=0)


def test_shard_batch_and_pad_to_multiple():
    """A rank's rows of a global batch (context whole), and the padding the
    renderer uses, against the JAX package's ``pad_to_multiple``."""
    from xrnerf_torch.parallel.mesh import pad_to_multiple, shard_batch
    from xrnerf_tpu.parallel.mesh import pad_to_multiple as jpad

    b = {"x": np.arange(30.0).reshape(10, 3), "ctx_v": np.ones((4, 3)), "stage": np.asarray(2)}
    parts = [shard_batch(b, r, 2) for r in range(2)]
    np.testing.assert_array_equal(np.concatenate([p["x"] for p in parts]), b["x"])
    assert all(p["ctx_v"] is b["ctx_v"] and p["stage"] is b["stage"] for p in parts)
    for multiple in (8, 5, 1):
        got, want = pad_to_multiple({"x": b["x"]}, multiple), jpad({"x": b["x"]}, multiple)
        np.testing.assert_array_equal(got["x"], want["x"])


# --- (b) data-parallel steps --------------------------------------------------------


@pytest.mark.timeout(300)
@pytest.mark.parametrize("kind", SCENARIOS)
def test_data_parallel_steps_equal_one_process(runs, kind):
    """Losses and every logged metric (PSNR of the global MSE, NGP's live
    fraction, AniNeRF's blend-weight term over the global batch's body
    points) at 1e-6 relative; the first step's summed gradients per leaf
    (Mip-NeRF's after a clip that binds); the ranks' parameters identical."""
    ref, dp = runs["ref"][0], runs["dp"]
    for step in range(1, STEPS + 1):
        want = _leaves(ref, f"{kind}/log{step}/")
        assert "loss" in want and "psnr" in want
        for r in dp:
            got = _leaves(r, f"{kind}/log{step}/")
            assert sorted(got) == sorted(want)
            for k, w in want.items():
                np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-12, err_msg=f"{kind} step {step} {k}")
    want = _leaves(ref, f"{kind}/grad/")
    for r in dp:  # every rank holds the summed gradient
        _assert_grads(_leaves(r, f"{kind}/grad/"), want, kind)
    p0, p1 = _leaves(dp[0], f"{kind}/param/"), _leaves(dp[1], f"{kind}/param/")
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)


# --- (c) the exact rules' masks -----------------------------------------------------


@pytest.mark.timeout(300)
@pytest.mark.parametrize("which", ["kilo", "ngp"])
def test_capacity_and_budget_masks_are_bit_equal(runs, which):
    """The kept points of KiloNeRF's capacity rule and the kept samples of
    Instant-NGP's budget, from two ranks' halves, are the one-process masks."""
    want = runs["ref"][0][f"mask/{which}"]
    got = np.concatenate([r[f"mask/{which}"] for r in runs["dp"]])
    assert got.shape == want.shape and 0 < want.sum() < want.size
    np.testing.assert_array_equal(got, want)


# --- (d) the model axis ---------------------------------------------------------------


@pytest.mark.timeout(300)
@pytest.mark.parametrize("kind", MP_SCENARIOS)
def test_model_axis_gradients_equal_one_process(runs, kind):
    """2 x 2 ranks: the cut leaves' gradients reassembled from the model
    group's slices, and the replicated ones, against one process; both data
    ranks hold the same sums; the losses agree."""
    mp, ref = runs["mp"], runs["ref"][0]
    dims = dict(mp[0][f"{kind}/sharded"].tolist())
    want_dim = {"kilo": 0, "ngp": 1, "ngp_brick": 2}[kind]
    assert dims and set(dims.values()) == {want_dim}, dims
    got = _reassemble(mp, f"{kind}/grad/", dims)
    other = _reassemble(mp[2:], f"{kind}/grad/", dims)
    for k in got:
        np.testing.assert_array_equal(got[k], other[k], err_msg=k)
    _assert_grads(got, _leaves(ref, f"{kind}/grad/"), kind)
    for step in range(1, STEPS + 1):
        for k, w in _leaves(ref, f"{kind}/log{step}/").items():
            np.testing.assert_allclose(mp[0][f"{kind}/log{step}/{k}"], w, rtol=1e-5, err_msg=f"{kind} {k}")


@pytest.mark.timeout(300)
def test_model_axis_scatter_equals_the_full_scatter(runs):
    """Each model rank's scatter into its slice (ids shifted, the slice's
    level row counts) is its slice of the one-process scatter."""
    want = runs["ref"][0]["scatter/full"]
    got = np.concatenate([r["scatter/slice"] for r in runs["mp"][:2]], axis=1)
    np.testing.assert_array_equal(got, want)


# --- (e) against the JAX trainer under its mesh ---------------------------------------


@pytest.mark.timeout(300)
@pytest.mark.parametrize("kind", ["kilo_det", "ngp_det"])
def test_model_axis_step_matches_jax_trainer_under_its_mesh(runs, kind):
    """The same weights and batch, no jitter, SGD at lr 1: the port's 2 x 2
    step against the JAX ``Trainer`` under ``make_mesh(n_model=2)`` on the 8
    virtual CPU devices: the loss, and the parameters after the step."""
    import jax

    from xrnerf_torch.utils.weights import state_dict_from_jax
    from xrnerf_tpu.core.hooks import Hook
    from xrnerf_tpu.core.trainer import Trainer as JTrainer
    from xrnerf_tpu.parallel.mesh import make_mesh

    nets, params = runs["jax"]
    losses = []

    class Rec(Hook):
        def after_step(self, tr, step, logs):
            losses.append(float(np.asarray(logs["loss"])))

    mesh = make_mesh(n_model=2)
    assert mesh.shape == {"data": 4, "model": 2}
    jtr = JTrainer(nets[kind], GlobalBatch(kind.replace("_det", "")), optimizer=_optimizer(kind),
                   work_dir=os.path.join(runs["dir"], f"jax_{kind}"), max_iters=1, ckpt_interval=0, log_interval=1,
                   hooks=[Rec()], mesh=mesh)
    p0 = params[kind]
    jtr.state = jtr.state.replace(params=jax.tree_util.tree_map(
        lambda new, old: jax.device_put(new, old.sharding), p0, jtr.state.params))
    jtr.run()
    mp = runs["mp"]
    np.testing.assert_allclose(float(mp[0][f"{kind}/log1/loss"]), losses[0], rtol=1e-5)
    dims = dict(mp[0][f"{kind}/sharded"].tolist())
    got = _reassemble(mp, f"{kind}/param/", dims)
    before = state_dict_from_jax(p0)
    after = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtr.state.params))
    # XLA sums in another order: a few elements that are sums of cancelling terms differ by more than 1e-4
    # relative, so the element bar is 1e-3 of the leaf's largest
    _assert_grads({k: before[k] - got[k] for k in got}, {k: before[k] - after[k] for k in after}, kind, atol=1e-3)


# --- (f) sharded frames ------------------------------------------------------------------


@pytest.mark.timeout(300)
@pytest.mark.parametrize("world,kind", [("dp", "nerf"), ("dp", "kilo"), ("mp", "kilo"), ("dp", "kilo_culled"),
                                        ("mp", "kilo_culled")])
def test_sharded_frame_equals_one_process_frame(runs, world, kind):
    """Chunks round-robin over the data ranks (8 chunks over 2), KiloNeRF's
    experts also cut over the model axis, and the cull prepass split by
    chunks: every rank's frame is the one-process frame, bit for bit."""
    ref = runs["ref"][0]
    if kind == "kilo_culled":  # the rays pointed away are culled: background, never rendered
        assert (ref["frame/kilo_culled/acc"][240:] == 0).all() and (ref["frame/kilo_culled/rgb"][240:] == 1).all()
        assert ref["frame/kilo_culled/acc"][:240].max() > 0 and 0 < ref["frame/kilo_culled/n_active"] <= 256
    for r in runs[world]:
        for k in ("rgb", "acc"):
            np.testing.assert_array_equal(r[f"frame/{kind}/{k}"], ref[f"frame/{kind}/{k}"], err_msg=f"{kind} {k}")


# --- (g) checkpoints across world sizes -----------------------------------------------------


@pytest.mark.timeout(300)
def test_two_rank_checkpoint_resumes_in_one_process(runs):
    """Rank 0 of the data-parallel world wrote each step's checkpoint once;
    one process resumes the last and takes the step the one-process run
    took, to the f32 bar."""
    from xrnerf_torch.core.trainer import Trainer
    from xrnerf_torch.utils import checkpoint as ckpt

    wd = os.path.join(runs["dir"], "dp_work", "nerf")
    assert ckpt.all_steps(wd) == [1, 2]
    tr = Trainer(_network("nerf"), GlobalBatch("nerf"), optimizer=_optimizer("nerf"), work_dir=None,
                 max_iters=STEPS + 1, ckpt_interval=0, log_interval=1, seed=3, device="cpu",
                 resume_from=os.path.join(wd, f"ckpt_{STEPS}.pt"))
    assert tr.start_step == STEPS
    tr.run()
    want = torch.load(os.path.join(runs["dir"], "ref_work", "nerf", f"ckpt_{STEPS + 1}.pt"), weights_only=True)
    for k, v in tr.network.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want["model"][k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.timeout(300)
def test_one_process_checkpoint_resumes_on_the_model_axis(runs):
    """2 x 2 ranks resume a one-process KiloNeRF checkpoint (its stacks cut
    in two, Adam's moments with them), take a step, and save full tensors
    again: the one-process run's step-3 checkpoint, to the f32 bar."""
    got = torch.load(os.path.join(runs["dir"], "mp_work", "kilo_resumed", f"ckpt_{STEPS + 1}.pt"), weights_only=True)
    want = torch.load(os.path.join(runs["dir"], "ref_work", "kilo", f"ckpt_{STEPS + 1}.pt"), weights_only=True)
    assert got["step"] == want["step"] == STEPS + 1
    for k, v in want["model"].items():
        assert got["model"][k].shape == v.shape, k
        np.testing.assert_allclose(got["model"][k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            np.testing.assert_allclose(got["optimizer"]["state"][i][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-9)
    dims = dict(runs["mp"][0]["kilo_resumed/sharded"].tolist())
    live = _reassemble(runs["mp"], "kilo_resumed/param/", dims)
    for k, v in live.items():
        np.testing.assert_array_equal(v, got["model"][k].numpy(), err_msg=k)


# --- (h) the CLI under torchrun's environment ------------------------------------------------


@pytest.mark.timeout(200)
def test_cli_trains_on_two_ranks_from_torchrun_environment(synthetic_scene, tmp_path):
    """``xrnerf_torch.run_nerf`` with torchrun's variables (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``) and
    ``--device cpu``: two ranks over gloo train, validate and stop together;
    rank 0 alone writes the log and the checkpoint."""
    from xrnerf_torch.utils import checkpoint as ckpt

    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"""
max_iters = 100
log_interval = 2
ckpt_interval = 100
eval_interval = 4
eval_chunk = 200
model = dict(type="NerfNetwork", n_samples=4, n_importance=4, netdepth=2, netwidth=16, multires=2, multires_dirs=1)
data = dict(type="SceneDataset", datadir=r"{synthetic_scene}", N_rand=32, testskip=1)
optimizer = dict(type="adam", lr=5e-4)
hooks = [dict(type="ValidateHook", save_img=False, max_images=1), dict(type="OccupationHook")]
""")
    wd = tmp_path / "wd"
    code = ("import sys; from xrnerf_torch import run_nerf; tr = run_nerf.main(sys.argv[1:]); "
            "assert tr.mesh.shape == {'data': 2, 'model': 1} and tr.step == 4 and 'psnr' in tr.eval_metrics; "
            "assert 'jax' not in sys.modules; print('STEP', tr.step, tr.eval_metrics['psnr'])")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(_popen([sys.executable, "-c", code, "--config", str(cfg), "--device", "cpu", "--max_iters", "4",
                             "--work_dir", str(wd)], env, str(tmp_path / f"rank{rank}.log")))
    _join(procs, timeout=180)
    assert ckpt.all_steps(str(wd)) == [4]
    log = (wd / "log.txt").read_text()
    assert log.count("iter 4/4") == 1 and "rays/s" in log
