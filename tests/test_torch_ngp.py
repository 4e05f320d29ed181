"""The port's Instant-NGP pieces against the JAX package, function by
function, on the same numpy inputs: SH and hash encodings, every function of
the occupancy grid and the march, compositing, the Huber loss, the pose map
and the sample-budget hook. Integer indices and masks must be equal exactly;
floats to 1e-5 unless a test states another bar."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xrnerf_tpu.models.embedders import hashenc as jhash  # noqa: E402
from xrnerf_tpu.models.embedders.sh import sh_encode as jsh  # noqa: E402
from xrnerf_tpu.models.samplers import ngp_march as jmarch  # noqa: E402
from xrnerf_tpu.models.samplers import occupancy as jocc  # noqa: E402

from xrnerf_torch.models.embedders.hashenc import HashEncoding, _level_resolutions, per_level_scale  # noqa: E402
from xrnerf_torch.models.embedders.sh import sh_encode  # noqa: E402
from xrnerf_torch.models.samplers import ngp_march as tmarch  # noqa: E402
from xrnerf_torch.models.samplers import occupancy as tocc  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unit(n, seed):
    d = np.random.RandomState(seed).randn(n, 3).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encode(degree):
    d = _unit(257, degree)
    got = sh_encode(_t(d), degree)
    assert got.shape == (257, degree**2)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsh(jnp.asarray(d), degree)), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        sh_encode(_t(d), 5)


# (L, log2 T, base, max): dense and hashed levels both occur in each
ENC_CFGS = [(4, 10, 4, 32), (16, 10, 8, 2048), (16, 11, 8, 2048), (16, 12, 16, 2048)]


def _enc_pair(cfg, seed=0):
    L, log2t, base, mx = cfg
    rng = np.random.RandomState(seed)
    table = rng.uniform(-1.0, 1.0, (L, 1 << log2t, 2)).astype(np.float32)
    x = rng.uniform(0.0, 1.0, (301, 3)).astype(np.float32)
    x[:4] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 0.25]]  # the cube's faces exactly
    kw = dict(n_levels=L, n_features=2, log2_table_size=log2t, base_res=base, max_res=mx)
    enc = HashEncoding(**kw)
    with torch.no_grad():
        enc.table.copy_(_t(table))
    return jhash.HashEncoding(**kw), enc, table, x


@pytest.mark.parametrize("cfg", ENC_CFGS, ids=lambda c: f"L{c[0]}_T{c[1]}")
def test_hash_encoding_forward_and_indices(cfg):
    jenc, enc, table, x = _enc_pair(cfg)
    res = enc.resolutions
    T = enc.table_size
    dense = [r**3 <= T for r in res]
    assert any(dense) and not all(dense)
    assert res == tuple(int(r) for r in jhash._level_resolutions(cfg[2], jhash.per_level_scale(cfg[3], cfg[2], cfg[0]), cfg[0]))
    assert per_level_scale(cfg[3], cfg[2], cfg[0]) == jhash.per_level_scale(cfg[3], cfg[2], cfg[0])
    np.testing.assert_array_equal(_level_resolutions(cfg[2], 1.5, cfg[0]), jhash._level_resolutions(cfg[2], 1.5, cfg[0]))

    jidx, jt = jhash._vertex_cells(jnp.asarray(x), (res, T, 2))
    idx, t = enc._vertex_cells(_t(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))  # corner indices, exactly
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-7)

    want = np.asarray(jenc.apply({"params": {"table": jnp.asarray(table)}}, jnp.asarray(x)))
    got = enc(_t(x))
    assert got.shape == (x.shape[0], cfg[0] * 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-7)
    # leading dims are kept
    assert torch.equal(enc(_t(x).reshape(7, 43, 3)).reshape(301, -1), got)


def test_hash_encoding_table_gradient():
    jenc, enc, table, x = _enc_pair(ENC_CFGS[0], seed=3)
    c = np.random.RandomState(5).randn(x.shape[0], 8).astype(np.float32)
    want = jax.grad(lambda tb: jnp.sum(jenc.apply({"params": {"table": tb}}, jnp.asarray(x)) * jnp.asarray(c)))(
        jnp.asarray(table)
    )
    (enc(_t(x)) * _t(c)).sum().backward()
    np.testing.assert_allclose(enc.table.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_hash_encoding_init_and_dtype():
    enc = HashEncoding(n_levels=2, log2_table_size=8, base_res=4, max_res=8, dtype=torch.bfloat16)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    tb = enc.table.detach()
    assert tb.shape == (2, 256, 2) and float(tb.abs().max()) <= 1e-4 and float(tb.std()) > 4e-5
    assert enc(torch.rand(5, 3)).dtype == torch.bfloat16
    assert list(enc.state_dict()) == ["table"]


# --- occupancy grid ---------------------------------------------------------

RES, C = 16, 2


def _grid_pair(seed=0):
    rng = np.random.RandomState(seed)
    dens = rng.uniform(0, 0.03, (C, RES**3)).astype(np.float32)
    dens[rng.uniform(size=dens.shape) < 0.2] = -1.0
    dens[rng.uniform(size=dens.shape) < 0.3] = 0.0
    bits = rng.uniform(size=dens.shape) < 0.3
    return (jocc.OccupancyGrid(jnp.asarray(dens), jnp.asarray(bits)),
            tocc.OccupancyGrid(_t(dens), _t(bits)))


def _same_grid(tg, jg, rtol=1e-5):
    np.testing.assert_array_equal(tg.bitfield.numpy(), np.asarray(jg.bitfield))
    np.testing.assert_allclose(tg.density.numpy(), np.asarray(jg.density), rtol=rtol, atol=1e-8)


def test_create_grid_and_cell_maps():
    jg, tg = jocc.create_grid(C, RES), tocc.create_grid(C, RES)
    _same_grid(tg, jg)
    assert tg.n_cascades == C and tg.bitfield.dtype == torch.bool
    rng = np.random.RandomState(0)
    cells = rng.randint(0, RES**3, 500)
    casc = rng.randint(0, C, 500)
    want = np.asarray(jocc.cell_centers(jnp.asarray(cells), jnp.asarray(casc), RES))
    got = tocc.cell_centers(_t(cells), _t(casc), RES)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    pos = rng.uniform(-0.7, 1.7, (500, 3)).astype(np.float32)
    jidx, jinb = jocc.pos_to_cell(jnp.asarray(pos), jnp.asarray(casc), RES)
    idx, inb = tocc.pos_to_cell(_t(pos), _t(casc), RES)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(inb.numpy(), np.asarray(jinb))
    assert 0.1 < inb.float().mean() < 0.9


def test_mark_untrained_cells():
    from xrnerf_torch.datasets.hashnerf import pose_nerf2ngp
    from xrnerf_torch.datasets.rays import spherical_render_poses

    poses = np.stack([pose_nerf2ngp(p) for p in spherical_render_poses(10, phi=-30.0, radius=4.0)[:9]])
    jg = jocc.mark_untrained_cells(jocc.create_grid(C, RES), poses, 40.0, 24, 24, RES)
    tg = tocc.mark_untrained_cells(tocc.create_grid(C, RES), poses, 40.0, 24, 24, RES)  # two passes over the cameras
    _same_grid(tg, jg)
    frac = float((tg.density < 0).float().mean())
    assert 0.05 < frac < 0.95


def test_biased_cells_invert_the_cdf():
    jg, tg = _grid_pair()
    flat = np.asarray(jg.density).reshape(-1)
    total = int((flat > 0.0).sum())
    rank = np.random.RandomState(1).randint(1, total + 1, 400)
    rank[:2] = [1, total]
    cdf = jnp.cumsum((jg.density.reshape(-1) > 0.0).astype(jnp.int32))
    want = np.asarray(jnp.clip(jnp.searchsorted(cdf, jnp.asarray(rank), side="left"), 0, C * RES**3 - 1))
    fallback = np.arange(400)
    got = tocc.biased_cells(tg.density, 0.0, _t(rank), _t(fallback))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (flat[got.numpy()] > 0.0).all()
    # nothing above the threshold: the fallback cells
    got = tocc.biased_cells(tg.density, 1.0, _t(np.ones(400, np.int64)), _t(fallback))
    np.testing.assert_array_equal(got.numpy(), fallback)


def test_generate_grid_samples_with_given_draws():
    """The port's sampler fed the JAX package's own draws (same key splits)
    gives the JAX package's samples."""
    jg, tg = _grid_pair(2)
    n_u, n_b = 300, 200
    key = jax.random.PRNGKey(4)
    jpos, jcasc, jcell = jocc.generate_grid_samples(key, jg, n_u, n_b, 0.0, RES)
    k1, k2, k3, _ = jax.random.split(key, 4)
    total = int((np.asarray(jg.density) > 0.0).sum())
    draws = tocc.GridDraws(
        uni_cells=_t(np.asarray(jax.random.randint(k1, (n_u,), 0, C * RES**3)).astype(np.int64)),
        rank=_t(np.asarray(jax.random.randint(k2, (n_b,), 1, max(total, 1) + 1)).astype(np.int64)),
        fallback_cells=_t(np.asarray(jax.random.randint(k2, (n_b,), 0, C * RES**3)).astype(np.int64)),
        jitter=_t(np.array(jax.random.uniform(k3, (n_u + n_b, 3)))),
    )
    pos, casc, cell = tocc.generate_grid_samples(None, tg, n_u, n_b, 0.0, RES, draws=draws)
    np.testing.assert_array_equal(casc.numpy(), np.asarray(jcasc))
    np.testing.assert_array_equal(cell.numpy(), np.asarray(jcell))
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=1e-6, atol=1e-7)


def test_generate_grid_samples_statistics():
    """The port's own draws: in range, jittered inside their cells, and the
    biased half falls in cells above the threshold."""
    _, tg = _grid_pair(3)
    n_u, n_b = 2000, 2000
    pos, casc, cell = tocc.generate_grid_samples(torch.Generator().manual_seed(0), tg, n_u, n_b, 0.0, RES)
    assert pos.shape == (n_u + n_b, 3) and int(cell.min()) >= 0 and int(cell.max()) < RES**3
    assert set(casc.unique().tolist()) == {0, 1}
    back, inb = tocc.pos_to_cell(pos, casc, RES)
    assert bool(inb.all()) and torch.equal(back, cell)
    dens = tg.density.reshape(-1)[casc * RES**3 + cell]
    assert bool((dens[n_u:] > 0.0).all())
    share = float((dens[:n_u] > 0.0).float().mean())
    assert abs(share - float((tg.density > 0).float().mean())) < 0.05
    # an empty grid falls back to uniform cells
    empty = tocc.OccupancyGrid(torch.zeros_like(tg.density), tg.bitfield)
    _, casc, cell = tocc.generate_grid_samples(torch.Generator().manual_seed(1), empty, 10, 500, 0.0, RES)
    assert len(torch.unique(casc * RES**3 + cell)) > 400


def test_splat_density_and_update_bitfield():
    jg, tg = _grid_pair(4)
    rng = np.random.RandomState(5)
    m = 3000
    casc, cell = rng.randint(0, C, m), rng.randint(0, RES**3, m)
    cell[:50] = cell[50:100]  # repeated targets: the max must win
    casc[:50] = casc[50:100]
    dens = rng.uniform(0, 0.05, m).astype(np.float32)
    js = jocc.splat_density(jg, jnp.asarray(casc), jnp.asarray(cell), jnp.asarray(dens), res=RES)
    ts = tocc.splat_density(tg, _t(casc), _t(cell), _t(dens), res=RES)
    _same_grid(ts, js, rtol=1e-6)
    assert bool((ts.density[tg.density < 0] == -1).all())
    for thr in (0.01, 1e-4):  # above and below the mean density
        _same_grid(tocc.update_bitfield(ts, thr, RES), jocc.update_bitfield(js, thr, RES))
    # a fresh field: every sampled cell is above the mean, every other below
    fresh = tocc.splat_density(tocc.create_grid(1, RES), _t(np.zeros(m, np.int64)), _t(cell), torch.full((m,), 0.0034), res=RES)
    bits = tocc.update_bitfield(fresh, 0.01, RES).bitfield
    assert int(bits.sum()) == len(np.unique(cell))


def test_occupied_at():
    jg, tg = _grid_pair(6)
    rng = np.random.RandomState(7)
    pos = rng.uniform(-0.7, 1.7, (4, 250, 3)).astype(np.float32)
    casc = rng.randint(0, C, (4, 250))
    want = np.asarray(jocc.occupied_at(jg, jnp.asarray(pos), jnp.asarray(casc), RES))
    got = tocc.occupied_at(tg, _t(pos), _t(casc), RES)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.02 < got.float().mean() < 0.5


# --- march ------------------------------------------------------------------


def _rays(n, seed, spread=0.6):
    rng = np.random.RandomState(seed)
    o = (0.5 + rng.uniform(-1.0, 1.0, (n, 3)) * np.array([2.0, 2.0, 2.0])).astype(np.float32)
    target = 0.5 + rng.uniform(-spread, spread, (n, 3))
    d = (target - o).astype(np.float32) * rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
    d[0] = [0.0, 0.0, 1.0]  # axis-aligned: two zero components
    return o, d


def test_aabb_intersect_and_cascade_of():
    o, d = _rays(300, 0)
    for lo, hi in ((0.0, 1.0), (-0.5, 1.5)):
        jn, jf = jmarch.aabb_intersect(jnp.asarray(o), jnp.asarray(d), lo, hi)
        tn, tf = tmarch.aabb_intersect(_t(o), _t(d), lo, hi)
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-6)
    pos = np.random.RandomState(1).uniform(-1.5, 2.5, (1000, 3)).astype(np.float32)
    pos[0] = 0.5
    for c in (1, 3):
        want = np.asarray(jmarch._cascade_of(jnp.asarray(pos), c))
        np.testing.assert_array_equal(tmarch._cascade_of(_t(pos), c).numpy(), want)


def _same_march(tm, jm):
    np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
    for name in ("pts", "dirs", "z_vals", "dt"):
        np.testing.assert_allclose(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)), rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("cone_angle,n_casc", [(0.0, 1), (0.0, 2), (1.0 / 256.0, 2), (0.02, 2)])
def test_march_rays(cone_angle, n_casc):
    rng = np.random.RandomState(2)
    bits = rng.uniform(size=(n_casc, RES**3)) < 0.15
    dens = np.zeros(bits.shape, np.float32)
    jg = jocc.OccupancyGrid(jnp.asarray(dens), jnp.asarray(bits))
    tg = tocc.OccupancyGrid(_t(dens), _t(bits))
    o, d = _rays(200, 3)
    kw = dict(n_candidates=64, n_keep=16, cone_angle=cone_angle, res=RES)
    jm = jmarch.march_rays(None, jnp.asarray(o), jnp.asarray(d), jg, **kw)
    tm = tmarch.march_rays(None, _t(o), _t(d), tg, **kw)
    assert tm.pts.shape == (200, 16, 3) and 0.05 < float(tm.mask.float().mean()) < 0.95
    _same_march(tm, jm)
    # live samples come first on every ray, in z order
    m = tm.mask.numpy()
    assert (m[:, :-1] >= m[:, 1:]).all()
    z = tm.z_vals.numpy()
    assert (np.diff(z, axis=1)[m[:, 1:]] >= 0).all()


def test_march_rays_jitter():
    tg = tocc.create_grid(1, RES)
    o, d = _rays(50, 4)
    kw = dict(n_candidates=32, n_keep=32, res=RES)
    base = tmarch.march_rays(None, _t(o), _t(d), tg, **kw)
    a = tmarch.march_rays(torch.Generator().manual_seed(0), _t(o), _t(d), tg, **kw)
    b = tmarch.march_rays(torch.Generator().manual_seed(0), _t(o), _t(d), tg, **kw)
    assert torch.equal(a.z_vals, b.z_vals) and not torch.equal(a.z_vals, base.z_vals)
    # each candidate moves forward by less than one step
    tn, tf = tmarch.aabb_intersect(_t(o), a.dirs)
    u = (a.z_vals - tn[:, None]) / (tf - tn)[:, None].clamp(min=1e-6) * 31  # step units
    frac = (u - torch.floor(u))[a.mask]
    assert bool((u[a.mask] < 31 * 1.0001).all()) and 0.3 < float(frac.mean()) < 0.7
    c = tmarch.march_rays(torch.Generator().manual_seed(0), _t(o), _t(d), tocc.create_grid(2, RES), cone_angle=0.01, **kw)
    assert bool(torch.isfinite(c.z_vals).all())


@pytest.mark.parametrize("white_bkgd,act", [(True, "exp"), (False, "exp"), (True, "relu")])
def test_composite_masked(white_bkgd, act):
    rng = np.random.RandomState(5)
    n, k = 64, 16
    raw_rgb = rng.randn(n, k, 3).astype(np.float32)
    raw_sigma = (3 * rng.randn(n, k)).astype(np.float32)
    raw_sigma[0] = 40.0  # past the exp clip
    fields = dict(
        pts=np.zeros((n, k, 3), np.float32), dirs=_unit(n, 0),
        z_vals=np.sort(rng.uniform(0, 2, (n, k)).astype(np.float32), axis=1),
        dt=rng.uniform(0.001, 0.1, (n, k)).astype(np.float32), mask=rng.uniform(size=(n, k)) < 0.6,
    )
    jm = jmarch.MarchResult(**{f: jnp.asarray(v) for f, v in fields.items()})
    tm = tmarch.MarchResult(**{f: _t(v) for f, v in fields.items()})
    want = jmarch.composite_masked(jnp.asarray(raw_rgb), jnp.asarray(raw_sigma), jm, white_bkgd, act)
    got = tmarch.composite_masked(_t(raw_rgb), _t(raw_sigma), tm, white_bkgd, act)
    assert sorted(got) == sorted(want) == ["acc", "depth", "rgb", "weights"]
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-5, atol=1e-6, err_msg=name)
    with pytest.raises(ValueError):
        tmarch.composite_masked(_t(raw_rgb), _t(raw_sigma), tm, white_bkgd, "softplus")


def test_huber():
    from xrnerf_tpu.utils.metrics import huber as jhuber
    from xrnerf_torch.utils.metrics import huber

    rng = np.random.RandomState(0)
    a, b = rng.uniform(size=(100, 3)).astype(np.float32), rng.uniform(size=(100, 3)).astype(np.float32)
    for delta in (0.1, 0.5):
        np.testing.assert_allclose(float(huber(_t(a), _t(b), delta)), float(jhuber(jnp.asarray(a), jnp.asarray(b), delta)), rtol=1e-6)


def test_pose_nerf2ngp():
    from xrnerf_tpu.datasets.hashnerf import pose_nerf2ngp as jpose
    from xrnerf_torch.datasets.hashnerf import pose_nerf2ngp
    from xrnerf_torch.datasets.rays import spherical_render_poses

    for p in spherical_render_poses(4, phi=-30.0, radius=4.0):
        np.testing.assert_array_equal(pose_nerf2ngp(p), jpose(p))
        np.testing.assert_array_equal(pose_nerf2ngp(p, 0.5, 0.25), jpose(p, 0.5, 0.25))
    assert pose_nerf2ngp(np.eye(4, dtype=np.float32)).dtype == np.float32


def test_sample_budget_hook_pick():
    from xrnerf_tpu.core.hooks import SampleBudgetHook as JHook
    from xrnerf_torch.core.hooks import SampleBudgetHook

    class _Tr:
        log_interval = 10
        last_logs = {}
        network = type("N", (), {"n_keep": 64})()
        dataset = type("D", (), {"N_rand": 4096})()
        logger = type("L", (), {"info": staticmethod(lambda *a: None)})()

    for frac_seq in ([1.0], [0.28, 0.28], [0.05, 0.9, 0.5], [1e-5]):
        th, jh, ttr, jtr = SampleBudgetHook(), JHook(), _Tr(), _Tr()
        ttr.dataset, jtr.dataset = type("D", (), {"N_rand": 4096})(), type("D", (), {"N_rand": 4096})()
        assert th.pick(64) == jh.pick(64) == 4096
        for i, frac in enumerate(frac_seq, 1):
            ttr.last_logs = jtr.last_logs = {"live_frac": frac}
            th.after_step(ttr, 10 * i, {})
            jh.after_step(jtr, 10 * i, {})
            th.after_step(ttr, 10 * i + 1, {})  # off the logging step: ignored
            assert th.pick(64) == jh.pick(64) and ttr.dataset.N_rand == jtr.dataset.N_rand
    assert th.pick(64) == 16384
