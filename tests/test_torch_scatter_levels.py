"""The port's many-level row scatter (``scatter_add_rows_levels``, the hash
encodings' table gradient in one launch) against the JAX package's
``scatter_add_rows``, level by level, on the same numpy inputs.

On the CPU the port runs its plain version (one ``index_add_`` over
``idx + l * T``); the JAX package runs its Pallas scatter in interpret mode
and its XLA path, once per level, as ``tests/test_torch_ngp_train.py`` does
for one table. Both sides are f32 and differ only in summation order: rtol
1e-5, atol 1e-5.

The CUDA kernel has no CPU or interpret mode; its tests carry the ``cuda``
marker and run on the card with
``XRNERF_TEST_TPU=1 python -m pytest tests/test_torch_scatter_levels.py -m cuda``.
There f32 atomics add in another order every run: rtol 1e-4 plus 1e-4 of
the largest sum.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from xrnerf_torch.ops import scatter_rows as sr  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _levels_case(L, M, W, T, rows, seed, dead=0.3, negative=0.1):
    """[L, M] ids in [0, rows[l]) with some negative, [L, M, W] values with
    some all-zero rows."""
    rng = np.random.RandomState(seed)
    idx = np.stack([rng.randint(0, r, size=M) for r in rows]).astype(np.int64)
    idx[rng.uniform(size=(L, M)) < negative] = -1
    vals = rng.randn(L, M, W).astype(np.float32)
    vals[rng.uniform(size=(L, M)) < dead] = 0.0
    return idx, vals


def _jax_levels(idx, vals, rows, T, skip):
    """The JAX scatter per level, each into its rows and padded with zeros
    to T (the vertex encoding's dense levels): (Pallas interpret, XLA)."""
    import jax.numpy as jnp

    from xrnerf_tpu.ops.pallas import scatter_rows as jsr

    pallas, xla = [], []
    for lvl, r in enumerate(rows):
        i, v = idx[lvl], vals[lvl]
        flagged = np.where((v != 0).any(-1), i, -1) if skip else i  # the JAX wrapper's flagging (:198-200)
        p = np.asarray(jsr._pallas_scatter_add_rows(jnp.asarray(flagged), jnp.asarray(v), r, interpret=True))
        # XLA's scatter wraps a negative id to the last rows, so the dropped rows' values are zeroed
        zeroed = np.where(i[:, None] >= 0, v, 0.0).astype(np.float32)
        x = np.asarray(jsr.scatter_add_rows(jnp.asarray(i), jnp.asarray(zeroed), r, skip_zero_rows=skip))
        pad = np.zeros((T - r, v.shape[1]), np.float32)
        pallas.append(np.concatenate([p, pad]))
        xla.append(np.concatenate([x, pad]))
    return np.stack(pallas), np.stack(xla)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize(
    "W,T,rows",
    [(2, 512, (64, 343, 512, 512)), (16, 128, (128, 128, 128)), (2, 64, (8,)), (16, 64, (27, 64))],
    ids=["vertex_w2", "brick_w16", "one_level", "dense_w16"],
)
def test_levels_plain_matches_jax_per_level(W, T, rows, skip):
    L, M = len(rows), 777
    idx, vals = _levels_case(L, M, W, T, rows, seed=W + T + L)
    want_pallas, want_xla = _jax_levels(idx, vals, rows, T, skip)
    for dtype in (torch.int32, torch.int64):
        got = sr.scatter_add_rows_levels_plain(_t(idx).to(dtype), _t(vals), rows, T, skip_zero_rows=skip)
        assert got.shape == (L, T, W) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want_pallas, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), want_xla, rtol=1e-5, atol=1e-5)
    for lvl, r in enumerate(rows):  # a dense level's rows past res^3 stay zero
        assert float(got[lvl, r:].abs().sum()) == 0.0
    # on CPU tensors the wrapper is the plain version and launches nothing
    before = sr.scatter_add_rows_levels.launches
    assert torch.equal(sr.scatter_add_rows_levels(_t(idx), _t(vals), rows, T, skip_zero_rows=skip), got)
    assert sr.scatter_add_rows_levels.launches == before


def test_levels_plain_equals_one_level_scatters():
    """Level l of the stack is the one-table scatter of level l's rows."""
    rows, T = (30, 200, 200), 200
    idx, vals = _levels_case(3, 500, 2, T, rows, seed=3)
    got = sr.scatter_add_rows_levels_plain(_t(idx), _t(vals), rows, T, skip_zero_rows=True)
    for lvl, r in enumerate(rows):
        one = sr.scatter_add_rows_plain(_t(idx[lvl]), _t(vals[lvl]), r, skip_zero_rows=True)
        assert torch.equal(got[lvl, :r], one)


def test_levels_drop_ids_past_a_levels_rows():
    idx = torch.tensor([[0, 3, 5, -2], [1, 1, 6, 7]])
    vals = torch.ones(2, 4, 2)
    out = sr.scatter_add_rows_levels(idx, vals, [4, 8], 8)
    assert out[0].sum(-1).tolist() == [2, 0, 0, 2, 0, 0, 0, 0]  # id 5 >= 4 rows: dropped
    assert out[1].sum(-1).tolist() == [0, 4, 0, 0, 0, 0, 2, 2]
    assert torch.equal(sr.scatter_add_rows(idx[0], vals[0], 4), out[0, :4])


def test_levels_wrapper_rejects_bad_shapes():
    idx, vals = torch.zeros(2, 5, dtype=torch.int64), torch.zeros(2, 5, 2)
    with pytest.raises(ValueError, match=r"idx \[L, M\]"):
        sr.scatter_add_rows_levels(idx[0], vals, [4, 4], 4)
    with pytest.raises(ValueError, match=r"idx \[L, M\]"):
        sr.scatter_add_rows_levels(idx[:, :4], vals, [4, 4], 4)
    with pytest.raises(TypeError, match="int32 or int64"):
        sr.scatter_add_rows_levels(idx.float(), vals, [4, 4], 4)


@pytest.mark.parametrize("skip", [False, True])
def test_plain_drops_ids_past_num_rows_as_xla_does(skip):
    """Ids at or past the row count add nothing, in the plain versions and in
    the JAX package's XLA scatter (``mode="drop"``), which both must match."""
    import jax.numpy as jnp

    from xrnerf_tpu.ops.pallas import scatter_rows as jsr

    rng = np.random.RandomState(5)
    idx = rng.randint(0, 40, size=300).astype(np.int32)  # a third past the 30 rows
    vals = rng.randn(300, 2).astype(np.float32)
    vals[::7] = 0.0
    want = np.asarray(jsr.scatter_add_rows(jnp.asarray(idx), jnp.asarray(vals), 30, skip_zero_rows=skip))
    got = sr.scatter_add_rows_plain(_t(idx), _t(vals), 30, skip_zero_rows=skip)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    stacked = sr.scatter_add_rows_levels_plain(_t(idx)[None], _t(vals)[None], [30], 30, skip_zero_rows=skip)
    assert torch.equal(stacked[0], got)


def _mode_names(rows, W):
    names = {sr.SHARED: "shared", sr.AGGREGATE: "aggregate", sr.PLAIN: "plain"}
    return [names[m] for m in sr.level_modes(rows, W)]


@pytest.mark.parametrize(
    "rows,W,want",
    [
        ((4096, 10648, 27000, 524288), 2, ["shared", "aggregate", "aggregate", "aggregate"]),
        ((6144, 6145), 2, ["shared", "aggregate"]),  # the 48 KB budget's edge
        ((65536,), 16, ["plain"]),
        ((100,), 3, ["plain"]),
        ((1 << 19,), 2, ["aggregate"]),
    ],
)
def test_level_modes_rule(rows, W, want):
    assert sr.SHARED_TABLE_BYTES == 48 * 1024
    assert _mode_names(rows, W) == want


# --- on the card -------------------------------------------------------------


def _bar_check(got, want, what):
    err = (got - want).abs()
    bar = 1e-4 * float(want.abs().max()) + 1e-4 * want.abs()
    at = int(torch.argmax(err - bar))
    assert bool(torch.isfinite(got).all()) and bool((err <= bar).all()), (
        f"{what}: element {at} is {float(got.flatten()[at])}, plain {float(want.flatten()[at])}, "
        f"max abs err {float(err.max())}")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "modes,W,rows,T",
    [
        ("shared", 2, (100, 600, 37), 600),
        ("aggregate", 2, (7000, 20000, 6500), 20000),
        ("mixed", 2, (100, 20000, 37), 20000),
        ("plain", 16, (100, 600, 37), 600),
        ("plain", 3, (100, 600, 37), 600),
    ],
)
def test_cuda_levels_kernel_each_mode(modes, W, rows, T):
    """Every mode, picked by the rule from the levels' row counts and the
    width (shared tables for small W = 2 levels, warp sums for large ones,
    both in one launch; plain for other widths), every load path (16-byte
    loads where M and the alignment allow, scalar tails), both id types,
    with and without skipping."""
    _cuda()
    assert set(_mode_names(rows, W)) == ({"shared", "aggregate"} if modes == "mixed" else {modes})
    for M in (1, 127, 128, 1000, 70001):
        idx, vals = _levels_case(3, M, W, T, rows, seed=M + W, dead=0.3, negative=0.2)
        for dtype in (torch.int32, torch.int64):
            ci, cv = _t(idx).to(dtype).cuda(), _t(vals).cuda()
            for skip in (False, True):
                before = sr.scatter_add_rows_levels.launches
                got = sr.scatter_add_rows_levels(ci, cv, rows, T, skip_zero_rows=skip)
                torch.cuda.synchronize()
                assert sr.scatter_add_rows_levels.launches == before + 1
                want = sr.scatter_add_rows_levels_plain(ci, cv, rows, T, skip_zero_rows=skip)
                _bar_check(got, want, f"{modes} W={W} M={M} {dtype} skip={skip}")


@pytest.mark.cuda
@pytest.mark.parametrize("ids", ["all_equal", "sorted_runs_of_32", "random"])
def test_cuda_levels_kernel_adversarial_ids(ids):
    """Ids that make every lane of a warp add into one row, runs of 32 equal
    ids, and random ids, in each mode: ids below 4,096 scattered into a
    4,096-row level (shared), a 65,536-row level (aggregate) and, at W = 16,
    a 4,096-row level (plain)."""
    _cuda()
    M, R = 1 << 20, 4096
    if ids == "all_equal":
        idx = torch.full((1, M), 7, dtype=torch.int64)
    elif ids == "sorted_runs_of_32":
        idx = (torch.arange(M) // 32 % R)[None]
    else:
        idx = torch.from_numpy(np.random.RandomState(0).randint(0, R, (1, M)))
    ci = idx.cuda()
    for T, W, mode in ((R, 2, "shared"), (16 * R, 2, "aggregate"), (R, 16, "plain")):
        assert _mode_names([T], W) == [mode]
        cv = torch.from_numpy(np.random.RandomState(1).randn(1, M, W).astype(np.float32)).cuda()
        want = sr.scatter_add_rows_levels_plain(ci, cv, [T], T)
        got = sr.scatter_add_rows_levels(ci, cv, [T], T)
        torch.cuda.synchronize()
        _bar_check(got, want, f"{ids} {mode}")
