"""The port's fused tiny MLPs against the JAX package's Pallas kernels.

On the CPU the port runs the plain versions (``fused_mlp2_plain``,
``fused_mlp3_plain``) and the JAX package runs ``fused_mlp2`` /
``fused_mlp3`` in interpret mode, on the same numpy inputs. Forward bar:
atol 8e-3 / rtol 2e-2 (both sides round to bf16 at the same points, so only
accumulation order and single rounding flips differ). Gradients: the plain
backward versions (``fused_mlp2_bwd_plain``, ``fused_mlp3_bwd_plain``: the
Pallas backward bodies step by step) and autograd of the plain forwards,
each against ``jax.grad`` through the Pallas backward, with the linear-loss
bar of ``tests/test_pallas_ops.py`` (3% of each gradient's scale, a <1% tail
for dx), which is the function the backward kernels must meet.

The CUDA kernels have no CPU or interpret mode; their tests carry the
``cuda`` marker and run on the card with
``XRNERF_TEST_TPU=1 python -m pytest tests/test_torch_fused_mlp.py -m cuda``.
There a one-row case is held to an absolute tolerance (one bf16 rounding
flip decides a cosine over a single row), and a failure names the worst leaf
with its cosine, norm ratio and largest error.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from xrnerf_torch.ops.fused_mlp import (  # noqa: E402
    FusedMLP2Function,
    FusedMLP3Function,
    fused_mlp2,
    fused_mlp2_bwd,
    fused_mlp2_bwd_plain,
    fused_mlp2_plain,
    fused_mlp3,
    fused_mlp3_bwd,
    fused_mlp3_bwd_plain,
    fused_mlp3_plain,
)

RTOL, ATOL = 2e-2, 8e-3
SHAPES = [(32, 64, 16), (16, 32, 8), (31, 64, 64, 3)]


def _args(shape, n, seed, scale=0.2):
    """x [n, d_in] and the (w [in, out], b [out]) chain, numpy f32."""
    rng = np.random.RandomState(seed)
    out = [rng.randn(n, shape[0]).astype(np.float32)]
    for i, o in zip(shape[:-1], shape[1:]):
        out += [(scale * rng.randn(i, o)).astype(np.float32), (scale * rng.randn(o)).astype(np.float32)]
    return out


def _fns(shape):
    """(the port's wrapper, its plain version) for a layer chain."""
    return (fused_mlp2, fused_mlp2_plain) if len(shape) == 3 else (fused_mlp3, fused_mlp3_plain)


def _jax_fn(shape):
    """The JAX package's Pallas function (interpret mode on the CPU). JAX is
    imported here, not at the top: the card-only tests run where it is absent."""
    from xrnerf_tpu.ops.pallas import fused_mlp as jmlp

    return jmlp.fused_mlp2 if len(shape) == 3 else jmlp.fused_mlp3


@pytest.mark.parametrize("n", [1, 64, 127, 128, 129, 512, 549])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_matches_pallas(shape, n):
    import jax.numpy as jnp

    wrapper, plain = _fns(shape)
    args = _args(shape, n, seed=n)
    want = np.asarray(_jax_fn(shape)(*map(jnp.asarray, args)))
    targs = [torch.from_numpy(a) for a in args]
    got = plain(*targs)
    assert got.shape == (n, shape[-1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # on CPU tensors the wrapper is the plain version and launches nothing
    before = wrapper.launches
    assert torch.equal(wrapper(*targs), got) and wrapper.launches == before


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_gradients_match_pallas_backward(shape):
    import jax
    import jax.numpy as jnp

    jfn, plain = _jax_fn(shape), _fns(shape)[1]
    n = 512 + 10
    args = _args(shape, n, seed=1)
    c = np.random.RandomState(7).randn(shape[-1]).astype(np.float32)
    # linear loss -> constant cotangent (tests/test_pallas_ops.py:47-49)
    g_j = jax.grad(lambda *a: jnp.sum(jfn(*a) * jnp.asarray(c)), argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args)
    )
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    (plain(*targs) * torch.from_numpy(c)).sum().backward()
    for i, (t, want) in enumerate(zip(targs, g_j)):
        a, b = t.grad.numpy(), np.asarray(want)
        scale = np.abs(b).max() + 1e-8
        close = np.abs(a - b) / scale < 0.03
        if i == 0:  # dx rows whose ReLU mask flipped change discretely
            assert close.mean() > 0.99, close.mean()
        else:
            np.testing.assert_allclose(a / scale, b / scale, atol=0.03, err_msg=f"arg {i}")


def test_wrapper_rejects_bad_shapes():
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _args((32, 64, 16), 8, seed=0))
    with pytest.raises(ValueError, match="layer 1"):
        fused_mlp2(x[:, :31], w1, b1, w2, b2)
    with pytest.raises(ValueError, match="layer 2"):
        fused_mlp2(x, w1, b1, w2[:32], b2)
    with pytest.raises(ValueError, match=r"\[N, d_in\]"):
        fused_mlp2(x[0], w1, b1, w2, b2)


def _bwd_fns(shape):
    """(the port's backward wrapper, its plain version, the autograd op)."""
    if len(shape) == 3:
        return fused_mlp2_bwd, fused_mlp2_bwd_plain, FusedMLP2Function
    return fused_mlp3_bwd, fused_mlp3_bwd_plain, FusedMLP3Function


def _bwd_args(args):
    """The backward's arguments from the forward's: the last bias drops out."""
    return args[:-1]


def _close_grads(got, want, what):
    """tests/test_pallas_ops.py's bar: weight and bias gradients within 3% of
    the gradient's scale, dx with a <1% tail (rows whose ReLU mask flipped)."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == np.float32, (what, i, a.shape, b.shape)
        scale = np.abs(b).max() + 1e-8
        close = np.abs(a - b) / scale < 0.03
        if i == 0:
            assert close.mean() > 0.99, (what, close.mean())
        else:
            np.testing.assert_allclose(a / scale, b / scale, atol=0.03, err_msg=f"{what} arg {i}")


@pytest.mark.parametrize("n", [1, 522])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bwd_plain_matches_pallas_backward(shape, n):
    import jax
    import jax.numpy as jnp

    jfn = _jax_fn(shape)
    wrapper, plain, _ = _bwd_fns(shape)
    args = _args(shape, n, seed=n + 1)
    g = np.random.RandomState(7).randn(n, shape[-1]).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jfn(*a) * jnp.asarray(g)), argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args)
    )
    targs = [torch.from_numpy(a) for a in _bwd_args(args)]
    got = plain(*targs, torch.from_numpy(g))
    _close_grads([t.numpy() for t in got], want, "plain backward")
    # on CPU tensors the wrapper is the plain version and launches nothing
    before = wrapper.launches
    again = wrapper(*targs, torch.from_numpy(g))
    assert all(torch.equal(a, b) for a, b in zip(again, got)) and wrapper.launches == before


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bwd_plain_matches_autograd_of_plain_forward(shape):
    n = 300
    args = _args(shape, n, seed=3)
    g = torch.from_numpy(np.random.RandomState(8).randn(n, shape[-1]).astype(np.float32))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    (_fns(shape)[1](*targs) * g).sum().backward()
    got = _bwd_fns(shape)[1](*[t.detach() for t in _bwd_args(targs)], g)
    _close_grads([t.numpy() for t in got], [t.grad.numpy() for t in targs], "against autograd")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_autograd_op_on_cpu_tensors(shape):
    """The op the card path uses, driven on the CPU: the plain forward, the
    plain backward, and a gradient only where one is asked for."""
    _, bwd_plain, op = _bwd_fns(shape)
    args = _args(shape, 70, seed=4)
    g = torch.from_numpy(np.random.RandomState(9).randn(70, shape[-1]).astype(np.float32))
    targs = [torch.from_numpy(a).requires_grad_(i != 2) for i, a in enumerate(args)]
    out = op.apply(*targs)
    assert torch.equal(out, _fns(shape)[1](*[t.detach() for t in targs]))
    (out * g).sum().backward()
    want = bwd_plain(*[t.detach() for t in _bwd_args(targs)], g)
    assert targs[2].grad is None
    for i, (t, w) in enumerate(zip(targs, want)):
        if i != 2:
            assert torch.equal(t.grad, w), i


def test_bwd_wrapper_rejects_bad_shapes():
    x, w1, b1, w2, _ = (torch.from_numpy(a) for a in _args((32, 64, 16), 8, seed=0))
    with pytest.raises(ValueError, match="expected g"):
        fused_mlp2_bwd(x, w1, b1, w2, torch.zeros(8, 15))
    with pytest.raises(ValueError, match="layer 2"):
        fused_mlp2_bwd(x, w1, b1, w2[:32], torch.zeros(8, 16))


def _cuda_args(shape, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return [torch.from_numpy(a).cuda() for a in _args(shape, n, seed=n)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_matches_plain_version(shape):
    """One row, a ragged, a full and a one-over 128-row tile, a ragged tile
    inside a warpgroup's 64 rows, and ragged last tiles after many
    grid-stride turns; two launches give the same bits."""
    wrapper, plain = _fns(shape)
    for n in (1, 127, 128, 129, 522, 1000, 70001, 262_144 + 37):
        args = _cuda_args(shape, n)
        before = wrapper.launches
        with torch.no_grad():
            got = wrapper(*args)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            torch.testing.assert_close(got, plain(*args), rtol=RTOL, atol=ATOL)
            assert torch.equal(wrapper(*args), got), f"N={n}: other bits on a second launch"


def _leaf_report(got, want):
    """Per leaf (cosine, norm ratio, max abs error, reference max), worst cosine first."""
    rows = []
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.double().flatten(), b.double().flatten()
        cos = float(a @ b / (a.norm() * b.norm() + 1e-30))
        rows.append((cos, float(a.norm() / (b.norm() + 1e-30)), float((a - b).abs().max()), float(b.abs().max()), i))
    return sorted(rows)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_bwd_kernel_matches_plain_version(shape):
    """N >= 127: per leaf cosine > 0.99 and norm ratio 0.93-1.07 (the JAX
    package's fused-MLP bars). N = 1: every value within 3% of its leaf's
    largest entry plus 1e-6. Two launches give the same bits. The row counts
    cover one row, a ragged first tile, one and a half 64-row warpgroup
    halves, and a ragged last tile after many grid-stride turns."""
    wrapper, plain, _ = _bwd_fns(shape)
    for n in (1, 127, 128, 129, 522, 1000, 70001, 262_144 + 37):
        args = _bwd_args(_cuda_args(shape, n))
        g = torch.from_numpy(np.random.RandomState(n).randn(n, shape[-1]).astype(np.float32)).cuda() / n
        before = wrapper.launches
        got = wrapper(*args, g)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        want = plain(*args, g)
        report = _leaf_report(got, want)
        worst = "worst leaf %d of N=%d: cosine %.6f, norm ratio %.5f, max abs err %.3e (leaf max %.3e)" % (
            report[0][4], n, *report[0][:4])
        assert all(bool(torch.isfinite(t).all()) for t in got), worst
        if n == 1:
            for a, b in zip(got, want):
                assert float((a - b).abs().max()) <= 0.03 * float(b.abs().max()) + 1e-6, worst
        else:
            assert all(c > 0.99 and 0.93 < r < 1.07 for c, r, _, _, _ in report), worst
        assert all(torch.equal(a, b) for a, b in zip(wrapper(*args, g), got)), f"N={n}: other bits on a second launch"


@pytest.mark.cuda
def test_cuda_path_refuses_gradients_and_unsupported_shapes():
    """The card path gives gradients through the backward kernel (it refused
    them while that kernel was missing) and still refuses a shape the kernels
    do not take."""
    args = _cuda_args((32, 64, 16), 64)
    for t in args:
        t.requires_grad_()
    before = (fused_mlp2.launches, fused_mlp2_bwd.launches)
    fused_mlp2(*args).sum().backward()
    torch.cuda.synchronize()
    assert (fused_mlp2.launches, fused_mlp2_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = fused_mlp2_bwd_plain(*[t.detach() for t in args[:-1]], torch.ones(64, 16).cuda())
    report = _leaf_report([t.grad for t in args], want)
    assert all(c > 0.99 and 0.93 < r < 1.07 for c, r, _, _, _ in report), report[0]
    wide = _cuda_args((48, 64, 16), 64)
    with pytest.raises(ValueError, match="d_in <="), torch.no_grad():
        fused_mlp2(*wide)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES[::2], ids=lambda s: "x".join(map(str, s)))
def test_cuda_bwd_refuses_misaligned_inputs(shape):
    """The backward kernel copies x and g in 16-byte blocks: a view that does
    not start on a 16-byte boundary is refused, not copied."""
    wrapper, _, _ = _bwd_fns(shape)
    args = _bwd_args(_cuda_args(shape, 256))
    g = torch.zeros(256, shape[-1]).cuda()
    x = torch.zeros(256 * shape[0] + 1).cuda()[1:].view(256, shape[0])
    x.copy_(args[0])
    with pytest.raises(ValueError, match="16-byte aligned"):
        wrapper(x, *args[1:], g)
    gm = torch.zeros(256 * shape[-1] + 1).cuda()[1:].view(256, shape[-1])
    with pytest.raises(ValueError, match="16-byte aligned"):
        wrapper(*args, gm)


@pytest.mark.cuda
def test_cuda_fwd_refuses_misaligned_inputs():
    """The colour net's forward copies x in 16-byte blocks: a view 4 bytes
    off a 16-byte boundary is refused, not copied."""
    shape = SHAPES[2]
    args = _cuda_args(shape, 256)
    x = torch.zeros(256 * shape[0] + 1).cuda()[1:].view(256, shape[0])
    x.copy_(args[0])
    with pytest.raises(ValueError, match="16-byte aligned"), torch.no_grad():
        fused_mlp3(x, *args[1:])
