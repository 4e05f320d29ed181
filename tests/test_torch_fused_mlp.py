"""The port's fused tiny MLPs against the JAX package's Pallas kernels.

On the CPU the port runs the plain versions (``fused_mlp2_plain``,
``fused_mlp3_plain``) and the JAX package runs ``fused_mlp2`` /
``fused_mlp3`` in interpret mode, on the same numpy inputs. Forward bar:
atol 8e-3 / rtol 2e-2 (both sides round to bf16 at the same points, so only
accumulation order and single rounding flips differ). Gradients: autograd of
the plain versions against ``jax.grad`` through the Pallas backward, with the
linear-loss bar of ``tests/test_pallas_ops.py`` (3% of each gradient's scale,
a <1% tail for dx), which is the function the backward kernels must meet.

The CUDA kernels have no CPU or interpret mode; their tests carry the
``cuda`` marker and run on the card with
``XRNERF_TEST_TPU=1 python -m pytest tests/test_torch_fused_mlp.py -m cuda``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from xrnerf_torch.ops.fused_mlp import (  # noqa: E402
    fused_mlp2,
    fused_mlp2_plain,
    fused_mlp3,
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


@pytest.mark.parametrize("n", [1, 64, 512, 549])
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


def _cuda_args(shape, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return [torch.from_numpy(a).cuda() for a in _args(shape, n, seed=n)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_matches_plain_version(shape):
    wrapper, plain = _fns(shape)
    for n in (1, 127, 1000, 70001):
        args = _cuda_args(shape, n)
        before = wrapper.launches
        with torch.no_grad():
            got = wrapper(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        torch.testing.assert_close(got, plain(*args), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_cuda_path_refuses_gradients_and_unsupported_shapes():
    args = _cuda_args((32, 64, 16), 64)
    args[1].requires_grad_()
    with pytest.raises(NotImplementedError, match="slice 4"):
        fused_mlp2(*args)
    wide = _cuda_args((48, 64, 16), 64)
    with pytest.raises(ValueError, match="d_in <="), torch.no_grad():
        fused_mlp2(*wide)
