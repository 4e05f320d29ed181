"""Render math of the PyTorch port against the JAX package, in float32.

Same numpy inputs go through both; tolerance atol 1e-5 (float32 ops in
another order), disp compared only where acc > 1e-3 (elsewhere it is
1/max(1e-10, depth/acc) and amplifies float32 noise)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from xrnerf_tpu.models.embedders import posenc as jposenc  # noqa: E402
from xrnerf_tpu.models.renders.volume import volume_render as jvolume_render  # noqa: E402
from xrnerf_tpu.models.samplers.pdf import sample_pdf as jsample_pdf  # noqa: E402
from xrnerf_tpu.models.samplers import stratified as jstrat  # noqa: E402
from xrnerf_tpu.utils import metrics as jmetrics  # noqa: E402
from xrnerf_torch.models.embedders import posenc as tposenc  # noqa: E402
from xrnerf_torch.models.renders.volume import volume_render  # noqa: E402
from xrnerf_torch.models.samplers.pdf import sample_pdf  # noqa: E402
from xrnerf_torch.models.samplers.stratified import sample_along_rays, z_to_pts  # noqa: E402
from xrnerf_torch.utils import metrics as tmetrics  # noqa: E402

ATOL = 1e-5


def _close(t, j, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol, rtol=rtol)


def _rays(rng, n):
    d = rng.randn(n, 3).astype(np.float32)
    return rng.randn(n, 3).astype(np.float32), d


@pytest.mark.parametrize("fn", ["posenc", "posenc_fast"])
@pytest.mark.parametrize("num_freqs,scale", [(10, 1.5), (4, 1.0), (0, 1.0)])
def test_posenc(fn, num_freqs, scale):
    x = (np.random.RandomState(0).uniform(-1, 1, (257, 3)) * scale).astype(np.float32)
    got = getattr(tposenc, fn)(torch.from_numpy(x), num_freqs)
    want = getattr(jposenc, fn)(jnp.asarray(x), num_freqs)
    assert got.shape == want.shape
    _close(got, want)


def test_posenc_fast_round_half_to_even():
    """Turn reduction hits exact .5 ties; both must round them to even."""
    t = np.array([[-2.5, -1.5, -0.5, 0.5, 1.5, 2.5]], np.float32)
    _close(tposenc._sin_2pi(torch.from_numpy(t)), jposenc._sin_2pi(jnp.asarray(t)))


@pytest.mark.parametrize("lindisp", [False, True])
def test_sample_along_rays_and_pts(lindisp):
    rng = np.random.RandomState(1)
    n = 33
    near = rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
    far = (near + rng.uniform(1.0, 4.0, (n, 1))).astype(np.float32)
    got = sample_along_rays(torch.from_numpy(near), torch.from_numpy(far), 17, lindisp=lindisp, perturb=False)
    want = jstrat.sample_along_rays(None, jnp.asarray(near), jnp.asarray(far), 17, lindisp=lindisp, perturb=False)
    _close(got, want)
    o, d = _rays(rng, n)
    _close(
        z_to_pts(torch.from_numpy(o), torch.from_numpy(d), got),
        jstrat.z_to_pts(jnp.asarray(o), jnp.asarray(d), want),
    )


def test_sample_along_rays_perturb_stays_in_strata():
    n, s = 64, 9
    near = torch.full((n, 1), 2.0)
    far = torch.full((n, 1), 6.0)
    base = sample_along_rays(near, far, s, perturb=False)
    z = sample_along_rays(near, far, s, perturb=True, generator=torch.Generator().manual_seed(0))
    mids = 0.5 * (base[:, 1:] + base[:, :-1])
    lower = torch.cat([base[:, :1], mids], -1)
    upper = torch.cat([mids, base[:, -1:]], -1)
    assert bool(((z >= lower) & (z <= upper)).all())
    assert not torch.equal(z, base)


@pytest.mark.parametrize("peaky", [False, True])
def test_sample_pdf_det(peaky):
    rng = np.random.RandomState(2)
    n, b = 40, 63
    z = np.sort(rng.uniform(2.0, 6.0, (n, b + 1)), -1).astype(np.float32)
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    w = (0.05 + rng.rand(n, b - 1)).astype(np.float32)
    if peaky:  # mostly-empty histograms: the denom<1e-5 rule and the top clamp
        w = np.where(rng.rand(n, b - 1) < 0.9, 0.0, w * 50).astype(np.float32)
    got = sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 128, det=True).numpy()
    want = np.asarray(jsample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 128, det=True))
    # u < 1 everywhere, and u = 1 where the last bin holds weight: the
    # inverse CDF is continuous there
    _close(got[:, :-1], want[:, :-1])
    if not peaky:
        _close(got[:, -1], want[:, -1])
    # u = 1 past empty top bins sits on the flat end of the cdf, where the
    # last ulp of its sum (summed in another order by XLA) picks the edge:
    # both land on a bin edge at or past the last bin that holds weight
    last = np.array([np.nonzero(r)[0].max() if r.any() else -1 for r in w])
    for col in (got[:, -1], want[:, -1]):
        for i in range(n):
            assert np.abs(bins[i, last[i] + 1 :] - col[i]).min() < 1e-4


def test_sample_pdf_random_matches_histogram():
    """The random path (torch.Generator) draws from the weight histogram."""
    b = 11
    bins = torch.linspace(0.0, 1.0, b)[None].repeat(4000, 1)
    w = torch.zeros(4000, b - 1)
    w[:, 3] = 1.0
    z = sample_pdf(bins, w, 8, det=False, generator=torch.Generator().manual_seed(0))
    inside = ((z >= bins[0, 3]) & (z <= bins[0, 4])).float().mean()
    assert inside > 0.99


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_volume_render(white_bkgd):
    rng = np.random.RandomState(3)
    n, s = 50, 24
    raw_rgb = rng.randn(n, s, 3).astype(np.float32)
    raw_sigma = (rng.randn(n, s) * 3).astype(np.float32)
    raw_sigma[:5] = -1.0  # empty rays: acc = 0
    z = np.sort(rng.uniform(2.0, 6.0, (n, s)), -1).astype(np.float32)
    _, d = _rays(rng, n)
    got = volume_render(
        torch.from_numpy(raw_rgb), torch.from_numpy(raw_sigma), torch.from_numpy(z),
        torch.from_numpy(d), white_bkgd=white_bkgd,
    )
    want = jvolume_render(
        jnp.asarray(raw_rgb), jnp.asarray(raw_sigma), jnp.asarray(z), jnp.asarray(d),
        white_bkgd=white_bkgd,
    )
    for k in ("rgb", "acc", "depth", "weights", "alpha"):
        _close(got[k], want[k])
    acc = np.asarray(want["acc"])
    assert (acc <= 1e-3).any() and (acc > 1e-3).any()
    m = acc > 1e-3
    _close(got["disp"].numpy()[m], np.asarray(want["disp"])[m])


def test_volume_render_noise_uses_generator():
    n, s = 8, 16
    args = (torch.zeros(n, s, 3), torch.ones(n, s), torch.linspace(2, 6, s).repeat(n, 1), torch.ones(n, 3))
    a = volume_render(*args, generator=torch.Generator().manual_seed(1), raw_noise_std=1.0)
    b = volume_render(*args, generator=torch.Generator().manual_seed(1), raw_noise_std=1.0)
    c = volume_render(*args)
    assert torch.equal(a["acc"], b["acc"]) and not torch.equal(a["acc"], c["acc"])


def test_metrics():
    rng = np.random.RandomState(4)
    a = rng.rand(20, 22, 3).astype(np.float32)
    b = np.clip(a + 0.05 * rng.randn(20, 22, 3), 0, 1).astype(np.float32)
    _close(tmetrics.psnr(a, b), jmetrics.psnr(jnp.asarray(a), jnp.asarray(b)), atol=1e-4)
    _close(tmetrics.ssim(a, b), jmetrics.ssim(jnp.asarray(a), jnp.asarray(b)), atol=1e-5)
    assert np.array_equal(tmetrics.to8b(b), jmetrics.to8b(b))
