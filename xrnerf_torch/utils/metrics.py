"""Image/quality metrics in torch.

Port of ``xrnerf_tpu/utils/metrics.py:18-101``: ``img2mse``/``mse2psnr``/
``psnr``/``to8b`` and the Gaussian-windowed SSIM. Functions take tensors
or numpy arrays (numpy is read as float32 on the CPU) and return tensors.
LPIPS is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, np.float32))


def img2mse(pred, target) -> torch.Tensor:
    return ((_t(pred) - _t(target)) ** 2).mean()


def mse2psnr(mse) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(_t(mse), min=1e-10))


def psnr(pred, target) -> torch.Tensor:
    return mse2psnr(img2mse(pred, target))


def to8b(x) -> np.ndarray:
    """float [0,1] image -> uint8 (host-side, for png/mp4 dumps)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return (255 * np.clip(np.asarray(x), 0.0, 1.0)).astype(np.uint8)


def ssim(
    img0,
    img1,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Scalar SSIM between two [H, W, C] images in [0, max_val]
    (separable Gaussian window, 'valid' borders, as the JAX version)."""
    img0, img1 = _t(img0).float(), _t(img1).float()
    hw = filter_size // 2
    shift = torch.arange(-hw, hw + 1, dtype=torch.float32, device=img0.device)
    f = torch.exp(-0.5 * (shift / filter_sigma) ** 2)
    f = f / f.sum()
    win = (f[:, None] * f[None, :])[None, None]  # [1, 1, k, k]
    c = img0.shape[-1]

    def blur(z):  # [H, W, C] -> [H-k+1, W-k+1, C]; symmetric window, so
        z = z.permute(2, 0, 1)[None]  # correlation == convolution
        return F.conv2d(z, win.expand(c, 1, -1, -1), groups=c)[0].permute(1, 2, 0)

    mu0, mu1 = blur(img0), blur(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = torch.clamp(blur(img0 * img0) - mu00, min=0.0)
    sigma11 = torch.clamp(blur(img1 * img1) - mu11, min=0.0)
    sigma01 = blur(img0 * img1) - mu01
    sigma01 = torch.sign(sigma01) * torch.minimum(
        torch.sqrt(sigma00 * sigma11), torch.abs(sigma01)
    )
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    return (numer / denom).mean()
