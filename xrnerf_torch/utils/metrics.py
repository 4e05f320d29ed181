"""Image/quality metrics in torch.

Port of ``xrnerf_tpu/utils/metrics.py``: ``img2mse``/``mse2psnr``/
``psnr``/``to8b``/``huber``, the Gaussian-windowed SSIM and ``LPIPS``. Functions
take tensors or numpy arrays (numpy is read as float32 on the CPU) and return
tensors.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F

from .device import resolve_device


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


def huber(pred, target, delta: float = 0.1) -> torch.Tensor:
    """Mean Huber loss (Instant-NGP's HuberLoss)."""
    abs_err = (_t(pred) - _t(target)).abs()
    quad = abs_err.clamp(max=delta)
    return (0.5 * quad**2 + delta * (abs_err - quad)).mean()


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
    (separable Gaussian window, 'valid' borders, as the JAX version; an
    image smaller than the window on both axes becomes the window's filter
    there, as in ``convolve2d(mode="valid")``)."""
    img0, img1 = _t(img0).float(), _t(img1).float()
    hw = filter_size // 2
    shift = torch.arange(-hw, hw + 1, dtype=torch.float32, device=img0.device)
    f = torch.exp(-0.5 * (shift / filter_sigma) ** 2)
    f = f / f.sum()
    win = (f[:, None] * f[None, :])[None, None]  # [1, 1, k, k]
    c = img0.shape[-1]

    def blur(z):  # [H, W, C] -> [H-k+1, W-k+1, C]; symmetric window, so
        z = z.permute(2, 0, 1)  # correlation == convolution
        if z.shape[1] < filter_size and z.shape[2] < filter_size:
            # an image smaller than the window on both axes: 'valid' swaps the
            # two (scipy's and jax.scipy's convolve2d), [k-H+1, k-W+1, C]
            return F.conv2d(win, z.flip(1, 2)[:, None])[0].permute(1, 2, 0)
        return F.conv2d(z[None], win.expand(c, 1, -1, -1), groups=c)[0].permute(1, 2, 0)

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


class LPIPS:
    """Learned perceptual metric (GNR's evaluation) — a copy of the JAX
    package's, which is torch already, on ``device`` (the card by default;
    raises without one unless ``device="cpu"``).

    It reads only a local ``weights_path``: a torch state dict holding
    ``vgg16.features``' conv weights and biases (in their index order) and
    optionally LPIPS's per-layer ``lin{i}.weight`` calibrations. Nothing is
    fetched; a file without conv weights raises.
    """

    # VGG16 features: 2/2/3/3/3 convs per LPIPS slice
    _SLICE_ENDS = (2, 4, 7, 10, 13)

    def __init__(self, weights_path: str, device="cuda"):
        self.device = resolve_device(device)
        sd = torch.load(weights_path, map_location=self.device)
        self.convs = {k: v.float() for k, v in sd.items() if k.endswith("weight") and v.ndim == 4}
        self.biases = {k: v.float() for k, v in sd.items() if k.endswith("bias")}
        self.lins = {k: v.float() for k, v in sd.items() if "lin" in k}
        if not self.convs:
            raise ValueError(f"no conv weights found in {weights_path}")
        self._conv_items = sorted(self.convs.items(), key=lambda kv: _key_num(kv[0]))
        self._mean = torch.tensor([0.485, 0.456, 0.406], device=self.device).view(1, 3, 1, 1)
        self._std = torch.tensor([0.229, 0.224, 0.225], device=self.device).view(1, 3, 1, 1)

    def _feats(self, img):
        x = img if isinstance(img, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(img))
        x = x.to(self.device).float()
        x = (x.permute(2, 0, 1)[None] - self._mean) / self._std
        outs, ci = [], 0
        with torch.no_grad():
            for end in self._SLICE_ENDS:
                while ci < min(end, len(self._conv_items)):
                    k, w = self._conv_items[ci]
                    x = torch.relu(F.conv2d(x, w, self.biases.get(k.replace("weight", "bias")), padding=1))
                    ci += 1
                outs.append(x / (x.norm(dim=1, keepdim=True) + 1e-10))
                x = F.max_pool2d(x, 2)
        return outs

    def __call__(self, pred, target) -> float:
        """pred/target [H, W, 3] in [0, 1] -> scalar LPIPS distance."""
        d = 0.0
        for i, (a, b) in enumerate(zip(self._feats(pred), self._feats(target))):
            diff = (a - b) ** 2
            lin = self.lins.get(f"lin{i}.weight")
            if lin is not None:
                d += float((diff * lin.view(1, -1, 1, 1).abs()).sum(dim=1).mean())
            else:
                d += float(diff.mean())
        return d


def _key_num(k: str) -> int:
    m = re.search(r"(\d+)", k)
    return int(m.group(1)) if m else 0
