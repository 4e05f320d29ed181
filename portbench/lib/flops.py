"""Operations and bytes from shapes, and the card's published peaks.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no sparsity):
989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM. They assume the
700 W power limit; each run prints the card's limit beside its numbers.
"""

from __future__ import annotations

from typing import Dict

H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_S = 3.35e12


def nerf_mlp_macs_per_row(cfg: Dict) -> int:
    """Multiply-adds of one sample through vanilla NeRF's MLP (8 x W trunk,
    the input again at layer 5, alpha, feature, the W/2 view layer, rgb)."""
    m = cfg["model"]
    w, depth = m["netwidth"], m["netdepth"]
    cin = 3 * (1 + 2 * m["multires"])
    cv = 3 * (1 + 2 * m["multires_dirs"])
    macs = cin * w  # layer 0
    for i in range(1, depth):
        macs += (cin + w if i == 5 else w) * w
    macs += w * 1 + w * w  # alpha, feature
    macs += (w + cv) * (w // 2) + (w // 2) * 3  # views_0, rgb
    return macs


def nerf_mlp_flop_per_row(cfg: Dict) -> int:
    return 2 * nerf_mlp_macs_per_row(cfg)


def nerf_mlp_bytes_per_row(cfg: Dict) -> int:
    """What one sample's forward must move at the least: its two encodings
    read (f32) and raw rgb and sigma written (f32); the weights are read once
    per launch and left out."""
    m = cfg["model"]
    cin = 3 * (1 + 2 * m["multires"])
    cv = 3 * (1 + 2 * m["multires_dirs"])
    return 4 * (cin + cv) + 4 * 4


def samples_per_ray(cfg: Dict) -> int:
    m = cfg["model"]
    return m["n_samples"] + (m["n_samples"] + m["n_importance"] if m["n_importance"] else 0)


def least_seconds(flop: float, nbytes: float) -> float:
    """The roofline's least time: the larger of the operations over the bf16
    peak and the bytes over the memory rate."""
    return max(flop / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_S)


def nerf_train_flop_per_ray(cfg: Dict) -> float:
    """A training ray's MLP work: every sample forward, and backward at twice
    the forward (data and weight gradients)."""
    return 3.0 * samples_per_ray(cfg) * nerf_mlp_flop_per_row(cfg)


def nerf_render_flop_per_ray(cfg: Dict) -> float:
    return float(samples_per_ray(cfg) * nerf_mlp_flop_per_row(cfg))
