"""The operation counts against a hand count."""

from __future__ import annotations

from portbench.lib import flops


def small():
    return {"model": {"netwidth": 8, "netdepth": 8, "multires": 1, "multires_dirs": 1,
                      "n_samples": 4, "n_importance": 6}}


def test_mlp_macs_by_hand():
    # x: 3 (1 + 2) = 9 wide, views 9 wide, width 8: layer 0 9*8, layers 1-4, 6, 7 8*8,
    # layer 5 (9 + 8) * 8, alpha 8, feature 8*8, views_0 (8 + 9) * 4, rgb 4 * 3
    hand = 9 * 8 + 6 * 64 + 17 * 8 + 8 + 64 + 17 * 4 + 12
    assert flops.nerf_mlp_macs_per_row(small()) == hand == 744
    assert flops.nerf_mlp_flop_per_row(small()) == 2 * hand


def test_published_widths():
    cfg = {"model": {"netwidth": 256, "netdepth": 8, "multires": 10, "multires_dirs": 4,
                     "n_samples": 64, "n_importance": 128}}
    assert flops.nerf_mlp_flop_per_row(cfg) == 1_186_816  # 63/27 wide encodings, as the kernels' bound_ms
    assert flops.samples_per_ray(cfg) == 64 + 192
    assert flops.nerf_train_flop_per_ray(cfg) == 3 * 256 * 1_186_816
    assert flops.nerf_mlp_bytes_per_row(cfg) == 4 * (63 + 27) + 16


def test_samples_and_least_time():
    assert flops.samples_per_ray(small()) == 4 + 10
    assert flops.least_seconds(989e12, 0) == 1.0
    assert flops.least_seconds(0, 3.35e12) == 1.0
