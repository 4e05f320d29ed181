"""KiloNeRF datasets — port of ``xrnerf_tpu/datasets/kilonerf.py``.

- ``KiloNerfDataset``: ``SceneDataset`` that also carries the global domain
  (the layout's ``bbox`` when it has one, overridden by the config).
- ``KiloNerfDistillDataset``: random (points, directions) per network cell,
  drawn from a numpy ``RandomState`` seeded per step exactly as the JAX
  version draws them, with the teacher's targets. ``teacher_fn`` takes
  torch tensors on ``device`` (the card unless the caller says otherwise).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..registry import DATASETS
from ..utils.device import resolve_device
from .scene import SceneDataset


@DATASETS.register
class KiloNerfDataset(SceneDataset):
    """Scene dataset that also carries the global domain bbox."""

    def __init__(self, *args, global_domain_min: Optional[Sequence[float]] = None,
                 global_domain_max: Optional[Sequence[float]] = None, **kwargs):
        super().__init__(*args, **kwargs)
        if global_domain_min is None:
            global_domain_min = self.bbox[0] if self.bbox is not None else (-1.0,) * 3
        if global_domain_max is None:
            global_domain_max = self.bbox[1] if self.bbox is not None else (1.0,) * 3
        self.global_domain_min = np.asarray(global_domain_min, np.float32)
        self.global_domain_max = np.asarray(global_domain_max, np.float32)


@DATASETS.register
class KiloNerfDistillDataset:
    """Random (pts, dirs) examples per network cell + teacher targets.

    ``teacher_fn(pts [B, 3], dirs [B, 3]) -> (rgb [B, 3], sigma [B])``, on
    torch tensors on ``device``; targets are computed per batch."""

    def __init__(
        self,
        resolution: Sequence[int] = (16, 16, 16),
        domain_min: Sequence[float] = (-1.0, -1.0, -1.0),
        domain_max: Sequence[float] = (1.0, 1.0, 1.0),
        points_per_net: int = 8,
        teacher_fn: Optional[Callable] = None,
        seed: int = 0,
        device="cuda",
    ):
        self.res = tuple(int(r) for r in resolution)
        self.n_nets = int(np.prod(self.res))
        self.dmin = np.asarray(domain_min, np.float32)
        self.dmax = np.asarray(domain_max, np.float32)
        self.points_per_net = int(points_per_net)
        self.N_rand = self.n_nets * self.points_per_net  # trainer telemetry
        self.seed = seed
        self._teacher = teacher_fn
        self.device = resolve_device(device) if teacher_fn is not None else None
        # cell lower corners [n_nets, 3] in unit coordinates
        g = np.stack(np.meshgrid(*[np.arange(r) for r in self.res], indexing="ij"), -1).reshape(-1, 3)
        self._cell0 = g.astype(np.float32) / np.asarray(self.res, np.float32)
        self._cell_size = 1.0 / np.asarray(self.res, np.float32)

    def train_batch(self, step: int, host_id: int = 0, num_hosts: int = 1) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed + step) * num_hosts + host_id + 17)
        p = self.points_per_net
        u = rng.rand(self.n_nets, p, 3).astype(np.float32)
        rel = self._cell0[:, None, :] + u * self._cell_size
        pts = (self.dmin + rel * (self.dmax - self.dmin)).reshape(-1, 3)
        dirs = rng.randn(self.n_nets * p, 3).astype(np.float32)
        dirs /= np.maximum(np.linalg.norm(dirs, axis=-1, keepdims=True), 1e-8)
        batch = {"pts": pts, "dirs": dirs}
        if self._teacher is not None:
            with torch.no_grad():
                rgb, sigma = self._teacher(torch.from_numpy(pts).to(self.device),
                                           torch.from_numpy(dirs).to(self.device))
            batch["target_rgb"] = rgb.float().cpu().numpy()
            batch["target_sigma"] = sigma.float().cpu().numpy()
        return batch
