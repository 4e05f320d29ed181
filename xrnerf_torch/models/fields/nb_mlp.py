"""NeuralBody NeRF head — port of ``xrnerf_tpu/models/fields/nb_mlp.py``:
a 2-layer trunk over the voxel features (``fc0``, ``fc1``), an ``alpha``
head, and a colour branch over ``[feature(h), appearance code of the frame,
posenc(view dirs, 4), posenc(points, 6)]`` (``color_fc``, ``rgb``). The
``appearance`` table (``nn.Embedding(num_frames, 128)``) is looked up with
the batch's 0-d frame index on its device and broadcast over the points.
f32 ``nn.Linear``, flax's names.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..embedders.posenc import posenc, posenc_channels
from .nerf_mlp import flax_init_


def frame_code(table: nn.Embedding, frame_idx: torch.Tensor, n: int) -> torch.Tensor:
    """The row of a 0-d (or one-element) frame index, broadcast to [n, d]
    (a device-side lookup: no host sync)."""
    return F.embedding(frame_idx.reshape(1).to(torch.int64), table.weight).expand(n, -1)


class NBNerfMLP(nn.Module):
    def __init__(
        self,
        in_ch: int = 128,
        num_frames: int = 1000,
        appearance_dim: int = 128,
        hidden: int = 256,
        multires_dirs: int = 4,
        multires_pts: int = 6,
    ):
        super().__init__()
        self.multires_dirs, self.multires_pts = multires_dirs, multires_pts
        self.fc0 = nn.Linear(in_ch, hidden)
        self.fc1 = nn.Linear(hidden, hidden)
        self.alpha = nn.Linear(hidden, 1)
        self.appearance = nn.Embedding(num_frames, appearance_dim)
        self.feature = nn.Linear(hidden, hidden)
        c_in = hidden + appearance_dim + posenc_channels(3, multires_dirs) + posenc_channels(3, multires_pts)
        self.color_fc = nn.Linear(c_in, hidden // 2)
        self.rgb = nn.Linear(hidden // 2, 3)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        flax_init_(self, generator)

    def forward(self, xyzc_feat, viewdirs, pts, frame_idx) -> Tuple[torch.Tensor, torch.Tensor]:
        """xyzc_feat [P, C], viewdirs [P, 3], pts [P, 3] (normalised to the
        person box), frame_idx [] -> (raw_rgb [P, 3], raw_sigma [P])."""
        h = F.relu(self.fc0(xyzc_feat.float()))
        h = F.relu(self.fc1(h))
        sigma = self.alpha(h)[..., 0]
        app = frame_code(self.appearance, frame_idx, h.shape[0])
        c = torch.cat([self.feature(h), app, posenc(viewdirs, self.multires_dirs), posenc(pts, self.multires_pts)], -1)
        rgb = self.rgb(F.relu(self.color_fc(c)))
        return rgb, sigma
