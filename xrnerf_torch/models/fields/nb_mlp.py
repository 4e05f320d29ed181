"""NeuralBody NeRF head — port of ``xrnerf_tpu/models/fields/nb_mlp.py``:
a 2-layer trunk over the voxel features (``fc0``, ``fc1``), an ``alpha``
head, and a colour branch over ``[feature(h), appearance code of the frame,
posenc(view dirs, 4), posenc(points, 6)]`` (``color_fc``, ``rgb``). The
``appearance`` table (``nn.Embedding(num_frames, 128)``) is looked up with
the batch's 0-d frame index on its device and broadcast over the points.
``nn.Linear`` in ``dtype`` (f32 by default), flax's names.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...utils.dtype import Dense, resolve_dtype
from ..embedders.posenc import posenc, posenc_channels
from .nerf_mlp import flax_init_


def frame_code(table: nn.Embedding, frame_idx: torch.Tensor, n: int) -> torch.Tensor:
    """The row of a 0-d (or one-element) frame index, broadcast to [n, d]
    (a device-side lookup: no host sync)."""
    return F.embedding(frame_idx.reshape(1).to(torch.int64), table.weight).expand(n, -1)


class NBNerfMLP(nn.Module):
    """``dtype`` is flax's compute dtype of the ``Dense`` layers (the JAX
    field ``xrnerf_tpu/models/fields/nb_mlp.py:27``; the appearance table is
    f32 and its row cast to ``dtype``); raw rgb and sigma come out f32
    (``nb_mlp.py:52``)."""

    def __init__(
        self,
        in_ch: int = 128,
        num_frames: int = 1000,
        appearance_dim: int = 128,
        hidden: int = 256,
        multires_dirs: int = 4,
        multires_pts: int = 6,
        dtype=torch.float32,
    ):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.multires_dirs, self.multires_pts = multires_dirs, multires_pts
        self.fc0 = Dense(in_ch, hidden, dtype=self.dtype)
        self.fc1 = Dense(hidden, hidden, dtype=self.dtype)
        self.alpha = Dense(hidden, 1, dtype=self.dtype)
        self.appearance = nn.Embedding(num_frames, appearance_dim)
        self.feature = Dense(hidden, hidden, dtype=self.dtype)
        c_in = hidden + appearance_dim + posenc_channels(3, multires_dirs) + posenc_channels(3, multires_pts)
        self.color_fc = Dense(c_in, hidden // 2, dtype=self.dtype)
        self.rgb = Dense(hidden // 2, 3, dtype=self.dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        flax_init_(self, generator)

    def forward(self, xyzc_feat, viewdirs, pts, frame_idx) -> Tuple[torch.Tensor, torch.Tensor]:
        """xyzc_feat [P, C], viewdirs [P, 3], pts [P, 3] (normalised to the
        person box), frame_idx [] -> (raw_rgb [P, 3], raw_sigma [P])."""
        dt = self.dtype
        h = F.relu(self.fc0(xyzc_feat))
        h = F.relu(self.fc1(h))
        sigma = self.alpha(h)[..., 0]
        app = frame_code(self.appearance, frame_idx, h.shape[0]).to(dt)
        venc, penc = posenc(viewdirs, self.multires_dirs).to(dt), posenc(pts, self.multires_pts).to(dt)
        c = torch.cat([self.feature(h), app, venc, penc], -1)
        rgb = self.rgb(F.relu(self.color_fc(c)))
        return rgb.float(), sigma.float()
