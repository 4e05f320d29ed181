"""Animatable NeRF dataset — port of ``xrnerf_tpu/datasets/aninerf.py``:
NeuralBody's data plus the skinning assets (joints, parents, per-vertex
blend weights, per-frame pose parameters). The per-frame joint transforms
``A`` [F, J, 4, 4] come from the port's ``get_rigid_transformation`` on the
host, and every batch and eval item carries ``ctx_A`` and
``ctx_bw_verts`` beside NeuralBody's context.

Layout (ZJU-MoCap / H36M style, on top of the NeuralBody layout):
  lbs/joints.npy [J,3], lbs/parents.npy [J], lbs/weights.npy [V,J],
  lbs/bigpose_vertices.npy [V,3]; params/{i}.npy with 'poses' [72].
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..models.networks.utils.lbs import get_rigid_transformation
from ..registry import DATASETS
from .neuralbody import NeuralBodyDataset


@DATASETS.register
class AniNeRFDataset(NeuralBodyDataset):
    def __init__(self, *args, arrays: Optional[Dict] = None, datadir=None, **kwargs):
        super().__init__(*args, arrays=arrays, datadir=datadir, **kwargs)
        if arrays is not None:
            self.joints = arrays["joints"].astype(np.float32)
            self.parents = np.asarray(arrays["parents"])
            self.weights = arrays["weights"].astype(np.float32)
            self.poses_aa = arrays["poses"].astype(np.float32)  # [F, J, 3]
            self.tpose_verts = arrays.get("tpose_verts", self.verts[0])
        else:
            lbs = os.path.join(datadir, "lbs")
            self.joints = np.load(os.path.join(lbs, "joints.npy")).astype(np.float32)
            self.parents = np.load(os.path.join(lbs, "parents.npy"))
            self.weights = np.load(os.path.join(lbs, "weights.npy")).astype(np.float32)
            tp = os.path.join(lbs, "bigpose_vertices.npy")
            self.tpose_verts = np.load(tp).astype(np.float32) if os.path.exists(tp) else self.verts[0]
            poses = []
            for i in range(self.n_frames):
                p = np.load(os.path.join(datadir, "params", f"{i}.npy"), allow_pickle=True).item()
                poses.append(np.asarray(p["poses"], np.float32).reshape(-1, 3))
            self.poses_aa = np.stack(poses)

        # per-frame joint transforms A [F, J, 4, 4]
        self.A = np.stack(
            [get_rigid_transformation(self.poses_aa[f], self.joints, self.parents) for f in range(self.n_frames)]
        ).astype(np.float32)

    def _ctx(self, frame):
        ctx = super()._ctx(frame)
        ctx["ctx_A"] = self.A[frame]
        ctx["ctx_bw_verts"] = self.weights
        return ctx
