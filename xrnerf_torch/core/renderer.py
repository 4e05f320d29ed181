"""Chunked full-image rendering for eval/test — port of
``xrnerf_tpu/core/renderer.py:render_rays_chunked/render_image``.

Rays are padded to a whole number of chunks by repeating the last ray, so
every call to the network sees the same shape; each chunk is moved to the
model's device, and the results stay there until one copy back to numpy at
the end. KiloNeRF's ``active_fn`` culling and multi-GPU meshes are not
ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def render_rays_chunked(
    model: torch.nn.Module,
    rays: Dict[str, np.ndarray],
    chunk: int = 8192,
    keys: tuple = ("rgb", "disp", "acc"),
) -> Dict[str, np.ndarray]:
    """Run ``model(chunk_batch, train=False)`` over [R, ...] rays;
    returns host numpy arrays of leading dim R."""
    device = next(model.parameters()).device
    ray_keys = {k: v for k, v in rays.items() if k != "target"}
    n = next(iter(ray_keys.values())).shape[0]
    n_pad = (-n) % chunk
    padded = {
        k: np.concatenate([v, np.repeat(v[-1:], n_pad, axis=0)], axis=0) if n_pad else v
        for k, v in ray_keys.items()
    }
    outs: Dict[str, list] = {k: [] for k in keys}
    for start in range(0, n + n_pad, chunk):
        cb = {
            k: torch.from_numpy(np.ascontiguousarray(v[start : start + chunk])).to(device)
            for k, v in padded.items()
        }
        ret = model(cb, train=False)
        for k in keys:
            if k in ret:
                outs[k].append(ret[k])
    return {k: torch.cat(v, dim=0)[:n].cpu().numpy() for k, v in outs.items() if v}


def render_image(
    model: torch.nn.Module,
    rays: Dict[str, np.ndarray],
    H: int,
    W: int,
    chunk: int = 8192,
    keys: tuple = ("rgb", "disp", "acc"),
) -> Dict[str, np.ndarray]:
    flat = render_rays_chunked(model, rays, chunk, keys)
    return {k: v.reshape(H, W, *v.shape[1:]) for k, v in flat.items()}
