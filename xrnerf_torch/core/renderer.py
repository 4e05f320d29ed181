"""Chunked full-image rendering for eval/test — port of
``xrnerf_tpu/core/renderer.py:render_rays_chunked/render_image``.

Rays are padded to a whole number of chunks by repeating the last ray, so
every call to the network sees the same shape; each chunk is moved to the
model's device, and the results stay there until one copy back to numpy at
the end. Keys that start with ``ctx_``, and 0-d arrays, are context shared by
every chunk (NeuralBody's SMPL vertices and bounds, a frame index, Bungee's
stage): they go to the device once per image, are never padded or chunked,
and are merged into every chunk's batch. ``keys`` names the outputs to keep;
one that the network does not return is left out of the result (``HashNerfNetwork`` returns ``depth``
and no ``disp``, so the default keys give its ``rgb`` and ``acc``; pass
``"depth"`` for its depth map). Multi-GPU meshes are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch


# A culled ray's fill per output: 1.0 rgb, 1e10 disp (an empty ray's 1 / 1e-10), 0 otherwise.
BACKGROUND = {"rgb": 1.0, "disp": 1e10}


def render_rays_chunked(
    model: torch.nn.Module,
    rays: Dict[str, np.ndarray],
    chunk: int = 8192,
    keys: tuple = ("rgb", "disp", "acc"),
    active_fn: Optional[Callable[[Dict[str, torch.Tensor]], torch.Tensor]] = None,
) -> Dict[str, np.ndarray]:
    """Run ``model(chunk_batch, train=False)`` over [R, ...] rays;
    returns host numpy arrays of leading dim R.

    ``active_fn(rays on the device) -> [R] bool`` culls rays: the inactive
    ones are never rendered and get the ``BACKGROUND`` fill per key. It must
    be conservative (``kilonerf_strip_active`` proves a ray has no occupied
    sample). Active rays are compacted into full chunks (the last padded
    with the first active ray, whose extra renders are dropped); a fully
    culled frame renders one probe chunk to learn the outputs' shapes."""
    device = next(model.parameters()).device
    ctx = {k: torch.from_numpy(np.require(v, requirements="C")).to(device)
           for k, v in rays.items() if k.startswith("ctx_") or np.ndim(v) == 0}
    ray_keys = {k: v for k, v in rays.items() if k not in ctx and k != "target"}
    n = next(iter(ray_keys.values())).shape[0]
    n_pad = (-n) % chunk
    padded = {
        k: np.concatenate([v, np.repeat(v[-1:], n_pad, axis=0)], axis=0) if n_pad else v
        for k, v in ray_keys.items()
    }
    total = n + n_pad

    def run(parts) -> Dict[str, list]:
        """Render each chunk's rays (a slice or an index array of ``chunk`` rays)."""
        outs: Dict[str, list] = {k: [] for k in keys}
        for part in parts:
            cb = {k: torch.from_numpy(np.ascontiguousarray(v[part])).to(device) for k, v in padded.items()}
            ret = model({**cb, **ctx}, train=False)
            for k in keys:
                if k in ret:
                    outs[k].append(ret[k])
        return outs

    if active_fn is not None:
        act = active_fn({k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in padded.items()})
        idx = np.nonzero(act.cpu().numpy())[0]
        if idx.size < total:  # something culled: compact the active rays, fill the rest
            if idx.size == 0:
                probe = run([slice(0, chunk)])
                return {k: np.full((n, *v[0].shape[1:]), BACKGROUND.get(k, 0.0), v[0].cpu().numpy().dtype)
                        for k, v in probe.items() if v}
            sel_pad = (-idx.size) % chunk
            idxp = np.concatenate([idx, np.full(sel_pad, idx[0], np.int64)]) if sel_pad else idx
            result = {}
            for k, v in run(np.split(idxp, idxp.size // chunk)).items():
                if not v:
                    continue
                flat = torch.cat(v, dim=0)[: idx.size].cpu().numpy()
                out = np.full((total, *flat.shape[1:]), BACKGROUND.get(k, 0.0), flat.dtype)
                out[idx] = flat
                result[k] = out[:n]
            return result

    outs = run([slice(start, start + chunk) for start in range(0, total, chunk)])
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
