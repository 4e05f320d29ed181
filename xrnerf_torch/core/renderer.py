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
``"depth"`` for its depth map).

With a ``mesh`` (``parallel.mesh``), whole chunks go round-robin over the
data ranks, chunk c to data rank ``c % D``, and the results are gathered on
every rank: each chunk is rendered as one process renders it, so per-chunk
rules (KiloNeRF's capacity, Instant-NGP's sample budget) need nothing more
and the frame equals the one-process frame. The ranks of a model group
render the same chunks together. Every rank renders ``ceil(C / D)`` chunks
(a rank past the end repeats the last chunk, whose result is dropped).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..parallel import mesh as pm
from ..utils.spans import span


# A culled ray's fill per output: 1.0 rgb, 1e10 disp (an empty ray's 1 / 1e-10), 0 otherwise.
BACKGROUND = {"rgb": 1.0, "disp": 1e10}


def render_rays_chunked(
    model: torch.nn.Module,
    rays: Dict[str, np.ndarray],
    chunk: int = 8192,
    keys: tuple = ("rgb", "disp", "acc"),
    active_fn: Optional[Callable[[Dict[str, torch.Tensor]], torch.Tensor]] = None,
    mesh: Optional[pm.Mesh] = None,
) -> Dict[str, np.ndarray]:
    """Run ``model(chunk_batch, train=False)`` over [R, ...] rays;
    returns host numpy arrays of leading dim R.

    ``active_fn(rays on the device) -> [R] bool`` culls rays: the inactive
    ones are never rendered and get the ``BACKGROUND`` fill per key. It must
    be conservative (``kilonerf_strip_active`` proves a ray has no occupied
    sample). Active rays are compacted into full chunks (the last padded
    with the first active ray, whose extra renders are dropped); a fully
    culled frame renders one probe chunk to learn the outputs' shapes.
    Under a mesh the prepass runs on each rank's chunks, so ``active_fn``
    must give a chunk's rays the mask it gives them in the whole (the strip
    cull does for a chunk that is a multiple of its strip)."""
    with span("xrnerf_torch.render.image"):
        return _render_rays_chunked(model, rays, chunk, keys, active_fn, mesh)


def _render_rays_chunked(model, rays, chunk, keys, active_fn, mesh) -> Dict[str, np.ndarray]:
    device = next(model.parameters()).device
    with span("xrnerf_torch.render.pad"):
        ctx = {k: torch.from_numpy(np.require(v, requirements="C")).to(device)
               for k, v in rays.items() if k.startswith("ctx_") or np.ndim(v) == 0}
        ray_keys = {k: v for k, v in rays.items() if k not in ctx and k != "target"}
        n = next(iter(ray_keys.values())).shape[0]
        padded = pm.pad_to_multiple(ray_keys, chunk)
        total = next(iter(padded.values())).shape[0]

    def rays_of(part) -> Dict[str, torch.Tensor]:
        with span("xrnerf_torch.render.h2d"):
            return {k: torch.from_numpy(np.ascontiguousarray(v[part])).to(device) for k, v in padded.items()}

    def run(parts) -> Dict[str, list]:
        """Render each chunk's rays (a slice or an index array of ``chunk`` rays)."""
        return _spread(mesh, parts, lambda part: model({**rays_of(part), **ctx}, train=False), keys)

    if active_fn is not None:
        if mesh is None:
            act = active_fn(rays_of(slice(None)))
        else:
            parts = [slice(start, start + chunk) for start in range(0, total, chunk)]
            act = torch.cat(_spread(mesh, parts, lambda part: {"a": active_fn(rays_of(part))}, ("a",))["a"])
        idx = np.nonzero(act.cpu().numpy())[0]
        if idx.size < total:  # something culled: compact the active rays, fill the rest
            if idx.size == 0:
                probe = run([slice(0, chunk)])
                with span("xrnerf_torch.render.d2h"):
                    return {k: np.full((n, *v[0].shape[1:]), BACKGROUND.get(k, 0.0), v[0].cpu().numpy().dtype)
                            for k, v in probe.items() if v}
            sel_pad = (-idx.size) % chunk
            idxp = np.concatenate([idx, np.full(sel_pad, idx[0], np.int64)]) if sel_pad else idx
            outs = run(np.split(idxp, idxp.size // chunk))
            result = {}
            with span("xrnerf_torch.render.d2h"):
                for k, v in outs.items():
                    if not v:
                        continue
                    flat = torch.cat(v, dim=0)[: idx.size].cpu().numpy()
                    out = np.full((total, *flat.shape[1:]), BACKGROUND.get(k, 0.0), flat.dtype)
                    out[idx] = flat
                    result[k] = out[:n]
            return result

    outs = run([slice(start, start + chunk) for start in range(0, total, chunk)])
    with span("xrnerf_torch.render.d2h"):
        return {k: torch.cat(v, dim=0)[:n].cpu().numpy() for k, v in outs.items() if v}


def _spread(mesh: Optional[pm.Mesh], parts: list, fn: Callable, keys) -> Dict[str, list]:
    """{key: [fn(part)[key] for each part]}, without a mesh on this rank;
    with one, part c on data rank ``c % D`` and the results all-gathered.
    Keys that ``fn`` does not return are left out."""

    def keep(part) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in fn(part).items() if k in keys}

    if mesh is None or mesh.data_group is None:
        outs = [keep(p) for p in parts]
        return {k: [o[k] for o in outs] for k in keys if outs and k in outs[0]}
    D, d, n = mesh.data_size, mesh.data_rank, len(parts)
    per = -(-n // D)
    mine = [keep(parts[min(d + D * j, n - 1)]) for j in range(per)]
    got = {}
    for k in keys:
        if k in mine[0]:
            every = pm.all_gather_rows(torch.stack([o[k] for o in mine])[None], mesh.data_group)  # [D, per, ...]
            got[k] = [every[c % D, c // D] for c in range(n)]
    return got


def render_image(
    model: torch.nn.Module,
    rays: Dict[str, np.ndarray],
    H: int,
    W: int,
    chunk: int = 8192,
    keys: tuple = ("rgb", "disp", "acc"),
    mesh: Optional[pm.Mesh] = None,
) -> Dict[str, np.ndarray]:
    flat = render_rays_chunked(model, rays, chunk, keys, mesh=mesh)
    return {k: v.reshape(H, W, *v.shape[1:]) for k, v in flat.items()}
