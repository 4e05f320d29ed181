"""GNR rendering: projection, pixel-aligned sampling, visual hull,
compositing and mesh reconstruction — port of
``xrnerf_tpu/models/renders/gnr_render.py``.

Feature maps are NCHW ([V, C, H, W], the encoder's layout), so the
pixel-aligned lookup is ``F.grid_sample`` (``align_corners=False``, zero
padding; ``nearest`` rounds half to even), the function the JAX code writes
out by hand. Every sample point is evaluated and hull-rejected points get
sigma = -1e4, as in the JAX code (no compaction unless the network's
``vh_compact_frac`` asks for it). Ray generation is host-side numpy.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .volume import exclusive_cumprod


# ---------------------------------------------------------------------------
# grid_sample + projections
# ---------------------------------------------------------------------------
def grid_sample_2d(feat: torch.Tensor, uv: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    """[C, H, W] features at [N, 2] uv in [-1, 1] (x, y) -> [N, C]."""
    return index_views(feat[None], uv[None], mode)[0]


def index_views(feats: torch.Tensor, uv: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    """[V, C, H, W] features at [V, N, 2] uv -> [V, N, C] (the reference's ``index``)."""
    out = F.grid_sample(feats, uv[:, None], mode=mode, padding_mode="zeros", align_corners=False)
    return out[:, :, 0].transpose(1, 2)


def orthogonal_project(points: torch.Tensor, calibs: torch.Tensor) -> torch.Tensor:
    """[N, 3] world points through [V, 4, 4] orthographic calibs -> [V, N, 3]."""
    return torch.einsum("vab,nb->vna", calibs[:, :3, :3], points) + calibs[:, None, :3, 3]


def perspective_project(points: torch.Tensor, w2c: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """-> [V, N, 3]: pixel xy and camera depth z; ``cam`` [V, >=6] is
    fx fy cx cy [k1 k2 p1 p2 k3] near far."""
    p = torch.einsum("vab,nb->vna", w2c[:, :3, :3], points) + w2c[:, None, :3, 3]
    z = torch.clamp(p[..., 2], min=1e-9)
    xy = p[..., :2] / z[..., None]
    if cam.shape[1] > 6:
        x, y = xy[..., 0], xy[..., 1]
        x2, y2, xy_ = x * x, y * y, x * y
        r2 = x2 + y2
        k1, k2, p1, p2, k3 = (cam[:, i, None] for i in range(4, 9))
        c = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = c * x + p1 * 2 * xy_ + p2 * (r2 + 2 * x2)
        yd = c * y + p2 * 2 * xy_ + p1 * (r2 + 2 * y2)
        xy = torch.stack([xd, yd], -1)
    xy = cam[:, None, 0:2] * xy + cam[:, None, 2:4]
    return torch.cat([xy, p[..., 2:3]], -1)


# ---------------------------------------------------------------------------
# Host-side ray-segment generation (numpy; dataset path)
# ---------------------------------------------------------------------------
def rays_orthogonal_np(pix, calib, H, W):
    """Ray segments (start, end) of orthographic cameras at pixels [N, 2]
    (x, y), clipped to a sphere in z (get_rays_orthogonal)."""
    cy, cx, focal = H / 2.0, W / 2.0, H / 2.0
    x = (pix[:, 0] - cx) / focal
    y = (pix[:, 1] - cy) / focal
    radian = np.max(np.sqrt(x * x + y * y)) + 1e-3
    z = np.sqrt(np.maximum(radian**2 - x * x, 1e-9))
    starts = np.stack([x, y, z], -1)
    ends = np.stack([x, y, -z], -1)
    c2w = np.linalg.inv(calib)
    R, t = c2w[:3, :3], c2w[:3, 3]
    return (starts @ R.T + t).astype(np.float32), (ends @ R.T + t).astype(np.float32)


def rays_perspective_np(pix, w2c, cam):
    """Ray segments of perspective cameras: pixels unprojected to the near
    and far planes, undistorted when ``cam`` holds distortion
    (get_rays_perspective)."""
    fx, fy, cx, cy = cam[0], cam[1], cam[2], cam[3]
    near, far = cam[-2], cam[-1]
    x = (pix[:, 0] - cx) / fx
    y = (pix[:, 1] - cy) / fy
    if len(cam) > 6:
        xp, yp = x.copy(), y.copy()
        for _ in range(3):
            x2, y2, xy = x * x, y * y, x * y
            r2 = x2 + y2
            c = 1 + r2 * (cam[4] + r2 * (cam[5] + r2 * cam[8]))
            x = (xp - cam[6] * 2 * xy - cam[7] * (r2 + 2 * x2)) / (c + 1e-9)
            y = (yp - cam[7] * 2 * xy - cam[6] * (r2 + 2 * y2)) / (c + 1e-9)
    starts = np.stack([x * near, y * near, np.full_like(x, near)], -1)
    ends = np.stack([x * far, y * far, np.full_like(x, far)], -1)
    c2w = np.linalg.inv(w2c)
    R, t = c2w[:3, :3], c2w[:3, 3]
    return (starts @ R.T + t).astype(np.float32), (ends @ R.T + t).astype(np.float32)


# ---------------------------------------------------------------------------
# Render building blocks
# ---------------------------------------------------------------------------
def sample_segment(
    rays_s: torch.Tensor, rays_e: torch.Tensor, n_samples: int,
    generator: Optional[torch.Generator] = None, jitter: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (pts [R, S, 3], t [R, S]): t = 0 at the start, 1 at the end,
    jittered by U(-0.5, 0.5) / (S - 1) when a ``generator`` (or an injected
    ``jitter`` [R, S] of U(0, 1) draws) is given. The arithmetic is the
    jitted JAX code's: XLA divides by the constant S - 1 through its
    reciprocal and contracts ``rays_e * t + rays_s * (1 - t)`` to
    ``fma(e, t, s * (1 - t))``; ``torch.add``'s alpha and ``addcmul`` are
    those FMAs."""
    R = rays_s.shape[0]
    # jnp.linspace's f32 values: i * fl(1 / (S - 1))
    t = (torch.arange(n_samples, device=rays_s.device, dtype=torch.float32) * (1.0 / max(n_samples - 1, 1))).expand(
        R, n_samples)
    if jitter is None and generator is not None:
        jitter = torch.rand((R, n_samples), generator=generator, device=rays_s.device)
    if jitter is not None:  # fma(u - 0.5, fl(1 / (S - 1)), t), XLA's form of t + (u - 0.5) / (S - 1)
        t = torch.add(t, jitter - 0.5, alpha=1.0 / (n_samples - 1))
    tt = t[..., None]
    pts = torch.addcmul(rays_s[:, None] * (1 - tt), rays_e[:, None], tt)
    return pts, t


def _uv_pixels(xyz: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Pixel xy -> grid_sample's [-1, 1] (no tensor is made, so no host copy)."""
    return torch.stack([xyz[..., 0] / width, xyz[..., 1] / height], -1) * 2.0 - 1.0


def visual_hull_mask(pts, masks, calibs, persps, width: int, height: int) -> torch.Tensor:
    """A point is kept iff its projection lands in every view's mask
    (inside_pts_vh): pts [P, 3], masks [V, H, W] -> bool [P]."""
    if persps is not None:
        uv = _uv_pixels(perspective_project(pts, calibs, persps), width, height)
    else:
        uv = orthogonal_project(pts, calibs)[..., :2]
    m = index_views(masks[:, None], uv, mode="nearest")[..., 0]  # [V, P]
    return torch.prod(m, 0) > 0


def smpl_visibility(pts, smpl_depth, calibs, persps, width: int, height: int) -> torch.Tensor:
    """Per-view visibility: point depth <= the rasterised SMPL depth at its
    footprint -> [P, V] float."""
    xyz = perspective_project(pts, calibs, persps)
    d_smpl = index_views(smpl_depth[:, None], _uv_pixels(xyz, width, height), mode="nearest")[..., 0]  # [V, P]
    vis = ((xyz[..., 2] - d_smpl) <= 0) & (d_smpl > 0)
    return vis.T.float()


def composite_gnr(
    rgb_raw: torch.Tensor,  # [R, S, 3]
    sigma_raw: torch.Tensor,  # [R, S]
    t_vals: torch.Tensor,  # [R, S]
    norm: torch.Tensor,  # [R, 1]
    generator: Optional[torch.Generator] = None,
    att: Optional[torch.Tensor] = None,  # [R, S, V + 1]
    source_rgb: Optional[torch.Tensor] = None,  # [R, S, V, 3]
    white_bkgd: bool = False,
    noise: Optional[torch.Tensor] = None,  # [R, S] injected N(0, 1) draws
) -> Dict[str, torch.Tensor]:
    """make_nerf_output: sigmoid rgb, N(0, 1) density noise in training
    (from ``generator``, or ``noise``), relu density, alpha compositing;
    with attention, a second map blending (self + source views) by it."""
    dists = t_vals[..., 1:] - t_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1) * norm
    rgb = torch.sigmoid(rgb_raw)
    if noise is None and generator is not None:
        noise = torch.randn(sigma_raw.shape, generator=generator, device=sigma_raw.device)
    alpha = 1.0 - torch.exp(-F.relu(sigma_raw + noise if noise is not None else sigma_raw))
    weights = alpha * exclusive_cumprod(1.0 - alpha + 1e-10)  # cumprod([1, 1 - alpha + 1e-10])[:-1], no host sync
    acc = weights.sum(-1)
    out = {"rgb": (weights[..., None] * rgb).sum(-2), "weights": weights, "acc": acc, "alpha": alpha}
    if att is not None and source_rgb is not None:
        cand = torch.cat([rgb[..., None, :], source_rgb], -2)  # [R, S, V + 1, 3]
        blend = (cand * att[..., None]).sum(-2)
        att_rgb = (weights[..., None] * blend).sum(-2)
        if white_bkgd:
            att_rgb = att_rgb + (1.0 - acc[..., None])
        out["att_rgb"] = att_rgb
    if white_bkgd:
        out["rgb"] = out["rgb"] + (1.0 - acc[..., None])
    return out


# ---------------------------------------------------------------------------
# Host-side mesh reconstruction driver (the reference's reconstruct)
# ---------------------------------------------------------------------------
def reconstruct_gnr(
    density_fn: Callable[[torch.Tensor], torch.Tensor],  # pts [P, 3] -> occupancy [P] in [0, 1]
    color_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],  # (pts, normals) -> rgb [P, 3]
    center: np.ndarray,
    spatial_freq: float,
    load_size: int = 512,
    n_grid: int = 128,
    threshold: float = 0.5,
    chunk: int = 65536,
    laplacian: int = 3,
    device="cpu",
):
    """Dense density sweep -> marching tetrahedra -> Laplacian smoothing ->
    vertex colours. ``density_fn`` and ``color_fn`` are called on ``device``
    (the network's) in chunks, the colours over a whole number of chunks
    when there are more vertices than one chunk (the last vertex repeated).

    Returns (verts [V, 3] world, faces [T, 3], rgbs [V, 3])."""
    from ...ops.marching import laplacian_smooth, marching_tetrahedra, vertex_normals

    device = torch.device(device)
    half = load_size / 2.0
    lin = np.linspace(-half, half, n_grid, dtype=np.float32)
    grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    pts = grid.reshape(-1, 3) / spatial_freq + np.asarray(center)

    with torch.inference_mode():
        occ = torch.cat([density_fn(torch.from_numpy(np.ascontiguousarray(pts[i:i + chunk], np.float32)).to(device))
                         for i in range(0, len(pts), chunk)]).cpu().numpy().reshape(n_grid, n_grid, n_grid)

    verts_idx, faces = marching_tetrahedra(occ, level=threshold)
    if len(verts_idx) == 0:
        return verts_idx, faces, np.zeros((0, 3), np.float32)
    # index coords -> normalised body coords -> world
    verts = (verts_idx / (n_grid - 1) * 2.0 - 1.0) * half
    verts = verts / spatial_freq + np.asarray(center)
    if laplacian > 0:
        verts = laplacian_smooth(verts.astype(np.float32), faces, laplacian)

    normals = vertex_normals(verts.astype(np.float32), faces)
    n = len(verts)
    pad = (-n) % chunk if n > chunk else 0
    v_in = np.concatenate([verts, verts[-1:].repeat(pad, 0)]) if pad else verts
    n_in = np.concatenate([normals, normals[-1:].repeat(pad, 0)]) if pad else normals
    rgbs = []
    with torch.inference_mode():
        for i in range(0, len(v_in), chunk):
            rgbs.append(color_fn(torch.from_numpy(np.ascontiguousarray(v_in[i:i + chunk], np.float32)).to(device),
                                 torch.from_numpy(np.ascontiguousarray(n_in[i:i + chunk], np.float32)).to(device)))
    rgbs = torch.cat(rgbs).cpu().numpy()[:n]
    return verts.astype(np.float32), faces, rgbs
