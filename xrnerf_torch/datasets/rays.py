"""Host-side ray generation math (numpy) — a copy of
``xrnerf_tpu/datasets/rays.py``: pinhole rays, NDC, mip radii and the
spherical render-pose orbit. The port ships compact [N, 3] ray batches to
the card; sampling along rays happens there.
"""

from __future__ import annotations

import numpy as np


def get_rays_np(H: int, W: int, K: np.ndarray, c2w: np.ndarray):
    """Per-pixel rays for a pinhole camera.

    K: [3,3] intrinsics; c2w: [3,4] or [4,4] camera-to-world (OpenGL
    convention: x right, y up, z backwards — blender/NeRF standard).
    Returns rays_o, rays_d each [H, W, 3] (dirs NOT normalized, matching
    the reference so z_vals remain metric along -z).
    """
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy"
    )
    dirs = np.stack(
        [(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1], -np.ones_like(i)], axis=-1
    )
    rays_d = np.einsum("hwc,rc->hwr", dirs, c2w[:3, :3]).astype(np.float32)
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).astype(np.float32)
    return rays_o, rays_d


def get_ray_radii(rays_d: np.ndarray) -> np.ndarray:
    """Mip-NeRF base radius per pixel: distance between neighboring pixel
    ray dirs along x, scaled by 2/sqrt(12) (mip-NeRF convention).

    rays_d: [H, W, 3] -> radii [H, W, 1].
    """
    dx = np.sqrt(np.sum((rays_d[:, :-1, :] - rays_d[:, 1:, :]) ** 2, axis=-1))
    dx = np.concatenate([dx, dx[:, -2:-1]], axis=1)
    return (dx * 2.0 / np.sqrt(12.0))[..., None].astype(np.float32)


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o: np.ndarray, rays_d: np.ndarray):
    """Shift rays to the near plane and map to NDC space (llff forward-facing).

    Semantics of the reference's ``ToNDC`` transform (transforms.py:10-51).
    """
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = (
        -1.0
        / (W / (2.0 * focal))
        * (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    )
    d1 = (
        -1.0
        / (H / (2.0 * focal))
        * (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    )
    d2 = -2.0 * near / rays_o[..., 2]

    rays_o = np.stack([o0, o1, o2], -1).astype(np.float32)
    rays_d = np.stack([d0, d1, d2], -1).astype(np.float32)
    return rays_o, rays_d


# ---------------------------------------------------------------------------
# Novel-view pose synthesis
# ---------------------------------------------------------------------------

def _trans_t(t):
    return np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]], dtype=np.float32
    )


def _rot_phi(phi):
    return np.array(
        [
            [1, 0, 0, 0],
            [0, np.cos(phi), -np.sin(phi), 0],
            [0, np.sin(phi), np.cos(phi), 0],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def _rot_theta(th):
    return np.array(
        [
            [np.cos(th), 0, -np.sin(th), 0],
            [0, 1, 0, 0],
            [np.sin(th), 0, np.cos(th), 0],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Blender-style spherical camera pose (degrees)."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    c2w = (
        np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32)
        @ c2w
    )
    return c2w


def spherical_render_poses(n: int = 40, phi: float = -30.0, radius: float = 4.0) -> np.ndarray:
    """[n, 4, 4] orbit used for blender spiral videos."""
    return np.stack(
        [pose_spherical(th, phi, radius) for th in np.linspace(-180, 180, n + 1)[:-1]], 0
    )


def intrinsics_from_hwf(H: int, W: int, focal: float) -> np.ndarray:
    return np.array(
        [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], dtype=np.float32
    )


def flatten_image_rays(imgs: np.ndarray, poses: np.ndarray, H: int, W: int, K: np.ndarray):
    """Precompute a pooled ray dataset over all images.

    Returns dict of float32 arrays flattened to [N_img*H*W, ...]:
    rays_o, rays_d, rgb (and rgba if imgs has 4 channels).
    Reference analog: ``load_rays`` (get_rays.py).
    """
    all_o, all_d = [], []
    for p in poses:
        o, d = get_rays_np(H, W, K, p)
        all_o.append(o)
        all_d.append(d)
    rays_o = np.stack(all_o).reshape(-1, 3)
    rays_d = np.stack(all_d).reshape(-1, 3)
    out = {
        "rays_o": rays_o,
        "rays_d": rays_d,
        "target": imgs[..., :3].reshape(-1, 3).astype(np.float32),
    }
    if imgs.shape[-1] == 4:
        out["alpha"] = imgs[..., 3].reshape(-1, 1).astype(np.float32)
    return out
