"""Cameras and rays of the traffic: the pinhole camera of NeRF's blender
scenes, the 40-pose orbit, Instant-NGP's change of axes, and the analytic
sphere whose images the training traffic writes. numpy only; the same
formulas as the NeRF code (``get_rays``, ``pose_spherical``), kept here so
that the traffic and the reference depend on nothing of the port.
"""

from __future__ import annotations

import math

import numpy as np

LEGO_CAMERA_ANGLE_X = 0.6911112070083618  # nerf_synthetic/lego transforms_train.json


def focal_of(W: int, camera_angle_x: float = LEGO_CAMERA_ANGLE_X) -> float:
    return 0.5 * W / math.tan(0.5 * camera_angle_x)


def intrinsics(H: int, W: int, focal: float) -> np.ndarray:
    return np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], dtype=np.float32)


def pixel_rays(K: np.ndarray, c2w: np.ndarray, rows: np.ndarray, cols: np.ndarray):
    """(rays_o, rays_d) [n, 3] f32 of the pixels (rows, cols): OpenGL camera
    (x right, y up, looking down -z), directions not normalised."""
    col, row = cols.astype(np.float32), rows.astype(np.float32)
    dirs = np.stack([(col - K[0, 2]) / K[0, 0], -(row - K[1, 2]) / K[1, 1], -np.ones_like(col)], axis=-1)
    d = np.einsum("nc,rc->nr", dirs, c2w[:3, :3]).astype(np.float32)
    o = np.broadcast_to(c2w[:3, 3].astype(np.float32), d.shape)
    return np.ascontiguousarray(o), d


def image_rays(H: int, W: int, K: np.ndarray, c2w: np.ndarray):
    """(rays_o, rays_d) [H * W, 3] of every pixel, row-major."""
    rows, cols = np.divmod(np.arange(H * W), W)
    return pixel_rays(K, c2w, rows, cols)


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Blender-style camera on a sphere around the origin (degrees)."""
    def trans(t):
        return np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]], np.float64)

    def rot_phi(a):
        return np.array([[1, 0, 0, 0], [0, math.cos(a), -math.sin(a), 0], [0, math.sin(a), math.cos(a), 0],
                         [0, 0, 0, 1]], np.float64)

    def rot_theta(a):
        return np.array([[math.cos(a), 0, -math.sin(a), 0], [0, 1, 0, 0], [math.sin(a), 0, math.cos(a), 0],
                         [0, 0, 0, 1]], np.float64)

    c2w = rot_theta(theta / 180.0 * math.pi) @ rot_phi(phi / 180.0 * math.pi) @ trans(radius)
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float64)
    return (flip @ c2w).astype(np.float32)


def orbit(n: int = 40, phi: float = -30.0, radius: float = 4.0) -> np.ndarray:
    """[n, 4, 4] the blender render path: n poses evenly around the object."""
    return np.stack([pose_spherical(th, phi, radius) for th in np.linspace(-180, 180, n + 1)[:-1]])


def sphere_poses(n: int, seed: int, radius: float = 4.0) -> np.ndarray:
    """[n, 4, 4] cameras at ``radius`` on the upper hemisphere, looking at the
    origin, drawn from ``seed``: a training set as blender's 100 views."""
    rng = np.random.RandomState(seed)
    theta = rng.uniform(-180.0, 180.0, n)
    phi = -np.degrees(np.arcsin(rng.uniform(0.0, 1.0, n)))
    return np.stack([pose_spherical(t, p, radius) for t, p in zip(theta, phi)])


def nerf2ngp(pose: np.ndarray, scale: float = 0.33, offset: float = 0.5) -> np.ndarray:
    """NeRF c2w -> Instant-NGP c2w: axes (x, y, z) -> (y, z, x), the
    translation scaled and offset so that the scene sits in the unit cube."""
    p = pose[:3].copy()[[1, 2, 0], :]
    p[:, 3] = p[:, 3] * scale + offset
    out = np.eye(4, dtype=np.float32)
    out[:3] = p
    return out


def sphere_rgba(o: np.ndarray, d: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """uint8 [n, 4] of the rays o + t d against a sphere at the origin
    coloured by its normal, transparent where the ray misses (the blender
    scene's RGBA convention)."""
    dn = d / np.linalg.norm(d, axis=-1, keepdims=True)
    b = np.sum(o * dn, axis=-1)
    c = np.sum(o * o, axis=-1) - radius**2
    disc = b * b - c
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit = (disc > 0) & (t > 0)
    n = (o + t[..., None] * dn) / radius
    rgba = np.zeros(o.shape[:-1] + (4,), np.float32)
    rgba[..., :3] = np.where(hit[..., None], np.clip(0.5 * (n + 1.0), 0.0, 1.0), 0.0)
    rgba[..., 3] = hit
    return (rgba * 255).astype(np.uint8)
