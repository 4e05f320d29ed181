"""Linear blend skinning for Animatable NeRF — port of
``xrnerf_tpu/models/networks/utils/lbs.py``: the nearest SMPL vertex of
each point (brute force: one ``[P, V]`` distance tile from the matmul form
``|x|^2 - 2 x.v + |v|^2``, its argmin, then the exact distance of the
winner), Rodrigues' formula, forward kinematics to the joint transforms
``A``, and the blend-weighted transforms between posed and canonical space.

``closest_vertex`` builds its tile in place (one ``[P, V]`` f32 buffer:
7.2 GB at an eval chunk of 262,144 points and SMPL's 6,890 vertices);
``torch.argmin`` returns the first minimum, as ``jnp.argmin`` does.
``pose_to_tpose`` inverts with ``torch.linalg.inv_ex``, which, like
``jnp.linalg.inv``, neither checks for singular matrices on the host nor
raises.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def closest_vertex(pts: torch.Tensor, verts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """pts [P, 3], verts [V, 3] -> (nearest vertex index [P], squared distance [P])."""
    with torch.no_grad():
        d2 = pts @ verts.T
        d2.mul_(-2.0).add_(torch.sum(pts**2, -1, keepdim=True))  # |x|^2 - 2 x.v
        d2.add_(torch.sum(verts**2, -1)[None, :])
        idx = torch.argmin(d2, dim=-1)
        del d2
    # the matmul form cancels in f32 at small distances; the argmin holds but
    # the value does not, so the winner's distance is recomputed exactly
    return idx, torch.sum((pts - verts[idx]) ** 2, dim=-1)


def sample_blend_weights(pts, verts, vert_bw):
    """Nearest-vertex SMPL blend weights [P, J] and the distance [P] to it."""
    idx, d2 = closest_vertex(pts, verts)
    return vert_bw[idx], torch.sqrt(torch.clamp(d2, min=0.0))


def batch_rodrigues(rot_vecs: torch.Tensor) -> torch.Tensor:
    """[J, 3] axis-angle -> [J, 3, 3] rotations."""
    angle = torch.linalg.norm(rot_vecs + 1e-8, dim=-1, keepdim=True)
    axis = rot_vecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1).reshape(-1, 3, 3)
    eye = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)[None]
    return cos * eye + (1 - cos) * axis[..., :, None] * axis[..., None, :] + sin * K


def get_rigid_transformation(poses, joints, parents: Sequence[int]):
    """Forward kinematics: axis-angle poses [J, 3], rest joints [J, 3] and
    the kinematic tree -> [J, 4, 4] transforms ``A_k`` relative to the rest
    pose. The root's parent entry (``-1`` in SMPL's table) is never read.
    Takes and returns numpy arrays or tensors; the datasets call it on the
    host."""
    as_numpy = isinstance(poses, np.ndarray)
    poses, joints = torch.as_tensor(poses), torch.as_tensor(joints)
    parents = [int(p) for p in np.asarray(parents)]
    J = joints.shape[0]
    rots = batch_rodrigues(poses)
    rel_joints = torch.cat([joints[:1], joints[1:] - joints[parents[1:]]], dim=0)
    bottom = torch.tensor([0, 0, 0, 1.0], dtype=joints.dtype, device=joints.device).expand(J, 1, 4)
    mats = torch.cat([torch.cat([rots, rel_joints[:, :, None]], dim=-1), bottom], dim=1)  # [J, 4, 4]

    chains = [mats[0]]
    for k in range(1, J):
        chains.append(chains[parents[k]] @ mats[k])
    A = torch.stack(chains)  # posed joint transforms
    # subtract the rest-pose joint's contribution: A_k[:3, 3] -= R_k @ j_k
    corr = torch.einsum("jab,jb->ja", A[:, :3, :3], joints)
    A = torch.cat([A[:, :3, :3], (A[:, :3, 3] - corr)[..., None]], dim=-1)
    A = torch.cat([A, bottom], dim=1)
    return A.numpy() if as_numpy else A


def _blend(bw: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """sum_k w_k A_k per point: bw [P, J], A [J, 4, 4] -> [P, 4, 4]."""
    return torch.einsum("pj,jab->pab", bw, A)


def pose_to_tpose(pts: torch.Tensor, bw: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Posed points -> canonical: x_t = R^-1 (x - t) of M = sum_k w_k A_k."""
    M = _blend(bw, A)
    R_inv = torch.linalg.inv_ex(M[:, :3, :3]).inverse
    return torch.einsum("pab,pb->pa", R_inv, pts - M[:, :3, 3])


def tpose_to_pose(pts: torch.Tensor, bw: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Canonical points -> posed: x = M x_t of M = sum_k w_k A_k."""
    M = _blend(bw, A)
    return torch.einsum("pab,pb->pa", M[:, :3, :3], pts) + M[:, :3, 3]
