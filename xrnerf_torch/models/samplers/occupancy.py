"""Instant-NGP occupancy-grid subsystem — port of
``xrnerf_tpu/models/samplers/occupancy.py``.

The grid is an immutable pair of tensors (:class:`OccupancyGrid`); every
function returns a new one. Cells are indexed in raster order
``x + R*(y + R*z)``. The max-splat is a ``scatter_reduce("amax")``. All
ops keep static shapes and make no device-to-host copy, so a refresh on the
card does not stall the host.

:func:`generate_grid_samples` draws from a ``torch.Generator``; its
``draws`` argument takes the random numbers from the caller instead
(:class:`GridDraws`), which is how the tests feed both packages the same
ones.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

GRID_RES = 128
_CAMERA_CHUNK = 8  # cameras per pass of mark_untrained_cells


class OccupancyGrid(NamedTuple):
    """Density grid state for one or more cascades.

    density: [C, R^3] float32 EMA density per cell (-1 marks untrained)
    bitfield: [C, R^3] bool occupancy
    """

    density: torch.Tensor
    bitfield: torch.Tensor

    @property
    def n_cascades(self) -> int:
        return self.density.shape[0]


class GridDraws(NamedTuple):
    """The random numbers of one :func:`generate_grid_samples` call."""

    uni_cells: torch.Tensor  # [n_uniform] int64 in [0, C * R^3)
    rank: torch.Tensor  # [n_biased] int64 in [1, max(occupied cells, 1)]
    fallback_cells: torch.Tensor  # [n_biased] int64 in [0, C * R^3)
    jitter: torch.Tensor  # [n_uniform + n_biased, 3] float32 in [0, 1)


def create_grid(n_cascades: int = 1, res: int = GRID_RES, device=None) -> OccupancyGrid:
    n = res**3
    return OccupancyGrid(
        density=torch.zeros((n_cascades, n), dtype=torch.float32, device=device),
        bitfield=torch.ones((n_cascades, n), dtype=torch.bool, device=device),
    )


def _exp2(cascade: torch.Tensor) -> torch.Tensor:
    return torch.exp2(cascade.float())


def cell_centers(cell_idx: torch.Tensor, cascade: torch.Tensor, res: int = GRID_RES) -> torch.Tensor:
    """Raster cell index -> center position in [0,1]^3 scaled by cascade
    (cascade c covers a box of side 2^c centered at 0.5)."""
    x = cell_idx % res
    y = (cell_idx // res) % res
    z = cell_idx // (res * res)
    pos01 = (torch.stack([x, y, z], -1).float() + 0.5) / res
    return (pos01 - 0.5) * _exp2(cascade)[..., None] + 0.5


def pos_to_cell(pos: torch.Tensor, cascade: torch.Tensor, res: int = GRID_RES) -> Tuple[torch.Tensor, torch.Tensor]:
    """Position -> (cell index [...] int64, in-bounds mask [...]) for given cascade."""
    pos01 = (pos - 0.5) / _exp2(cascade)[..., None] + 0.5
    xi = torch.floor(pos01 * res).long()
    inb = ((xi >= 0) & (xi < res)).all(dim=-1)
    xi = xi.clamp(0, res - 1)
    return xi[..., 0] + res * (xi[..., 1] + res * xi[..., 2]), inb


def mark_untrained_cells(
    grid: OccupancyGrid,
    poses: np.ndarray,  # [M, 4, 4] or [M, 3, 4] c2w in grid coords
    focal: float,
    H: int,
    W: int,
    res: int = GRID_RES,
) -> OccupancyGrid:
    """Set density = -1 for cells outside every training camera frustum
    (set-up time only). Cameras are taken a few at a time to bound the
    [M, R^3, 3] temporaries."""
    dev = grid.density.device
    n = res**3
    cell_idx = torch.arange(n, device=dev)
    poses_t = torch.as_tensor(np.asarray(poses, np.float32), device=dev)
    eps = 1e-6
    out = []
    for c in range(grid.n_cascades):
        centers = cell_centers(cell_idx, torch.full((n,), c, device=dev), res)  # [n, 3]
        seen = torch.zeros(n, dtype=torch.bool, device=dev)
        for m0 in range(0, poses_t.shape[0], _CAMERA_CHUNK):
            R = poses_t[m0 : m0 + _CAMERA_CHUNK, :3, :3]  # [m, 3, 3]
            t = poses_t[m0 : m0 + _CAMERA_CHUNK, :3, 3]  # [m, 3]
            # world -> camera: p_cam = R^T (p - t)
            cam = torch.einsum("mij,mnj->mni", R.transpose(1, 2), centers[None] - t[:, None])
            # OpenGL convention: visible if z_cam < 0 and |x/z| < W/2f, |y/z| < H/2f
            z = -cam[..., 2]
            zc = z.clamp(min=eps)
            visible = (
                (z > eps)
                & ((cam[..., 0] / zc).abs() < 0.5 * W / focal + 0.5 / res)
                & ((cam[..., 1] / zc).abs() < 0.5 * H / focal + 0.5 / res)
            )
            seen |= visible.any(dim=0)
        out.append(torch.where(seen, grid.density[c], -1.0))
    return grid._replace(density=torch.stack(out))


def draw_grid_samples(
    generator: Optional[torch.Generator], grid: OccupancyGrid, n_uniform: int, n_biased: int,
    threshold: float, res: int = GRID_RES,
) -> GridDraws:
    """The random numbers :func:`generate_grid_samples` needs, drawn on the
    grid's device (no device-to-host copy: the rank's range is a device scalar)."""
    dev = grid.density.device
    total_cells = grid.n_cascades * res**3
    occupied = (grid.density.reshape(-1) > threshold).sum().clamp(min=1)
    u = torch.rand(n_biased, generator=generator, dtype=torch.float64, device=dev)
    rank = torch.minimum((u * occupied).long() + 1, occupied)
    return GridDraws(
        uni_cells=torch.randint(0, total_cells, (n_uniform,), generator=generator, device=dev),
        rank=rank,
        fallback_cells=torch.randint(0, total_cells, (n_biased,), generator=generator, device=dev),
        jitter=torch.rand((n_uniform + n_biased, 3), generator=generator, device=dev),
    )


def biased_cells(density: torch.Tensor, threshold: float, rank: torch.Tensor, fallback_cells: torch.Tensor) -> torch.Tensor:
    """The ``rank``-th cell (1-based) with density above ``threshold``, by
    inverting the indicator's integer CDF; ``fallback_cells`` when no cell is."""
    flat = density.reshape(-1)
    cdf = torch.cumsum((flat > threshold).long(), dim=0)
    cells = torch.searchsorted(cdf, rank, right=False).clamp(0, flat.shape[0] - 1)
    return torch.where(cdf[-1] > 0, cells, fallback_cells)


def generate_grid_samples(
    generator: Optional[torch.Generator],
    grid: OccupancyGrid,
    n_uniform: int,
    n_biased: int,
    threshold: float,
    res: int = GRID_RES,
    draws: Optional[GridDraws] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Candidate cells for the density update: ``n_uniform`` uniform over all
    cells, ``n_biased`` uniform over the cells above ``threshold``, each
    jittered within its cell. Returns (pos [M, 3], cascade [M], cell_idx [M])."""
    n = res**3
    if draws is None:
        draws = draw_grid_samples(generator, grid, n_uniform, n_biased, threshold, res)
    bia_cells = biased_cells(grid.density, threshold, draws.rank, draws.fallback_cells)
    cells = torch.cat([draws.uni_cells, bia_cells])
    cascade = cells // n
    cell_idx = cells % n
    centers = cell_centers(cell_idx, cascade, res)
    jitter = (draws.jitter - 0.5) / res * _exp2(cascade)[:, None]
    return centers + jitter, cascade, cell_idx


def splat_density(
    grid: OccupancyGrid,
    cascade: torch.Tensor,  # [M]
    cell_idx: torch.Tensor,  # [M]
    density: torch.Tensor,  # [M] MLP densities at sampled positions
    decay: float = 0.95,
    res: int = GRID_RES,
) -> OccupancyGrid:
    """max-splat new densities then EMA: grid = max(grid * decay, splat),
    skipping untrained (-1) cells."""
    flat = grid.density.reshape(-1)
    gidx = cascade * res**3 + cell_idx
    splat = (flat * decay).scatter_reduce(0, gidx, density.to(flat.dtype), "amax", include_self=True)
    new = torch.where(flat < 0, flat, splat)
    return grid._replace(density=new.reshape(grid.density.shape))


def update_bitfield(grid: OccupancyGrid, threshold: float = 0.01, res: int = GRID_RES) -> OccupancyGrid:
    """occupied = density > min(mean density over trained cells, threshold)."""
    valid = grid.density >= 0
    mean = torch.where(valid, grid.density, 0.0).sum() / valid.sum().clamp(min=1)
    thresh = mean.clamp(max=threshold)
    return grid._replace(bitfield=(grid.density > thresh) & valid)


def occupied_at(grid: OccupancyGrid, pos: torch.Tensor, cascade: torch.Tensor, res: int = GRID_RES) -> torch.Tensor:
    """Bitfield lookup at positions."""
    idx, inb = pos_to_cell(pos, cascade, res)
    gidx = cascade.clamp(0, grid.n_cascades - 1) * res**3 + idx
    return grid.bitfield.reshape(-1)[gidx] & inb
