"""Static-shape pillarization and voxelization.

Counterpart of pillarnext_tpu/ops/voxelize.py:22-115: the segment id of a
point is its linear dense grid index; padded and out-of-range points go to
the dump segment (``H * W`` for pillars, ``D * H * W`` for voxels).  Also
the two views of the MVF reader (``mvf_view_coords``,
pillarnext_tpu/models/mvf_encoder.py:196-243).

Every quotient by a grid constant divides by a 0-dim tensor on the
operand's device (``divide``): with a Python scalar divisor CUDA multiplies
by its reciprocal, which can differ from the quotient in the last bit and
put a point on a cell boundary into the neighbour cell.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class VoxelGrid(NamedTuple):
    """Static grid geometry, computed on the host from the config."""

    voxel_size: tuple
    pc_range: tuple
    size_x: int  # W
    size_y: int  # H
    size_z: int  # D (1 for pillars)

    @classmethod
    def create(cls, voxel_size, pc_range) -> "VoxelGrid":
        vs = np.asarray(voxel_size, np.float64)
        pr = np.asarray(pc_range, np.float64)
        gs = np.round((pr[3:] - pr[:3]) / vs).astype(np.int64)
        return cls(tuple(voxel_size), tuple(pc_range), int(gs[0]), int(gs[1]), int(gs[2]))

    @property
    def bev_shape(self) -> tuple[int, int]:
        return (self.size_y, self.size_x)

    @property
    def num_pillars(self) -> int:
        return self.size_y * self.size_x

    @property
    def num_voxels(self) -> int:
        return self.size_z * self.size_y * self.size_x


def divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d``, the true quotient on every device (``d`` as a 0-dim
    tensor of x's dtype on x's device)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _cell(grid: VoxelGrid, xyz: torch.Tensor, axis: int) -> torch.Tensor:
    """floor((xyz[:, axis] - origin) / voxel size) as int32."""
    return torch.floor(divide(xyz[:, axis] - grid.pc_range[axis], grid.voxel_size[axis])).to(torch.int32)


def pillar_coords(grid: VoxelGrid, xyz: torch.Tensor, valid: torch.Tensor):
    """(px, py) int32 pillar coords (clamped) and validity (input mask AND
    in range in x/y) for (N, 3) points."""
    px, py = _cell(grid, xyz, 0), _cell(grid, xyz, 1)
    in_range = (px >= 0) & (px < grid.size_x) & (py >= 0) & (py < grid.size_y)
    valid = valid & in_range
    return px.clamp(0, grid.size_x - 1), py.clamp(0, grid.size_y - 1), valid


def pillar_segment_ids(grid: VoxelGrid, px, py, valid) -> torch.Tensor:
    """Per-point segment id ``y * W + x``; invalid points -> ``H * W``."""
    sid = py * grid.size_x + px
    return torch.where(valid, sid, torch.full_like(sid, grid.num_pillars))


def voxel_coords(grid: VoxelGrid, xyz: torch.Tensor, valid: torch.Tensor):
    """(vx, vy, vz) int32 voxel coords (clamped) and validity (input mask
    AND in range in x, y and z) for (N, 3) points."""
    v = [_cell(grid, xyz, i) for i in range(3)]
    sizes = (grid.size_x, grid.size_y, grid.size_z)
    for c, n in zip(v, sizes):
        valid = valid & (c >= 0) & (c < n)
    return (*(c.clamp(0, n - 1) for c, n in zip(v, sizes)), valid)


def voxel_segment_ids(grid: VoxelGrid, vx, vy, vz, valid) -> torch.Tensor:
    """Per-point segment id ``(z * H + y) * W + x``; invalid points ->
    ``D * H * W``."""
    sid = (vz * grid.size_y + vy) * grid.size_x + vx
    return torch.where(valid, sid, torch.full_like(sid, grid.num_voxels))


class ViewCoords(NamedTuple):
    """One MVF view of N points: clamped int32 cells ``u`` (columns) and
    ``v`` (rows), and the fractional cell positions ``fu``, ``fv`` the
    bilinear readback samples at."""

    u: torch.Tensor
    v: torch.Tensor
    fu: torch.Tensor
    fv: torch.Tensor


def _view(grid: VoxelGrid, a: torch.Tensor, b: torch.Tensor) -> ViewCoords:
    fu = divide(a - grid.pc_range[0], grid.voxel_size[0])
    fv = divide(b - grid.pc_range[1], grid.voxel_size[1])
    u = torch.floor(fu).to(torch.int32).clamp(0, grid.size_x - 1)
    v = torch.floor(fv).to(torch.int32).clamp(0, grid.size_y - 1)
    return ViewCoords(u, v, fu, fv)


def mvf_view_coords(pillar: VoxelGrid, cylinder: VoxelGrid, xyz: torch.Tensor, valid: torch.Tensor):
    """MVF's two views of (N, 3) f32 points (mvf_encoder.py:196-243).

    Returns (validity: the input mask AND the full 3-D range of
    ``pillar.pc_range`` on the raw coordinates; the pillar view over
    (x, y); the cylinder view over (phi, z); the (N, 3) cylinder position
    [phi, z, rho]).  phi = atan2(y, x) / pi * 180 in degrees, rho the
    distance from the z axis.  Both views clamp their cells into the grid,
    unlike ``pillar_coords``, which masks by cell."""
    pr = pillar.pc_range
    for axis in range(3):
        valid = valid & (xyz[:, axis] >= pr[axis]) & (xyz[:, axis] < pr[axis + 3])
    x, y, z = xyz.unbind(1)
    phi = divide(torch.atan2(y, x), math.pi) * 180.0
    rho = torch.sqrt(x * x + y * y)
    return valid, _view(pillar, x, y), _view(cylinder, phi, z), torch.stack([phi, z, rho], dim=-1)
