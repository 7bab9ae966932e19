"""Static-shape pillarization.

Counterpart of pillarnext_tpu/ops/voxelize.py:22-79: the segment id of a
point is its linear dense grid index; padded and out-of-range points go to
the dump segment ``H * W``.
"""

from __future__ import annotations

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


def pillar_coords(grid: VoxelGrid, xyz: torch.Tensor, valid: torch.Tensor):
    """(px, py) int32 pillar coords (clamped) and validity (input mask AND
    in range in x/y) for (N, 3) points.  The grid's constants enter as
    Python scalars (the same f32 arithmetic as constant tensors), so no
    host-to-device copy waits for the card."""
    px = torch.floor((xyz[:, 0] - grid.pc_range[0]) / grid.voxel_size[0]).to(torch.int32)
    py = torch.floor((xyz[:, 1] - grid.pc_range[1]) / grid.voxel_size[1]).to(torch.int32)
    in_range = (px >= 0) & (px < grid.size_x) & (py >= 0) & (py < grid.size_y)
    valid = valid & in_range
    return px.clamp(0, grid.size_x - 1), py.clamp(0, grid.size_y - 1), valid


def pillar_segment_ids(grid: VoxelGrid, px, py, valid) -> torch.Tensor:
    """Per-point segment id ``y * W + x``; invalid points -> ``H * W``."""
    sid = py * grid.size_x + px
    return torch.where(valid, sid, torch.full_like(sid, grid.num_pillars))
