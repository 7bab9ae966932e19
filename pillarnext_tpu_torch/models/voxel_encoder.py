"""Voxel reader: 3-D voxelization with a per-voxel mean.

Counterpart of ``VoxelFeatureNet`` (pillarnext_tpu/models/voxel_encoder.py:27-81)
with ``output="sparse"``: every point gets a compact slot by its linear
voxel id (one stable sort, ops/compact.py), the table holds the f32 mean of
each voxel's raw point features cast to the model dtype, and the result is
a SparseBEV over the (D, H, W) grid for the sparse 3-D backbone.  The
reader has no parameters.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pillarnext_tpu_torch.ops import scatter
from pillarnext_tpu_torch.ops.compact import compactify, invert_slot_map
from pillarnext_tpu_torch.ops.sparse_bev import SparseBEV
from pillarnext_tpu_torch.ops.voxelize import VoxelGrid, voxel_coords, voxel_segment_ids


class VoxelFeatureNet(nn.Module):
    """Points (B, N, D) + mask (B, N) -> SparseBEV over (D, H, W) voxels."""

    def __init__(
        self,
        voxel_size: Sequence[float],
        pc_range: Sequence[float],
        num_input_features: int = 5,
        output: str = "dense",
        voxel_capacity: int = 262144,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        if output != "sparse":
            raise NotImplementedError(
                f"VoxelFeatureNet output={output!r} (the dense voxel volume) not ported yet, "
                "see ROADMAP"
            )
        self.num_input_features = num_input_features
        self.grid = VoxelGrid.create(voxel_size, pc_range)
        self.voxel_capacity = int(voxel_capacity)
        self.output = output
        self.dtype = dtype

    @property
    def capacity(self) -> int:
        """Compact slots per sample at the largest serving bucket."""
        return self.voxel_capacity

    def forward(self, points, mask, capacity: int | None = None, telemetry=None, plain=False):
        """``capacity`` overrides ``voxel_capacity`` (serving buckets);
        ``telemetry`` (a dict) receives the occupied-voxel count and the
        overflow as device scalars.  ``plain`` is accepted for the
        detector's reader signature: the reader launches no kernel."""
        grid = self.grid
        b, n, d = points.shape
        if d != self.num_input_features:
            raise ValueError(f"points have {d} features, expected {self.num_input_features}")
        nvox = grid.num_voxels
        cap = min((capacity or self.voxel_capacity) * b, nvox * b)

        xyz = points[..., :3].reshape(-1, 3)
        vx, vy, vz, flat_valid = voxel_coords(grid, xyz, mask.reshape(-1))
        batch_idx = torch.arange(b, dtype=torch.int32, device=points.device).repeat_interleave(n)
        local = voxel_segment_ids(grid, vx, vy, vz, flat_valid)
        seg = torch.where(flat_valid, batch_idx * nvox + local, b * nvox)
        order, slot, slot_id, n_vox = compactify(seg, b * nvox, cap)
        if telemetry is not None:
            telemetry["voxel_active"] = n_vox
            telemetry["voxel_overflow"] = torch.clamp(n_vox - cap, min=0)

        feats = points.reshape(-1, d).float()[order]
        valid_s = flat_valid[order][:, None]
        table = scatter.segment_mean(torch.where(valid_s, feats, 0.0), slot, cap + 1)
        if self.dtype is not None:
            table = table.to(self.dtype)
        # the dump row holds the mean of overflowed points: zero it
        table = torch.cat([table[:-1], table.new_zeros((1, d))])
        slot_of_dense, occupied = invert_slot_map(slot_id, b * nvox)
        return SparseBEV(table, occupied, slot_of_dense, slot_id, b,
                         (grid.size_z, grid.size_y, grid.size_x))
