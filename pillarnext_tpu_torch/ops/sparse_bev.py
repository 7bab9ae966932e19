"""Compact active-site representation of a BEV grid or a voxel volume.

Counterpart of ``SparseBEV`` (pillarnext_tpu/ops/sparse_bev.py:19-43).
"""

from __future__ import annotations

import dataclasses

import torch

from pillarnext_tpu_torch.ops.densify import densify


@dataclasses.dataclass
class SparseBEV:
    table: torch.Tensor          # (cap + 1, C); row cap is the all-zero dump row
    valid: torch.Tensor          # (cap,) bool: slot is an occupied cell
    slot_of_dense: torch.Tensor  # (B * prod(spatial),) int32 -> slot, cap if empty
    slot_id: torch.Tensor        # (cap,) int32 dense position (B * prod(spatial) if unused)
    batch: int
    spatial: tuple               # (H, W), or (D, H, W) for voxels

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    def with_table(self, features: torch.Tensor) -> "SparseBEV":
        """Replace per-slot features; appends the zero dump row if absent."""
        if features.shape[0] == self.capacity:
            features = torch.cat([features, features.new_zeros((1, features.shape[-1]))])
        return dataclasses.replace(self, table=features)

    def to_dense(self, plain: bool = False) -> torch.Tensor:
        """(B, *spatial, C) through one row gather (a row gather backward):
        kernel 2 on a CUDA tensor unless ``plain``."""
        dense = densify(self.table, self.slot_of_dense, self.slot_id, plain=plain)
        return dense.reshape(self.batch, *self.spatial, self.table.shape[-1])
