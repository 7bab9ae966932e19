"""Compact active-site representation of a BEV grid or a voxel volume.

Counterpart of ``SparseBEV`` (pillarnext_tpu/ops/sparse_bev.py:19-43).
"""

from __future__ import annotations

import dataclasses

import torch

from pillarnext_tpu_torch.ops.densify import densify
from pillarnext_tpu_torch.ops.gather import monotone_row_gather, monotone_row_gather_plain


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

    def to_dense_packed(self, plain: bool = False) -> torch.Tensor:
        """Eval only: (B, H/2, W/2, 4C) with each 2x2 cell packed into the
        channels, ``q = (dy * 2 + dx) * C + c`` (sparse_bev.py:45-69), the
        input ``layers.packed_down_conv`` takes.  One row gather (kernel 2
        on a CUDA tensor unless ``plain``) in the interleaved index order
        ``idx[b, Y, X, dy, dx] = slot_of_dense[b, 2Y + dy, 2X + dx]``; the
        dump slot reads zeros.  It has no backward."""
        b, (h, w) = self.batch, self.spatial
        if h % 2 or w % 2:
            raise ValueError(f"a packed densify needs an even grid, got {(h, w)}")
        c = self.table.shape[-1]
        idx = (self.slot_of_dense.reshape(b, h // 2, 2, w // 2, 2)
               .permute(0, 1, 3, 2, 4).reshape(-1).contiguous())
        gather = monotone_row_gather_plain if plain else monotone_row_gather
        return gather(self.table[:-1].detach(), idx).reshape(b, h // 2, w // 2, 4 * c)
