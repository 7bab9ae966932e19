"""Pillar reader: pillarization, decoration and the two-layer PFN.

Counterpart of ``PillarFeatureNet`` (pillarnext_tpu/models/pillar_encoder.py:118-246).
Points get a compact slot each (one stable sort, ops/compact.py); the
decorated features [raw, xyz - pillar mean xyz, xy - pillar centre] go
through the PFN into the compact pillar table.  Eval runs both PFN layers
as kernel 1 on a CUDA tensor (ops/pfn.py), its plain version on the CPU.
Train (``self.training``) runs the layer stack of pillar_encoder.py:48-79
with batch statistics: Linear, masked BatchNorm, ReLU, mask, and for a
non-last layer the pillar max broadcast back to the points — kernel 3 on a
CUDA tensor (ops/segscan.py) — then a concat; the last layer's per-pillar
max is the table.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pillarnext_tpu_torch.models.layers import BN_EPS_SPARSE, BN_MOMENTUM_SPARSE, BatchNorm
from pillarnext_tpu_torch.ops import scatter
from pillarnext_tpu_torch.ops.compact import compactify, invert_slot_map
from pillarnext_tpu_torch.ops.pfn import pfn_kernel_params, pfn_two_layer, pfn_two_layer_plain
from pillarnext_tpu_torch.ops.segscan import pillar_max_broadcast
from pillarnext_tpu_torch.ops.sparse_bev import SparseBEV
from pillarnext_tpu_torch.ops.voxelize import VoxelGrid, pillar_coords, pillar_segment_ids


class PFNLayer(nn.Module):
    """One PFN layer (pillar_encoder.py:48-79): Linear (no bias) + BN
    (eps 1e-3); non-last layers have half the width.  The pillar reader's
    eval runs its parameters through kernel 1 instead (``kernel_params``);
    the MVF views run the layer in both modes."""

    def __init__(self, in_ch: int, out_ch: int, last_layer: bool):
        super().__init__()
        units = out_ch if last_layer else out_ch // 2
        self.linear = nn.Linear(in_ch, units, bias=False)
        self.norm = BatchNorm(units, BN_EPS_SPARSE, BN_MOMENTUM_SPARSE)

    def kernel_params(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(W (in, units), (2, units) rows inv, shift)."""
        return self.linear.weight.t(), torch.stack(self.norm.folded())

    def forward(self, feats, valid, slot, cap: int, last: bool, plain: bool = False):
        """Linear + BN + ReLU + mask over the slot-sorted points (train:
        masked batch statistics; eval: the running ones, folded); then the
        (cap + 1, units) pillar max for the last layer, or [x, pillar max
        back at every point] for the others: kernel 3's max broadcast in
        training, the max table and its back-gather (kernel 2 on a CUDA
        tensor, scatter.gather_segments) in eval, as the JAX layer runs."""
        x = torch.nn.functional.linear(feats, self.linear.weight.to(feats.dtype))
        x = torch.relu(self.norm(x, channel_dim=-1, valid=valid))
        x = torch.where(valid[:, None], x, 0.0)
        if last:
            return scatter.segment_max(x, slot, cap + 1)
        if self.training:
            return torch.cat([x, pillar_max_broadcast(x, slot, plain=plain)], dim=-1)
        # the dump row is the max over masked (zero) points: 0 unless the
        # table overflowed, and an overflowed frame is recomputed
        table = scatter.segment_max(x, slot, cap + 1)
        return torch.cat([x, scatter.gather_segments(table, slot, zero_dump_row=True, plain=plain)], dim=-1)


class PillarFeatureNet(nn.Module):
    """Points (B, N, D) + mask (B, N) -> SparseBEV (``output="sparse"``) or
    a dense (B, H, W, C) image."""

    def __init__(
        self,
        num_input_features: int,
        num_filters: Sequence[int],
        voxel_size: Sequence[float],
        pc_range: Sequence[float],
        pillar_capacity: int = 131072,
        output: str = "dense",
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        if len(num_filters) != 2:
            raise NotImplementedError(
                f"PFN depth {len(num_filters)} not ported yet (two layers only), see ROADMAP"
            )
        if num_input_features + 5 > 16:
            raise NotImplementedError("more than 16 decorated features not ported yet")
        if output not in ("dense", "sparse"):
            raise ValueError(f"output must be 'dense' or 'sparse', got {output!r}")
        self.num_input_features = num_input_features
        self.num_filters = tuple(int(f) for f in num_filters)
        self.grid = VoxelGrid.create(voxel_size, pc_range)
        self.pillar_capacity = int(pillar_capacity)
        # build_model(train=True) puts the config's train capacity here
        self.train_pillar_capacity = None
        self.output = output
        self.dtype = dtype
        widths = [num_input_features + 5, *self.num_filters]
        self.pfn_layers = nn.ModuleList(
            PFNLayer(widths[i], widths[i + 1], last_layer=(i == len(widths) - 2))
            for i in range(len(widths) - 1)
        )
        self._pfn_params = None  # (key, eval PFN parameters as kernel 1 takes them)

    @property
    def capacity(self) -> int:
        """Compact slots per sample at the largest serving bucket."""
        return self.pillar_capacity

    def pfn_params(self, device) -> tuple[torch.Tensor, ...]:
        """(w0, bn0, w1, bn1) of the eval PFN as kernel 1 takes them (f32,
        contiguous, BN folded, on ``device``), kept between calls.  They are
        rebuilt when the device or any PFN parameter or BN statistic changes
        its storage, dtype or version (``load_state_dict``, ``.to()``, an
        in-place update outside ``.data``)."""
        tensors = [t for layer in self.pfn_layers for t in (*layer.parameters(), *layer.buffers())]
        # inference tensors (a module moved under inference_mode) keep no
        # version counter: their parameters are rebuilt on every call
        key = None if any(t.is_inference() for t in tensors) else (
            torch.device(device), tuple((t.data_ptr(), t._version, t.dtype) for t in tensors))
        if key is None or self._pfn_params is None or self._pfn_params[0] != key:
            with torch.no_grad():
                w0, bn0 = self.pfn_layers[0].kernel_params()
                w1, bn1 = self.pfn_layers[1].kernel_params()
                self._pfn_params = (key, pfn_kernel_params(w0, bn0, w1, bn1, device))
        return self._pfn_params[1]

    def decorate(self, points, mask, capacity: int | None = None, plain: bool = False):
        """Pillarize and decorate: (decorated features (N, df) sorted by
        slot in the compute dtype, ascending slot (N,) int32, slot_id (cap,),
        occupied-pillar count (), cap, validity of each sorted point (N,))."""
        grid = self.grid
        b, n, d = points.shape
        if d != self.num_input_features:
            raise ValueError(f"points have {d} features, expected {self.num_input_features}")
        hw = grid.num_pillars
        cap = min((capacity or self.pillar_capacity) * b, hw * b)

        xyz = points[..., :3].reshape(-1, 3)
        px, py, flat_valid = pillar_coords(grid, xyz, mask.reshape(-1))
        batch_idx = torch.arange(b, dtype=torch.int32, device=points.device).repeat_interleave(n)
        local_sid = pillar_segment_ids(grid, px, py, flat_valid)
        dense_ids = torch.where(flat_valid, batch_idx * hw + local_sid, b * hw)
        order, slot, slot_id, n_pillars = compactify(dense_ids, b * hw, cap)

        raw = points.reshape(-1, d).float()[order]
        xyz_s = raw[:, :3]
        valid_s = flat_valid[order][:, None]
        mean_xyz = scatter.segment_mean(torch.where(valid_s, xyz_s, 0.0), slot, cap + 1)
        # the dump row of mean_xyz is 0 / max(count, 1) = 0 exactly
        f_cluster = xyz_s - scatter.gather_segments(mean_xyz, slot, zero_dump_row=True, plain=plain)
        (vx, vy), (ox, oy) = grid.voxel_size[:2], grid.pc_range[:2]
        f_center = torch.stack([
            xyz_s[:, 0] - (px[order].float() * vx + vx / 2 + ox),
            xyz_s[:, 1] - (py[order].float() * vy + vy / 2 + oy),
        ], dim=-1)
        feats = torch.cat([raw, f_cluster, f_center], dim=-1)
        feats = torch.where(valid_s, feats, 0.0)
        if self.dtype is not None:
            feats = feats.to(self.dtype)
        return feats.contiguous(), slot, slot_id, n_pillars, cap, valid_s[:, 0]

    def forward(self, points, mask, capacity: int | None = None, telemetry=None, plain=False):
        """``capacity`` overrides ``pillar_capacity`` (serving buckets; in
        training the train capacity when one is set); ``telemetry`` (a dict)
        receives the occupied-pillar count and the overflow as device
        scalars; ``plain`` keeps CUDA tensors on the plain versions of the
        kernels (for comparisons)."""
        if self.training and capacity is None:
            capacity = self.train_pillar_capacity
        feats, slot, slot_id, n_pillars, cap, valid = self.decorate(points, mask, capacity, plain)
        if telemetry is not None:
            telemetry["pillar_active"] = n_pillars
            telemetry["pillar_overflow"] = torch.clamp(n_pillars - cap, min=0)
        if self.training:
            x = feats
            for i, layer in enumerate(self.pfn_layers):
                x = layer(x, valid, slot, cap, i == len(self.pfn_layers) - 1, plain)
            # the dump row holds the max of overflowed valid points: zero it
            table = torch.cat([x[:-1], x.new_zeros((1, x.shape[1]))])
        else:
            pfn = pfn_two_layer_plain if plain else pfn_two_layer
            table = pfn(feats, slot, *self.pfn_params(feats.device), cap)
        b = points.shape[0]
        slot_of_dense, occupied = invert_slot_map(slot_id, b * self.grid.num_pillars)
        sbev = SparseBEV(table, occupied, slot_of_dense, slot_id, b, self.grid.bev_shape)
        if self.output == "sparse":
            return sbev
        return sbev.to_dense(plain=plain)
