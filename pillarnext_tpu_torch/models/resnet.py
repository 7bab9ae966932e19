"""Sparse ResNet backbones: the BEV ResNet (eval ``leading`` and train
``all`` paths) and the fully sparse 3-D voxel ResNet (eval and train).

Counterpart of ``SparseResNet`` (pillarnext_tpu/models/resnet.py:445-805)
and of ``SparseResNet3D``'s sparse forward (resnet.py:915-1144), which
runs the same tables in eval and in training.

Eval (``sparse_eval=True``, ``sparse_stages_eval="leading"``,
``masked_eval=True``): the leading stride-1 stages run as SubM convs over
the compact table (gather + matmul), the result is densified (kernel 2 on
a CUDA tensor), and the strided stages and the 1x1 mapping run as dense
convs re-masked to the active set after every block, the mask dilating
like spconv's strided SparseConv.

Train (``self.training``, ``sparse_stages_train="all"``, resnet.py:719-805):
the whole backbone runs over compact tables — SubM stride-1 stages,
set-dilating strided stages whose tables are sized by
``stage_capacity_frac`` of the reader's capacity, a SubM 1x1 mapping —
with batch statistics over the active rows, and is densified once at the
final grid.  Each strided stage reports ``stage{i}_active`` and
``stage{i}_overflow``.  Spconv active-set semantics are exact on both
paths, and both read the same parameters.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

import numpy as np

from pillarnext_tpu_torch.models.layers import (
    BN_EPS_SPARSE,
    BN_MOMENTUM_SPARSE,
    BatchNorm,
    ConvBlock,
    ResidualBlock,
    SparseConvBlock3d,
    SparseResidualBlock3d,
    conv2d,
)
from pillarnext_tpu_torch.ops.sparse_bev import SparseBEV
from pillarnext_tpu_torch.ops.sparse_down import (
    build_down_neighbor_tables,
    down_neighbor_table,
    downsample_active_set,
    out_spatial_for,
    sparse_strided_conv,
)
from pillarnext_tpu_torch.ops.subm_conv import (
    build_neighbor_table,
    gather_matmul,
    subm_conv,
    subm_offsets_2d,
    subm_offsets_3d,
)


def _subm_kernel(conv: nn.Module) -> torch.Tensor:
    """Conv2d / Conv3d weight (O, I, *k) -> sparse conv kernel (K, I, O),
    taps row-major like ``subm_offsets_2d`` / ``subm_offsets_3d``."""
    w = conv.weight
    o, i = w.shape[:2]
    return w.permute(*range(2, w.dim()), 1, 0).reshape(-1, i, o)


def _with_dump_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])


def sparse_conv_block(block: ConvBlock, x, valid, nbr):
    """SubM conv + BN + ReLU over the compact table (resnet.py:111-131)."""
    y = subm_conv(_with_dump_row(x), nbr, _subm_kernel(block.conv))
    y = block.norm(y, channel_dim=-1, valid=valid)
    return torch.where(valid[:, None], torch.relu(y), 0.0)


def sparse_residual_block(block: ResidualBlock, x, valid, nbr):
    """SubM residual block over the compact table (resnet.py:134-157)."""
    y = sparse_conv_block(block.block1, x, valid, nbr)
    y = subm_conv(_with_dump_row(y), nbr, _subm_kernel(block.conv2))
    y = block.norm2(y, channel_dim=-1, valid=valid)
    return torch.where(valid[:, None], torch.relu(y + x), 0.0)


def sparse_strided_block(conv: nn.Module, norm: BatchNorm, x, out_valid, nbr_fwd, nbr_rev):
    """Strided sparse conv + BN + ReLU into the dilated output table
    (resnet.py:160-180)."""
    y = sparse_strided_conv(_with_dump_row(x), nbr_fwd, nbr_rev, _subm_kernel(conv))
    y = norm(y, channel_dim=-1, valid=out_valid)
    return torch.where(out_valid[:, None], torch.relu(y), 0.0)


def sparse_down_block_eval(conv: nn.Module, norm: BatchNorm, x, out_valid, nbr_fwd):
    """``sparse_strided_block`` without the reverse table the backward
    needs: the eval forward of a strided sparse conv + BN + ReLU."""
    y = gather_matmul(_with_dump_row(x), nbr_fwd, _subm_kernel(conv).to(x.dtype))
    y = norm(y, channel_dim=-1, valid=out_valid)
    return torch.where(out_valid[:, None], torch.relu(y), 0.0)


class SparseResNet(nn.Module):
    """Per stage a (strided) ConvBlock then ``layer_nums[i]`` residual
    blocks, then a 1x1 ConvBlock to ``out_channels``.  Input: a SparseBEV;
    output: (B, H', W', out_channels) NHWC."""

    def __init__(
        self,
        layer_nums: Sequence[int],
        ds_layer_strides: Sequence[int],
        ds_num_filters: Sequence[int],
        num_input_features: int,
        kernel_size: Sequence[int] = (3, 3, 3, 3),
        out_channels: int = 256,
        sparse_eval: bool = False,
        masked_eval: bool = True,
        sparse_stages_eval: str = "leading",
        sparse_stages_train: str = "all",
        packed_downsample: bool = False,
        tile_stride1: bool = False,
        force_dense_train: bool = False,
        stage_capacity_frac: Sequence[float] = (1.0, 1.0, 0.5, 0.25),
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        if not sparse_eval:
            raise NotImplementedError("sparse_eval=false not ported yet, see ROADMAP")
        if not masked_eval:
            raise NotImplementedError("masked_eval=false not ported yet, see ROADMAP")
        if sparse_stages_eval != "leading":
            raise NotImplementedError(
                f"sparse_stages_eval={sparse_stages_eval!r} not ported yet, see ROADMAP"
            )
        if packed_downsample:
            raise NotImplementedError("packed_downsample not ported yet, see ROADMAP")
        if sparse_stages_train != "all":
            raise NotImplementedError(
                f"sparse_stages_train={sparse_stages_train!r} not ported yet, see ROADMAP"
            )
        if tile_stride1:
            raise NotImplementedError("tile_stride1 not ported yet, see ROADMAP")
        if force_dense_train:
            raise NotImplementedError("force_dense_train not ported yet, see ROADMAP")
        self.layer_nums = tuple(int(n) for n in layer_nums)
        self.strides = tuple(int(s) for s in ds_layer_strides)
        self.kernel_size = tuple(int(k) for k in kernel_size)
        self.stage_capacity_frac = tuple(stage_capacity_frac)
        self.n_sparse = 0
        while self.n_sparse < len(self.strides) and self.strides[self.n_sparse] == 1:
            self.n_sparse += 1
        blocks = []
        in_ch = num_input_features
        for i, n_blocks in enumerate(self.layer_nums):
            ch, k = int(ds_num_filters[i]), self.kernel_size[i]
            stage = [ConvBlock(in_ch, ch, k, stride=self.strides[i], eps=BN_EPS_SPARSE,
                               momentum=BN_MOMENTUM_SPARSE)]
            stage += [ResidualBlock(ch, k, eps=BN_EPS_SPARSE) for _ in range(n_blocks)]
            blocks.append(nn.ModuleList(stage))
            in_ch = ch
        self.blocks = nn.ModuleList(blocks)
        # reference schema: mapping.0 = conv, mapping.1 = BN
        self.mapping = nn.Sequential(
            nn.Conv2d(in_ch, out_channels, 1, bias=False),
            BatchNorm(out_channels, BN_EPS_SPARSE, BN_MOMENTUM_SPARSE),
        )

    def table_capacities(self, cap: int, batch: int, spatial: tuple) -> dict:
        """Rows of each strided stage's table in training (``stage{i}``),
        for a reader table of ``cap`` rows over ``batch`` x ``spatial`` (H, W)."""
        caps = {}
        for i, s in enumerate(self.strides):
            if s > 1:
                spatial = tuple(-(-n // s) for n in spatial)
                frac = float(self.stage_capacity_frac[i])
                caps[f"stage{i}"] = min(max(int(cap * frac), 4096), batch * spatial[0] * spatial[1])
        return caps

    def forward(self, sb: SparseBEV, plain: bool = False, telemetry=None) -> torch.Tensor:
        """SparseBEV -> (B, H', W', out_channels) NHWC.  ``telemetry`` (a
        dict) receives the strided stages' active and overflow counts in
        training; ``plain`` keeps CUDA tensors on the kernels' plain
        versions."""
        if not isinstance(sb, SparseBEV):
            raise TypeError("SparseResNet takes the reader's SparseBEV (reader.output='sparse')")
        if self.training:
            return self._all_sparse(sb, plain, {} if telemetry is None else telemetry)
        feats = sb.table[:-1]
        if self.n_sparse:
            nbr = build_neighbor_table(
                sb.slot_of_dense, sb.slot_id, sb.spatial,
                subm_offsets_2d(self.kernel_size[0]), sb.capacity,
            )
            for i in range(self.n_sparse):
                stage = self.blocks[i]
                feats = sparse_conv_block(stage[0], feats, sb.valid, nbr)
                for block in stage[1:]:
                    feats = sparse_residual_block(block, feats, sb.valid, nbr)
        x = sb.with_table(feats).to_dense(plain=plain).permute(0, 3, 1, 2)  # NCHW view
        mask = (sb.slot_of_dense < sb.capacity).reshape(sb.batch, 1, *sb.spatial).float()
        for i in range(self.n_sparse, len(self.layer_nums)):
            s, k = self.strides[i], self.kernel_size[i]
            if s > 1:
                # a strided SparseConv output site is active if any input
                # site in its k x k window is (max over a mask >= 0 equals
                # reduce_window max with 0 padding)
                mask = F.max_pool2d(mask, k, s, k // 2)
            m = mask.to(x.dtype)
            for block in self.blocks[i]:
                x = block(x, m)
        x = torch.relu(self.mapping[1](conv2d(x, self.mapping[0]))) * mask.to(x.dtype)
        return x.permute(0, 2, 3, 1)

    def _all_sparse(self, sb: SparseBEV, plain: bool, telemetry: dict) -> torch.Tensor:
        """The whole backbone over compact tables (resnet.py:719-805)."""
        batch, spatial = sb.batch, sb.spatial
        table, valid, sod, slot_id = sb.table[:-1], sb.valid, sb.slot_of_dense, sb.slot_id
        caps = self.table_capacities(sb.capacity, batch, spatial)
        for i, stage in enumerate(self.blocks):
            k, s = self.kernel_size[i], self.strides[i]
            if s == 1:
                nbr = build_neighbor_table(sod, slot_id, spatial, subm_offsets_2d(k), valid.shape[0])
                table = sparse_conv_block(stage[0], table, valid, nbr)
            else:
                cap_out = caps[f"stage{i}"]
                out_slot_id, out_sod, out_valid, out_sp, n_out = downsample_active_set(
                    sod, valid.shape[0], batch, spatial, (k, k), (s, s), cap_out
                )
                telemetry[f"stage{i}_active"] = n_out
                telemetry[f"stage{i}_overflow"] = torch.clamp(n_out - cap_out, min=0)
                nbr_fwd, nbr_rev = build_down_neighbor_tables(
                    sod, out_slot_id, slot_id, batch, spatial, (k, k), (s, s)
                )
                nbr = build_neighbor_table(out_sod, out_slot_id, out_sp, subm_offsets_2d(k), cap_out)
                table = sparse_strided_block(stage[0].conv, stage[0].norm, table, out_valid,
                                             nbr_fwd, nbr_rev)
                valid, sod, slot_id, spatial = out_valid, out_sod, out_slot_id, out_sp
            for block in stage[1:]:
                table = sparse_residual_block(block, table, valid, nbr)
        # 1x1 mapping = SubM conv whose only tap is the site itself
        nbr1 = build_neighbor_table(sod, slot_id, spatial, np.zeros((1, 2), np.int32), valid.shape[0])
        y = subm_conv(_with_dump_row(table), nbr1, _subm_kernel(self.mapping[0]))
        y = self.mapping[1](y, channel_dim=-1, valid=valid)
        table = torch.where(valid[:, None], torch.relu(y), 0.0)
        out = SparseBEV(_with_dump_row(table), valid, sod, slot_id, batch, tuple(spatial))
        return out.to_dense(plain=plain)


# the reference's extra z-downsample: kernel (3, 1, 1), stride (2, 1, 1),
# padding 0 (SparseConv3d's default; padding 1 would leave depth 3, not 2,
# and break the channels the neck takes)
EXTRA_Z_DOWN = ((3, 1, 1), (2, 1, 1), (0, 0, 0))


class SparseResNet3D(nn.Module):
    """3-D voxel ResNet over compact tables (the reference's
    sparse_resnet3d.py:9-72): per stage a SubM (stride 1) or set-dilating
    strided SparseConv3d block then ``layer_nums[i]`` SubM residual blocks,
    the extra z-downsample (3, 1, 1) / (2, 1, 1) with padding 0, and a SubM
    1x1x1 mapping to ``out_channels``; densified once at the final grid
    (kernel 2 on a CUDA tensor) and folded depth-major,
    (B, D, H, W, C) -> (B, H, W, D * C), as the JAX package folds it.

    Each strided table has ``max(int(cap * stage_capacity_frac[i]), 4096)``
    rows, capped by its output grid (``cap``: the reader's table); the
    extra z-conv takes the entry after the stages' (or the last one).
    Input: the voxel reader's SparseBEV over (D, H, W).

    Training (``self.training``) runs the same tables with batch
    statistics over each table's active rows (JAX ``train=True``): the
    strided convs and the extra z-conv get the reverse tap table their
    backward gathers through (``build_down_neighbor_tables``), the SubM
    convs their mirrored tap table, and the densify's backward is kernel 2
    too.  No block is recomputed in the backward (JAX remats every block):
    the autograd Functions keep only their input table, tap tables and
    kernel, so each (rows, K * C) gather buffer lives only inside its
    conv's forward or backward."""

    def __init__(
        self,
        layer_nums: Sequence[int],
        ds_layer_strides: Sequence[int],
        ds_num_filters: Sequence[int],
        num_input_features: int,
        kernel_size: Sequence[int] = (3, 3, 3, 3),
        out_channels: int = 128,
        stage_capacity_frac: Sequence[float] = (1.0, 1.5, 0.9, 0.4, 0.25),
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.layer_nums = tuple(int(n) for n in layer_nums)
        self.strides = tuple(int(s) for s in ds_layer_strides)
        self.kernel_size = tuple(int(k) for k in kernel_size)
        self.stage_capacity_frac = tuple(float(f) for f in stage_capacity_frac)
        blocks = []
        in_ch = num_input_features
        for i, n_blocks in enumerate(self.layer_nums):
            ch, k = int(ds_num_filters[i]), self.kernel_size[i]
            stage = [SparseConvBlock3d(in_ch, ch, k, stride=self.strides[i])]
            stage += [SparseResidualBlock3d(ch, k) for _ in range(n_blocks)]
            blocks.append(nn.ModuleList(stage))
            in_ch = ch
        self.blocks = nn.ModuleList(blocks)
        # reference schema: extra_conv.0 = conv, extra_conv.1 = BN
        self.extra_conv = nn.Sequential(
            nn.Conv3d(in_ch, in_ch, *EXTRA_Z_DOWN[:2], bias=False),
            BatchNorm(in_ch, BN_EPS_SPARSE, BN_MOMENTUM_SPARSE),
        )
        self.mapping = SparseConvBlock3d(in_ch, out_channels, 1)

    def table_capacities(self, cap: int, batch: int, spatial: tuple) -> dict:
        """Rows of each strided table (``stage{i}``, ``extra``) for a reader
        table of ``cap`` rows over ``batch`` x ``spatial``."""
        fracs = self.stage_capacity_frac
        caps = {}
        for i, (k, s) in enumerate(zip(self.kernel_size, self.strides)):
            if s > 1:
                spatial = out_spatial_for(spatial, (k,) * 3, (s,) * 3)
                caps[f"stage{i}"] = (fracs[i], spatial)
        extra_frac = fracs[len(self.layer_nums)] if len(fracs) > len(self.layer_nums) else fracs[-1]
        caps["extra"] = (extra_frac, out_spatial_for(spatial, *EXTRA_Z_DOWN))
        return {name: min(max(int(cap * frac), 4096), batch * int(np.prod(sp)))
                for name, (frac, sp) in caps.items()}

    def forward(self, sb: SparseBEV, plain: bool = False, telemetry=None) -> torch.Tensor:
        """SparseBEV over (D, H, W) -> (B, H', W', D' * out_channels).
        ``telemetry`` (a dict) receives ``stage{i}_active`` /
        ``stage{i}_overflow`` of each strided stage and ``extra_active`` /
        ``extra_overflow`` as device scalars; ``plain`` keeps CUDA tensors
        on kernel 2's plain version."""
        if not isinstance(sb, SparseBEV) or len(sb.spatial) != 3:
            raise TypeError(
                "SparseResNet3D takes the voxel reader's SparseBEV over (D, H, W) "
                "(the dense 3-D path is not ported yet, see ROADMAP)"
            )
        telemetry = {} if telemetry is None else telemetry
        batch, spatial, cap = sb.batch, tuple(sb.spatial), sb.capacity
        table, valid, sod, slot_id = sb.table[:-1], sb.valid, sb.slot_of_dense, sb.slot_id
        caps = self.table_capacities(cap, batch, spatial)

        def down(table, kernel_shape, stride, padding, name, conv, norm):
            """One set-dilating strided conv block into a table of its own;
            in training with the reverse tap table of its backward."""
            nonlocal valid, sod, slot_id, spatial
            cap_out = caps[name]
            out_slot_id, out_sod, out_valid, out_sp, n_out = downsample_active_set(
                sod, valid.shape[0], batch, spatial, kernel_shape, stride, cap_out, padding
            )
            telemetry[f"{name}_active"] = n_out
            telemetry[f"{name}_overflow"] = torch.clamp(n_out - cap_out, min=0)
            if self.training:
                nbr_fwd, nbr_rev = build_down_neighbor_tables(
                    sod, out_slot_id, slot_id, batch, spatial, kernel_shape, stride, padding
                )
                table = sparse_strided_block(conv, norm, table, out_valid, nbr_fwd, nbr_rev)
            else:
                nbr_fwd = down_neighbor_table(
                    sod, out_slot_id, valid.shape[0], batch, spatial, kernel_shape, stride, padding
                )
                table = sparse_down_block_eval(conv, norm, table, out_valid, nbr_fwd)
            valid, sod, slot_id, spatial = out_valid, out_sod, out_slot_id, out_sp
            return table

        for i, stage in enumerate(self.blocks):
            k, s = self.kernel_size[i], self.strides[i]
            if s > 1:
                table = down(table, (k,) * 3, (s,) * 3, None, f"stage{i}", stage[0].conv, stage[0].norm)
            nbr = build_neighbor_table(sod, slot_id, spatial, subm_offsets_3d(k), valid.shape[0])
            if s == 1:
                table = sparse_conv_block(stage[0], table, valid, nbr)
            for block in stage[1:]:
                table = sparse_residual_block(block, table, valid, nbr)
        table = down(table, *EXTRA_Z_DOWN, "extra", *self.extra_conv)

        # SubM 1x1x1 mapping: the site's own row only
        y = table @ _subm_kernel(self.mapping.conv)[0].to(table.dtype)
        y = self.mapping.norm(y, channel_dim=-1, valid=valid)
        table = torch.where(valid[:, None], torch.relu(y), 0.0)

        out = SparseBEV(_with_dump_row(table), valid, sod, slot_id, batch, spatial)
        dense = out.to_dense(plain=plain)  # (B, D, H, W, C)
        b, d, h, w, c = dense.shape
        return dense.permute(0, 2, 3, 1, 4).reshape(b, h, w, d * c)

