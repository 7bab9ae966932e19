"""Sparse ResNet backbones: the BEV ResNet in every stage mode of the JAX
package, and the fully sparse 3-D voxel ResNet (eval and train).

Counterpart of ``SparseResNet`` (pillarnext_tpu/models/resnet.py:445-911)
and of ``SparseResNet3D`` (resnet.py:915-1144): its sparse forward, which
runs the same tables in eval and in training, and its dense forward over
the dense voxel volume (cuDNN 3-D convs, eval and training).

``SparseResNet`` takes the reader's SparseBEV, or a dense (B, H, W, C)
image when its first stage is strided (the reader's ``output="dense"``).
Its stage modes, ``sparse_stages_eval`` in eval and
``sparse_stages_train`` in training (with a SparseBEV, ``sparse_eval``
or training, and no ``force_dense_train``):

- ``leading``: the leading stride-1 stages run as SubM convs over the
  compact table (gather + matmul), the result is densified (kernel 2 on a
  CUDA tensor; 2x2-packed into a 2x2 down conv with ``packed_downsample``
  in eval), and the rest runs as dense convs re-masked to the active set,
  the mask dilating like spconv's strided SparseConv.
- ``tile``: the same, with the leading stages over the active-tile stack
  (ops/tile_subm.py), densified from the stack.
- ``leading+down``: the sparse prefix and the first strided stage's down
  conv run over compact tables, the result is densified at that stage's
  grid, and the rest is the masked-dense tail.
- ``all``: the whole backbone over compact tables (SubM stride-1 stages,
  set-dilating strided stages whose tables are sized by
  ``stage_capacity_frac``, a SubM 1x1 mapping), densified once at the
  final grid; with ``tile_stride1`` its stride-1 stages run over the tile
  stack.

Without a sparse mode the SparseBEV is densified at full resolution and
every stage runs masked-dense.  In eval ``masked_eval=False`` drops the
mask of the dense tail (BN constants bleed into empty cells, as in JAX).
Training statistics are those of the active rows or cells; a dense input
has no mask and plain batch statistics.  In training each dense block is
recomputed in the backward when ``remat_train`` is on.  Strided tables
report ``stage{i}_active`` / ``stage{i}_overflow``, tile maps
``{tag}_tiles{H}_active`` / ``{tag}_tiles{H}_overflow``.  Every mode reads
the same parameters, and spconv active-set semantics are exact in all but
the unmasked tail.
"""

from __future__ import annotations

from types import SimpleNamespace
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
    recomputed,
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
from pillarnext_tpu_torch.ops.tile_subm import (
    build_tile_map,
    pack_stack,
    stack_to_dense,
    tile_conv,
    unpack_stack,
)

STAGE_MODES = ("leading", "leading+down", "all", "tile")


def _subm_kernel(conv: nn.Module) -> torch.Tensor:
    """Conv2d / Conv3d weight (O, I, *k) -> sparse conv kernel (K, I, O),
    taps row-major like ``subm_offsets_2d`` / ``subm_offsets_3d``."""
    w = conv.weight
    o, i = w.shape[:2]
    return w.permute(*range(2, w.dim()), 1, 0).reshape(-1, i, o)


def _with_dump_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])


def run_block(forward, block: nn.Module, *args, remat=None):
    """``forward(block, *args)``; with ``remat`` (a training forward)
    recomputed in the backward as JAX's ``nn.remat`` of the block, keeping
    each sparse conv's output when ``remat`` is True (JAX's
    ``remat_save_conv_out`` policy, resnet.py:183-192) and only the
    block's inputs when it is False."""
    if remat is None:
        return forward(block, *args)
    return recomputed(block, *args, forward=forward, save_conv_out=remat)


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


def sparse_stage(stage: nn.ModuleList, x, valid, nbr, remat=None):
    """A stride-1 stage (a ConvBlock, then residual blocks) over the
    compact table, each block run by ``run_block`` (resnet.py:274-302)."""
    x = run_block(sparse_conv_block, stage[0], x, valid, nbr, remat=remat)
    for block in stage[1:]:
        x = run_block(sparse_residual_block, block, x, valid, nbr, remat=remat)
    return x


def sparse_strided_block(block: ConvBlock, x, out_valid, nbr_fwd, nbr_rev):
    """Strided sparse conv + BN + ReLU into the dilated output table
    (resnet.py:160-180)."""
    y = sparse_strided_conv(_with_dump_row(x), nbr_fwd, nbr_rev, _subm_kernel(block.conv))
    y = block.norm(y, channel_dim=-1, valid=out_valid)
    return torch.where(out_valid[:, None], torch.relu(y), 0.0)


def sparse_down_block_eval(conv: nn.Module, norm: BatchNorm, x, out_valid, nbr_fwd):
    """``sparse_strided_block`` without the reverse table the backward
    needs: the eval forward of a strided sparse conv + BN + ReLU."""
    y = gather_matmul(_with_dump_row(x), nbr_fwd, _subm_kernel(conv).to(x.dtype))
    y = norm(y, channel_dim=-1, valid=out_valid)
    return torch.where(out_valid[:, None], torch.relu(y), 0.0)


def tile_conv_block(block: ConvBlock, stack, tm, plain: bool):
    """Tile-stack SubM conv + BN (statistics over ``tm.out_mask``) + ReLU,
    inactive cells re-zeroed (resnet.py:327-345)."""
    y = tile_conv(stack, tm, block.conv.weight, plain)
    y = block.norm(y, channel_dim=-1, valid=tm.out_mask)
    return torch.where(tm.out_mask[..., None], torch.relu(y), 0.0)


def tile_residual_block(block: ResidualBlock, stack, tm, plain: bool):
    """Tile-stack residual block (resnet.py:348-369)."""
    y = tile_conv_block(block.block1, stack, tm, plain)
    y = block.norm2(tile_conv(y, tm, block.conv2.weight, plain), channel_dim=-1, valid=tm.out_mask)
    return torch.where(tm.out_mask[..., None], torch.relu(y + stack), 0.0)


def tile_stage(stage: nn.ModuleList, stack, tm, plain: bool, remat=None):
    """A stride-1 stage over the active-tile stack, each block run by
    ``run_block`` (resnet.py:372-395: JAX remats each tile block with no
    policy, so a training forward passes ``remat=False``)."""
    stack = run_block(tile_conv_block, stage[0], stack, tm, plain, remat=remat)
    for block in stage[1:]:
        stack = run_block(tile_residual_block, block, stack, tm, plain, remat=remat)
    return stack


class SparseResNet(nn.Module):
    """Per stage a (strided) ConvBlock then ``layer_nums[i]`` residual
    blocks, then a 1x1 ConvBlock to ``out_channels``.  Input: a SparseBEV
    or a dense (B, H, W, C) image; output: (B, H', W', out_channels) NHWC.
    Takes every option of JAX's ``SparseResNet`` but ``axis_name`` (the
    port syncs BatchNorm by ``BatchNorm.sync``).

    In training every block that runs over compact tables is recomputed in
    the backward, as JAX remats it: each SubM block, and the strided block
    of a stage in the ``all`` mode, keeping each sparse conv's output with
    ``remat_save_conv_out`` (the default, JAX's policy) and only the
    block's input without it; each tile block with no policy.  The strided
    block of ``leading+down`` and the 1x1 mapping run bare, as in JAX;
    the masked-dense tail recomputes each block under ``remat_train``."""

    def __init__(
        self,
        layer_nums: Sequence[int],
        ds_layer_strides: Sequence[int],
        ds_num_filters: Sequence[int],
        num_input_features: int,
        kernel_size: Sequence[int] = (3, 3, 3, 3),
        out_channels: int = 256,
        force_dense_train: bool = False,
        sparse_eval: bool = False,
        masked_eval: bool = True,
        remat_train: bool = True,
        remat_save_conv_out: bool = True,
        sparse_stages_train: str = "all",
        sparse_stages_eval: str = "leading",
        packed_downsample: bool = False,
        tile_size: int = 8,
        tile_capacity: int = 12288,
        tile_stride1: bool = False,
        stage_capacity_frac: Sequence[float] = (1.0, 1.0, 0.5, 0.25),
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        for name, mode in (("sparse_stages_eval", sparse_stages_eval),
                           ("sparse_stages_train", sparse_stages_train)):
            if mode not in STAGE_MODES:
                raise ValueError(f"{name}={mode!r} is not one of {STAGE_MODES}")
        self.layer_nums = tuple(int(n) for n in layer_nums)
        self.strides = tuple(int(s) for s in ds_layer_strides)
        self.kernel_size = tuple(int(k) for k in kernel_size)
        self.stage_capacity_frac = tuple(stage_capacity_frac)
        self.force_dense_train = bool(force_dense_train)
        self.sparse_eval = bool(sparse_eval)
        self.masked_eval = bool(masked_eval)
        self.remat_train = bool(remat_train)
        self.remat_save_conv_out = bool(remat_save_conv_out)
        self.sparse_stages_train = sparse_stages_train
        self.sparse_stages_eval = sparse_stages_eval
        self.packed_downsample = bool(packed_downsample)
        self.tile_size = int(tile_size)
        self.tile_capacity = int(tile_capacity)
        self.tile_stride1 = bool(tile_stride1)
        self.n_sparse = 0
        while self.n_sparse < len(self.strides) and self.strides[self.n_sparse] == 1:
            self.n_sparse += 1
        tile_prefix = (sparse_eval and sparse_stages_eval == "tile") or (
            not force_dense_train and sparse_stages_train == "tile")
        if tile_prefix and any(k != 3 for k in self.kernel_size[:self.n_sparse]):
            raise ValueError(
                "sparse_stages='tile' requires 3x3 stride-1 kernels (got kernel_size="
                f"{tuple(self.kernel_size[:self.n_sparse])}); use sparse_stages='leading' for this configuration")
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

    @property
    def uses_tiles(self) -> bool:
        """Whether an eval forward builds a tile map (serving then sizes
        its tile capacity by the bucket, ``tile_capacity_for``)."""
        return self.sparse_eval and (self.sparse_stages_eval == "tile" or (
            self.sparse_stages_eval == "all" and self.tile_stride1))

    def tile_capacity_for(self, bucket: int, max_bucket: int) -> int:
        """The tile capacity of a serving bucket (serving.py:119-136): the
        full tile grid (0) at the largest bucket, so that a repair there is
        exact; below it ``tile_capacity`` scaled by the bucket, at least
        256."""
        if bucket >= max_bucket:
            return 0
        return max(256, -(-self.tile_capacity * bucket // max_bucket))

    def tile_slots(self, tiles: int, batch: int, spatial: tuple, frac: float = 1.0) -> int:
        """Tile slots of a tile map over ``batch`` x ``spatial`` (H, W):
        ``min(max(int(tiles * batch * frac), 256), tile grid)``, the whole
        tile grid when ``tiles <= 0`` (resnet.py:665-689)."""
        n_cells = batch * (spatial[0] // self.tile_size) * (spatial[1] // self.tile_size)
        return n_cells if tiles <= 0 else min(max(int(tiles * batch * frac), 256), n_cells)

    def _stage_capacity(self, cap: int, batch: int, spatial: tuple, i: int) -> int:
        out = out_spatial_for(spatial, (self.kernel_size[i],) * 2, (self.strides[i],) * 2)
        return min(max(int(cap * float(self.stage_capacity_frac[i])), 4096), batch * out[0] * out[1])

    def table_capacities(self, cap: int, batch: int, spatial: tuple) -> dict:
        """Rows of each strided stage's table in the all-sparse mode
        (``stage{i}``), for a reader table of ``cap`` rows over ``batch`` x
        ``spatial`` (H, W)."""
        caps = {}
        for i, s in enumerate(self.strides):
            if s > 1:
                caps[f"stage{i}"] = self._stage_capacity(cap, batch, spatial, i)
                spatial = tuple(-(-n // s) for n in spatial)
        return caps

    def forward(self, x, plain: bool = False, telemetry=None, tile_capacity: int | None = None) -> torch.Tensor:
        """SparseBEV or dense (B, H, W, C) -> (B, H', W', out_channels)
        NHWC (resnet.py:531-663).  ``telemetry`` (a dict) receives the
        tables' and tile maps' active and overflow counts; ``plain`` keeps
        CUDA tensors on the kernels' plain versions; ``tile_capacity``
        overrides the configured one (serving's buckets; <= 0: the full
        tile grid)."""
        telemetry = {} if telemetry is None else telemetry
        train = self.training
        start, mask, packed = 0, None, False
        if isinstance(x, SparseBEV):
            sb = x
            use_sparse = not self.force_dense_train and (train or self.sparse_eval)
            mode = self.sparse_stages_train if train else self.sparse_stages_eval
            tiles = self.tile_capacity if tile_capacity is None else int(tile_capacity)
            if use_sparse and mode == "all":
                return self._all_sparse(sb, plain, telemetry, tiles)
            if use_sparse and mode == "leading+down":
                return self._leading_down(sb, plain, telemetry)
            occupied = (sb.slot_of_dense < sb.capacity).reshape(sb.batch, 1, *sb.spatial)
            if self.n_sparse and use_sparse and mode == "tile":
                x = self._tile_prefix(sb, plain, telemetry, tiles)
                start = self.n_sparse
            elif self.n_sparse and use_sparse:
                nbr = build_neighbor_table(
                    sb.slot_of_dense, sb.slot_id, sb.spatial,
                    subm_offsets_2d(self.kernel_size[0]), sb.capacity,
                )
                feats = sb.table[:-1]
                for i in range(self.n_sparse):
                    feats = sparse_stage(self.blocks[i], feats, sb.valid, nbr, self._sparse_remat)
                start = self.n_sparse
                h, w = sb.spatial
                packed = (not train and self.packed_downsample and start < len(self.layer_nums)
                          and self.strides[start] == 2 and self.kernel_size[start] == 3
                          and h % 2 == 0 and w % 2 == 0)
                sb = sb.with_table(feats)
                x = sb.to_dense_packed(plain=plain) if packed else sb.to_dense(plain=plain)
            else:
                x = sb.to_dense(plain=plain)
            if train or self.masked_eval:
                mask = occupied.float()
        elif not (isinstance(x, torch.Tensor) and x.dim() == 4):
            raise TypeError("SparseResNet takes a SparseBEV or a dense (B, H, W, C) image")
        return self._dense_tail(x.permute(0, 3, 1, 2), mask, start, packed)

    def _dense_tail(self, x, mask, start: int, packed: bool = False) -> torch.Tensor:
        """Stages ``start``.. and the 1x1 mapping as dense convs over NCHW
        ``x``; with ``mask`` (B, 1, H, W) at ``x``'s grid each block is
        restricted to the active set, the mask dilating at each strided
        stage (a strided SparseConv output site is active if any input site
        in its k x k window is).  ``packed``: ``x`` is 2x2-packed for stage
        ``start``'s down conv.  Returns NHWC."""
        for i in range(start, len(self.layer_nums)):
            s, k = self.strides[i], self.kernel_size[i]
            if mask is not None and s > 1:
                mask = F.max_pool2d(mask, k, s, k // 2)
            m = None if mask is None else mask.to(x.dtype)
            for j, block in enumerate(self.blocks[i]):
                if packed and i == start and j == 0:
                    x = block(x, m, packed=True)
                elif self.training and self.remat_train:
                    x = recomputed(block, x, m)
                else:
                    x = block(x, m)
        m = None if mask is None else mask.to(x.dtype)
        x = torch.relu(self.mapping[1](conv2d(x, self.mapping[0]), valid=m))
        if m is not None:
            x = x * m
        return x.permute(0, 2, 3, 1)

    @property
    def _sparse_remat(self):
        """``run_block``'s ``remat`` for a SubM or strided block."""
        return self.remat_save_conv_out if self.training else None

    @property
    def _tile_remat(self):
        """``run_block``'s ``remat`` for a tile block: no policy."""
        return False if self.training else None

    def _tile_map_for(self, sod, slot_id, batch, spatial, site_cap, tiles: int, frac: float,
                      tag: str, telemetry: dict):
        """A TileMap of ``tile_slots`` slots at one resolution and its
        telemetry (resnet.py:665-689)."""
        h = spatial[0]
        cap = self.tile_slots(tiles, batch, spatial, frac)
        tm = build_tile_map(sod, slot_id, batch, spatial, site_cap, self.tile_size, cap)
        telemetry[f"{tag}_tiles{h}_active"] = tm.n_tiles
        telemetry[f"{tag}_tiles{h}_overflow"] = torch.clamp(tm.n_tiles - cap, min=0)
        return tm

    def _tile_prefix(self, sb: SparseBEV, plain: bool, telemetry: dict, tiles: int) -> torch.Tensor:
        """The leading stride-1 stages over the active-tile stack, densified
        from the stack (resnet.py:691-717); NHWC."""
        if len(sb.spatial) != 2 or any(k != 3 for k in self.kernel_size[:self.n_sparse]):
            raise ValueError(
                "sparse_stages='tile' requires a 2-D BEV grid and 3x3 stride-1 kernels (got "
                f"spatial={tuple(sb.spatial)}, kernel_size={tuple(self.kernel_size[:self.n_sparse])}); "
                "use sparse_stages='leading' for this configuration")
        tm = self._tile_map_for(sb.slot_of_dense, sb.slot_id, sb.batch, sb.spatial, sb.capacity,
                                tiles, 1.0, "prefix", telemetry)
        stack = pack_stack(sb.table, tm, plain)
        for i in range(self.n_sparse):
            stack = tile_stage(self.blocks[i], stack, tm, plain, self._tile_remat)
        return stack_to_dense(stack, tm, plain)

    def _down(self, i: int, cap0: int, table, valid, sod, slot_id, batch, spatial, telemetry: dict,
              remat=None):
        """Stage ``i``'s set-dilating strided conv block into a table of its
        own, sized from the reader's capacity ``cap0`` (``stage{i}_active``
        / ``_overflow``); in training with the reverse tap table of its
        backward, run by ``run_block`` with ``remat``.  Returns (table,
        out_valid, out_sod, out_slot_id, out_spatial, cap_out)."""
        k, s = self.kernel_size[i], self.strides[i]
        cap_out = self._stage_capacity(cap0, batch, spatial, i)
        out_slot_id, out_sod, out_valid, out_sp, n_out = downsample_active_set(
            sod, valid.shape[0], batch, spatial, (k, k), (s, s), cap_out
        )
        telemetry[f"stage{i}_active"] = n_out
        telemetry[f"stage{i}_overflow"] = torch.clamp(n_out - cap_out, min=0)
        block = self.blocks[i][0]
        if self.training:
            nbr_fwd, nbr_rev = build_down_neighbor_tables(
                sod, out_slot_id, slot_id, batch, spatial, (k, k), (s, s)
            )
            table = run_block(sparse_strided_block, block, table, out_valid, nbr_fwd, nbr_rev, remat=remat)
        else:
            nbr_fwd = down_neighbor_table(sod, out_slot_id, valid.shape[0], batch, spatial, (k, k), (s, s))
            table = sparse_down_block_eval(block.conv, block.norm, table, out_valid, nbr_fwd)
        return table, out_valid, out_sod, out_slot_id, tuple(out_sp), cap_out

    def _all_sparse(self, sb: SparseBEV, plain: bool, telemetry: dict, tiles: int) -> torch.Tensor:
        """The whole backbone over compact tables (resnet.py:719-805); with
        ``tile_stride1`` its stride-1 stages over the tile stack."""
        batch, spatial = sb.batch, tuple(sb.spatial)
        table, valid, sod, slot_id = sb.table[:-1], sb.valid, sb.slot_of_dense, sb.slot_id
        for i, stage in enumerate(self.blocks):
            k, s = self.kernel_size[i], self.strides[i]
            if s == 1 and self.tile_stride1 and len(spatial) == 2 and k == 3:
                tm = self._tile_map_for(sod, slot_id, batch, spatial, valid.shape[0], tiles,
                                        float(self.stage_capacity_frac[i]), f"stage{i}", telemetry)
                stack = tile_stage(stage, pack_stack(table, tm, plain), tm, plain, self._tile_remat)
                table = unpack_stack(stack, tm, plain)
                continue
            if s > 1:
                table, valid, sod, slot_id, spatial, _ = self._down(
                    i, sb.capacity, table, valid, sod, slot_id, batch, spatial, telemetry,
                    self._sparse_remat)
                stage = stage[1:]
            nbr = build_neighbor_table(sod, slot_id, spatial, subm_offsets_2d(k), valid.shape[0])
            if s == 1:
                table = sparse_stage(stage, table, valid, nbr, self._sparse_remat)
            else:
                for block in stage:
                    table = run_block(sparse_residual_block, block, table, valid, nbr,
                                      remat=self._sparse_remat)
        # 1x1 mapping = SubM conv whose only tap is the site itself
        nbr1 = build_neighbor_table(sod, slot_id, spatial, np.zeros((1, 2), np.int32), valid.shape[0])
        y = subm_conv(_with_dump_row(table), nbr1, _subm_kernel(self.mapping[0]))
        y = self.mapping[1](y, channel_dim=-1, valid=valid)
        table = torch.where(valid[:, None], torch.relu(y), 0.0)
        out = SparseBEV(_with_dump_row(table), valid, sod, slot_id, batch, spatial)
        return out.to_dense(plain=plain)

    def _leading_down(self, sb: SparseBEV, plain: bool, telemetry: dict) -> torch.Tensor:
        """The sparse prefix and the first strided stage's down conv over
        compact tables, densified at that stage's grid; its residual blocks
        and the rest masked-dense (resnet.py:807-911)."""
        i = self.n_sparse
        if i >= len(self.layer_nums):
            raise ValueError("sparse_stages='leading+down' needs a strided stage after the stride-1 prefix")
        batch, spatial = sb.batch, tuple(sb.spatial)
        table = sb.table[:-1]
        if i:
            nbr = build_neighbor_table(sb.slot_of_dense, sb.slot_id, spatial,
                                       subm_offsets_2d(self.kernel_size[0]), sb.capacity)
            for j in range(i):
                table = sparse_stage(self.blocks[j], table, sb.valid, nbr, self._sparse_remat)
        table, out_valid, out_sod, out_slot_id, out_sp, cap_out = self._down(
            i, sb.capacity, table, sb.valid, sb.slot_of_dense, sb.slot_id, batch, spatial, telemetry)
        x = SparseBEV(_with_dump_row(table), out_valid, out_sod, out_slot_id, batch, out_sp)
        x = x.to_dense(plain=plain).permute(0, 3, 1, 2)
        mask = None
        if self.training or self.masked_eval:
            mask = (out_sod < cap_out).reshape(batch, 1, *out_sp).float()
        m = None if mask is None else mask.to(x.dtype)
        for block in self.blocks[i][1:]:
            x = block(x, m)
        return self._dense_tail(x, mask, i + 1)


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
    too.  Each SubM block (a stride-1 stage's conv block and every
    residual block) is recomputed in the backward as JAX remats it
    (resnet.py:1031-1036), keeping each sparse conv's output with
    ``remat_save_conv_out`` (the default) and only its input without it;
    the strided blocks, the extra z-conv and the mapping run bare, as in
    JAX."""

    def __init__(
        self,
        layer_nums: Sequence[int],
        ds_layer_strides: Sequence[int],
        ds_num_filters: Sequence[int],
        num_input_features: int,
        kernel_size: Sequence[int] = (3, 3, 3, 3),
        out_channels: int = 128,
        stage_capacity_frac: Sequence[float] = (1.0, 1.5, 0.9, 0.4, 0.25),
        remat_save_conv_out: bool = True,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.layer_nums = tuple(int(n) for n in layer_nums)
        self.strides = tuple(int(s) for s in ds_layer_strides)
        self.kernel_size = tuple(int(k) for k in kernel_size)
        self.stage_capacity_frac = tuple(float(f) for f in stage_capacity_frac)
        self.remat_save_conv_out = bool(remat_save_conv_out)
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
        if isinstance(sb, torch.Tensor) and sb.dim() == 5:
            return self._dense_forward(sb)
        if not isinstance(sb, SparseBEV) or len(sb.spatial) != 3:
            raise TypeError(
                "SparseResNet3D takes the voxel reader's SparseBEV over (D, H, W) "
                "or its dense (B, D, H, W, C) volume"
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
                table = sparse_strided_block(SimpleNamespace(conv=conv, norm=norm), table, out_valid,
                                             nbr_fwd, nbr_rev)
            else:
                nbr_fwd = down_neighbor_table(
                    sod, out_slot_id, valid.shape[0], batch, spatial, kernel_shape, stride, padding
                )
                table = sparse_down_block_eval(conv, norm, table, out_valid, nbr_fwd)
            valid, sod, slot_id, spatial = out_valid, out_sod, out_slot_id, out_sp
            return table

        remat = self.remat_save_conv_out if self.training else None
        for i, stage in enumerate(self.blocks):
            k, s = self.kernel_size[i], self.strides[i]
            if s > 1:
                table = down(table, (k,) * 3, (s,) * 3, None, f"stage{i}", stage[0].conv, stage[0].norm)
            nbr = build_neighbor_table(sod, slot_id, spatial, subm_offsets_3d(k), valid.shape[0])
            if s == 1:
                table = run_block(sparse_conv_block, stage[0], table, valid, nbr, remat=remat)
            for block in stage[1:]:
                table = run_block(sparse_residual_block, block, table, valid, nbr, remat=remat)
        table = down(table, *EXTRA_Z_DOWN, "extra", *self.extra_conv)

        # SubM 1x1x1 mapping: the site's own row only
        y = table @ _subm_kernel(self.mapping.conv)[0].to(table.dtype)
        y = self.mapping.norm(y, channel_dim=-1, valid=valid)
        table = torch.where(valid[:, None], torch.relu(y), 0.0)

        out = SparseBEV(_with_dump_row(table), valid, sod, slot_id, batch, spatial)
        dense = out.to_dense(plain=plain)  # (B, D, H, W, C)
        b, d, h, w, c = dense.shape
        return dense.permute(0, 2, 3, 1, 4).reshape(b, h, w, d * c)

    def _dense_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The dense 3-D stack (resnet.py:960-1013) over a (B, D, H, W, C)
        volume, channels-last in memory: per stage a (k, k, k) conv at
        stride s with padding k // 2 on every axis, BN, ReLU, then the
        two-conv residual blocks; the extra (3, 1, 1) / (2, 1, 1) conv with
        padding 0; the 1x1x1 mapping; the depth-major fold to (B, H', W',
        D' * C).  The same modules and weights as the sparse path (JAX's
        dense tree names them ``Conv_i`` / ``BatchNorm_i`` in this call
        order).  Its BatchNorm is flax's ``nn.BatchNorm``: in training the
        statistics run over every cell of the volume, empty ones too."""

        def conv(x, weight, stride=1, padding=None):
            pad = weight.shape[-1] // 2 if padding is None else padding
            w = weight.to(x.dtype).contiguous(memory_format=torch.channels_last_3d)
            return F.conv3d(x, w, stride=stride, padding=pad)

        x = x.permute(0, 4, 1, 2, 3)  # (B, C, D, H, W), channels-last in memory
        for stage, s in zip(self.blocks, self.strides):
            x = torch.relu(stage[0].norm(conv(x, stage[0].conv.weight, s)))
            for block in stage[1:]:
                y = torch.relu(block.block1.norm(conv(x, block.block1.conv.weight)))
                x = torch.relu(block.norm2(conv(y, block.conv2.weight)) + x)
        _, stride, padding = EXTRA_Z_DOWN
        x = torch.relu(self.extra_conv[1](conv(x, self.extra_conv[0].weight, stride, padding)))
        x = torch.relu(self.mapping.norm(conv(x, self.mapping.conv.weight)))
        b, c, d, h, w = x.shape
        return x.permute(0, 3, 4, 2, 1).reshape(b, h, w, d * c)

