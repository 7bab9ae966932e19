"""BEV ResNet backbone, eval ``leading`` path.

Counterpart of ``SparseResNet`` (pillarnext_tpu/models/resnet.py:445-663)
with ``sparse_eval=True``, ``sparse_stages_eval="leading"`` and
``masked_eval=True``: the leading stride-1 stages run as SubM convs over
the compact table (gather + matmul), the result is densified (kernel 2 on
a CUDA tensor), and the strided stages and the 1x1 mapping run as dense
convs re-masked to the active set after every block, the mask dilating
like spconv's strided SparseConv.  Spconv active-set semantics are exact.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pillarnext_tpu_torch.models.layers import (
    BN_EPS_SPARSE,
    BatchNorm,
    ConvBlock,
    ResidualBlock,
    conv2d,
)
from pillarnext_tpu_torch.ops.sparse_bev import SparseBEV
from pillarnext_tpu_torch.ops.subm_conv import build_neighbor_table, subm_conv, subm_offsets_2d


def _subm_kernel(conv: nn.Conv2d) -> torch.Tensor:
    """Conv2d weight (O, I, kh, kw) -> SubM kernel (kh * kw, I, O), taps
    row-major like ``subm_offsets_2d``."""
    o, i, kh, kw = conv.weight.shape
    return conv.weight.permute(2, 3, 1, 0).reshape(kh * kw, i, o)


def sparse_conv_block(block: ConvBlock, x, valid, nbr):
    """SubM conv + BN + ReLU over the compact table (resnet.py:111-131)."""
    table = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    y = block.norm(subm_conv(table, nbr, _subm_kernel(block.conv)), channel_dim=-1)
    return torch.where(valid[:, None], torch.relu(y), 0.0)


def sparse_residual_block(block: ResidualBlock, x, valid, nbr):
    """SubM residual block over the compact table (resnet.py:134-157)."""
    y = sparse_conv_block(block.block1, x, valid, nbr)
    table = torch.cat([y, y.new_zeros((1, y.shape[1]))])
    y = block.norm2(subm_conv(table, nbr, _subm_kernel(block.conv2)), channel_dim=-1)
    return torch.where(valid[:, None], torch.relu(y + x), 0.0)


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
        packed_downsample: bool = False,
        stage_capacity_frac: Sequence[float] = (1.0, 1.0, 0.5, 0.25),
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        # stage_capacity_frac sizes the train path's per-stage tables (not
        # ported yet); the eval path here has no per-stage tables
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
            stage = [ConvBlock(in_ch, ch, k, stride=self.strides[i], eps=BN_EPS_SPARSE)]
            stage += [ResidualBlock(ch, k, eps=BN_EPS_SPARSE) for _ in range(n_blocks)]
            blocks.append(nn.ModuleList(stage))
            in_ch = ch
        self.blocks = nn.ModuleList(blocks)
        # reference schema: mapping.0 = conv, mapping.1 = BN
        self.mapping = nn.Sequential(
            nn.Conv2d(in_ch, out_channels, 1, bias=False), BatchNorm(out_channels, BN_EPS_SPARSE)
        )

    def forward(self, sb: SparseBEV, plain: bool = False) -> torch.Tensor:
        if not isinstance(sb, SparseBEV):
            raise TypeError("SparseResNet takes the reader's SparseBEV (reader.output='sparse')")
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
