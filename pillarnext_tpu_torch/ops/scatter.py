"""Segment reductions over point buffers.

Counterpart of pillarnext_tpu/ops/scatter.py:23-123.  Shapes are static:
invalid points go to a dump segment that callers size for.  The two
functions that the training path differentiates are autograd Functions
with the JAX package's VJPs: ``gather_segments`` (backward: a segment sum,
scatter.py:55-104) and ``segment_max`` (backward: the cotangent split
evenly among tied maxima, XLA's scatter-max rule).
"""

from __future__ import annotations

import torch

from pillarnext_tpu_torch.ops.gather import monotone_row_gather


def segment_sum(data: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(num_segments, C) sums of ``data`` rows per segment."""
    out = data.new_zeros((num_segments, data.shape[1]))
    return out.index_add_(0, seg.long(), data)


def segment_mean(data: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment mean; empty segments give 0."""
    total = segment_sum(data, seg, num_segments)
    count = segment_sum(data.new_ones((data.shape[0], 1)), seg, num_segments)
    return total / count.clamp(min=1.0)


class _SegmentMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, seg, num_segments):
        index = seg.long()[:, None].expand_as(data)
        raw = data.new_zeros((num_segments, data.shape[1])).scatter_reduce_(
            0, index, data, "amax", include_self=False
        )
        finite = torch.isfinite(raw)
        ctx.save_for_backward(data, seg, raw, finite)
        return torch.where(finite, raw, 0.0)

    @staticmethod
    def backward(ctx, g):
        data, seg, raw, finite = ctx.saved_tensors
        seg = seg.long()
        g = torch.where(finite, g, 0.0)
        won = data == raw.index_select(0, seg)
        ties = torch.zeros(raw.shape, dtype=torch.float32, device=g.device).index_add_(
            0, seg, won.float()
        )
        coef = torch.where(won, 1.0 / ties.index_select(0, seg), 0.0)
        return (g.index_select(0, seg) * coef).to(data.dtype), None, None


def segment_max(data: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment max; empty (and non-finite) segments give 0.  Backward:
    each segment's cotangent goes to its maxima, split evenly among ties."""
    return _SegmentMax.apply(data, seg, num_segments)


class _GatherSegments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, seg, zero_dump_row, plain):
        ctx.save_for_backward(seg)
        ctx.num_segments = table.shape[0]
        if zero_dump_row and not plain:
            return monotone_row_gather(table[:-1], seg.int())
        return table.index_select(0, seg.long())

    @staticmethod
    def backward(ctx, g):
        (seg,) = ctx.saved_tensors
        return segment_sum(g, seg, ctx.num_segments), None, None, None


def gather_segments(
    table: torch.Tensor, seg: torch.Tensor, zero_dump_row: bool = False, plain: bool = False
) -> torch.Tensor:
    """``table[seg]`` with a segment-sum backward.  ``zero_dump_row``: the
    caller asserts the last row is exactly zero, so the row gather (kernel 2
    on a CUDA tensor) may read the table without it and return zeros for
    the dump id — bit-identical.  ``plain`` keeps CUDA tensors on
    ``index_select`` (for comparisons)."""
    return _GatherSegments.apply(table, seg, zero_dump_row, plain)
