"""Segment reductions over point buffers.

Counterpart of pillarnext_tpu/ops/scatter.py:23-123.  Shapes are static:
invalid points go to a dump segment that callers size for.  The two
functions that the training path differentiates are autograd Functions
with the JAX package's VJPs: ``gather_segments`` (backward: a segment sum,
scatter.py:55-104) and ``segment_max`` (backward: the cotangent split
evenly among tied maxima, XLA's scatter-max rule).

Every function here takes segment ids in ascending order, as every caller
has them: ``compactify`` sorts the points stably and the readers reorder
them by its ``order``, so the slot of each sorted point never decreases.
The one exception is ``segment_max``, which takes ids in any order (the
MVF reader's final coarse max runs over ids that do not ascend): its
forward, a ``scatter_reduce(amax)``, is exact in any order, and its
backward counts the ties by an int32 ``scatter_add_``, which gives the
same count in any order.  Nothing checks the order (the tests do).  The
sums run in the same order on every run: kernel 3's ``sum``
(ops/segscan.py, f32 accumulation, no atomics) gives every row its
segment's sum, and each segment then takes its first row, found by a
binary search over the sorted ids.  They never
go through ``index_add_`` or ``scatter_reduce``, whose CUDA versions add
with atomics in an order that changes from run to run.  The ``plain``
routes of the callers compute them the same way.
"""

from __future__ import annotations

import torch

from pillarnext_tpu_torch.ops.gather import monotone_row_gather
from pillarnext_tpu_torch.ops.segscan import sorted_segment_bcast, sorted_segment_bcast_plain


def _segment_starts(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(num_segments + 1,) int64 row offsets: segment ``j`` holds rows
    ``starts[j]:starts[j + 1]`` of the ascending (N,) int32 ``seg``."""
    bounds = torch.arange(num_segments + 1, dtype=seg.dtype, device=seg.device)
    return torch.searchsorted(seg, bounds)


def _segment_sum(data: torch.Tensor, seg: torch.Tensor, starts: torch.Tensor,
                 plain: bool = False) -> torch.Tensor:
    """Kernel 3's per-row segment sums (its plain version with ``plain``),
    then each segment's first row (0 for an empty segment): a gather with
    one source row per segment."""
    if data.shape[0] == 0:
        return data.new_zeros((starts.shape[0] - 1, data.shape[1]))
    bcast = sorted_segment_bcast_plain if plain else sorted_segment_bcast
    rows = bcast(data.contiguous(), seg, "sum")
    first = rows.index_select(0, starts[:-1].clamp(max=rows.shape[0] - 1))
    return torch.where((starts[1:] > starts[:-1])[:, None], first, 0.0)


def segment_sum(data: torch.Tensor, seg: torch.Tensor, num_segments: int,
                plain: bool = False) -> torch.Tensor:
    """(num_segments, C) sums of the f32/bf16 ``data`` rows per segment, for
    an ascending (N,) int32 ``seg``; the same bits on every run.  ``plain``
    keeps CUDA tensors on kernel 3's plain version (for comparisons)."""
    return _segment_sum(data, seg, _segment_starts(seg, num_segments), plain)


def segment_mean(data: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment mean for an ascending ``seg``; empty segments give 0.
    The counts come from the segment offsets, exactly."""
    starts = _segment_starts(seg, num_segments)
    count = (starts[1:] - starts[:-1]).to(data.dtype)[:, None]
    return _segment_sum(data, seg, starts) / count.clamp(min=1.0)


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
        g = torch.where(finite, g, 0.0)
        seg_l = seg.long()
        won = data == raw.index_select(0, seg_l)
        # each row's count of tied maxima in its segment
        count = torch.zeros(raw.shape, dtype=torch.int32, device=raw.device)
        count.scatter_add_(0, seg_l[:, None].expand_as(won), won.int())
        coef = torch.where(won, 1.0 / count.index_select(0, seg_l), 0.0)
        return (g.index_select(0, seg_l) * coef).to(data.dtype), None, None


def segment_max(data: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment max over ids in any order; empty (and non-finite)
    segments give 0.  Backward: each segment's cotangent goes to its
    maxima, split evenly among ties, counted by an int32 ``scatter_add_``
    (an integer sum is the same in any order, so the count is the same on
    every run)."""
    return _SegmentMax.apply(data, seg, num_segments)


class _GatherSegments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, seg, plain):
        ctx.save_for_backward(seg)
        ctx.num_segments = table.shape[0]
        if plain:
            return table.index_select(0, seg.long())
        return monotone_row_gather(table, seg.int())

    @staticmethod
    def backward(ctx, g):
        (seg,) = ctx.saved_tensors
        return segment_sum(g, seg, ctx.num_segments), None, None


def gather_segments(table: torch.Tensor, seg: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """``table[seg]`` for an ascending ``seg`` (every id a row of
    ``table``), with a segment-sum backward (``segment_sum``): the row
    gather, kernel 2 on a CUDA tensor.  The dump row is read as it stands,
    as JAX's ``jnp.take`` reads it: zero unless valid points overflowed
    the table, and then their mean or max, which they get back.
    ``plain`` keeps CUDA tensors on ``index_select`` (for comparisons)."""
    return _GatherSegments.apply(table, seg, plain)
