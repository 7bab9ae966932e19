"""Segment reductions over point buffers (forward only).

Counterpart of pillarnext_tpu/ops/scatter.py:23-123.  Shapes are static:
invalid points go to a dump segment that callers size for.
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


def segment_max(data: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment max; empty segments give 0."""
    out = data.new_zeros((num_segments, data.shape[1]))
    index = seg.long()[:, None].expand_as(data)
    return out.scatter_reduce_(0, index, data, "amax", include_self=False)


def gather_segments(
    table: torch.Tensor, seg: torch.Tensor, zero_dump_row: bool = False, plain: bool = False
) -> torch.Tensor:
    """``table[seg]``.  ``zero_dump_row``: the caller asserts the last row
    is exactly zero, so the row gather (kernel 2 on a CUDA tensor) may read
    the table without it and return zeros for the dump id — bit-identical.
    ``plain`` keeps CUDA tensors on ``index_select`` (for comparisons)."""
    if zero_dump_row and not plain:
        return monotone_row_gather(table[:-1], seg.int())
    return table.index_select(0, seg.long())
