"""Compact table -> dense grid, with a gather backward.

Counterpart of ``densify`` (pillarnext_tpu/ops/densify.py:29-61).  As the
JAX call site does under ``PNX_PALLAS=1``, the dump row is left off the
table and the row gather (kernel 2 on a CUDA tensor) returns zero rows for
the dump slot ``cap`` — bit-identical to gathering the all-zero dump row.

The backward is the JAX custom VJP: every real slot sits at exactly one
dense position (``slot_id``), so ``d table[j] = d dense[slot_id[j]]``, a
row gather too (kernel 2 on a CUDA tensor; unused slots hold an
out-of-range id and read zero), and the dump row's cotangent is 0 — dead
downstream, since the dump row comes from masked points.
"""

from __future__ import annotations

import torch

from pillarnext_tpu_torch.ops.gather import monotone_row_gather, monotone_row_gather_plain


class _Densify(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, slot_of_dense, slot_id, plain):
        ctx.save_for_backward(slot_id)
        ctx.gather = monotone_row_gather_plain if plain else monotone_row_gather
        return ctx.gather(table[:-1], slot_of_dense)

    @staticmethod
    def backward(ctx, g):
        (slot_id,) = ctx.saved_tensors
        d_real = ctx.gather(g.contiguous(), slot_id)
        return torch.cat([d_real, g.new_zeros((1, g.shape[1]))]), None, None, None


def densify(table: torch.Tensor, slot_of_dense: torch.Tensor, slot_id: torch.Tensor,
            plain: bool = False) -> torch.Tensor:
    """(rows, C) = table[slot_of_dense] for a (cap + 1, C) table whose row
    ``cap`` is zero; ``slot_id`` (cap,) is each slot's dense row (``rows``
    when unused).  ``plain`` keeps CUDA tensors on ``index_select``."""
    return _Densify.apply(table, slot_of_dense, slot_id, plain)
