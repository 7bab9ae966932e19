"""Compact table -> dense grid (forward only).

Counterpart of ``densify`` (pillarnext_tpu/ops/densify.py:29-61).  As the
JAX call site does under ``PNX_PALLAS=1``, the dump row is left off the
table and the row gather (kernel 2 on a CUDA tensor) returns zero rows for
the dump slot ``cap`` — bit-identical to gathering the all-zero dump row.
"""

from __future__ import annotations

import torch

from pillarnext_tpu_torch.ops.gather import monotone_row_gather, monotone_row_gather_plain


def densify(table: torch.Tensor, slot_of_dense: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """(rows, C) = table[slot_of_dense] for a (cap + 1, C) table whose row
    ``cap`` is zero.  ``plain`` keeps CUDA tensors on ``index_select``."""
    gather = monotone_row_gather_plain if plain else monotone_row_gather
    return gather(table[:-1], slot_of_dense)
