"""Exact top-k with ``lax.top_k``'s tie order.

Counterpart of ``exact_top_k`` (pillarnext_tpu/ops/topk.py:31-79).
``torch.topk`` does not promise an order among equal scores; a stable
descending sort over the lane keeps ascending index among ties, which is
``lax.top_k``'s order.
"""

from __future__ import annotations

import torch


def exact_top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, N) scores -> (values (L, k), indices (L, k)), descending; equal
    scores in ascending index order.  For non-NaN input."""
    values, indices = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
