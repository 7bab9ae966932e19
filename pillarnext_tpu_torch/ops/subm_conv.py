"""Submanifold sparse convolution as gather + matmul (forward only).

Counterpart of pillarnext_tpu/ops/subm_conv.py:38-208.  Active sites live
in a compact table ``(cap + 1, C)`` whose last row is zero; a ``(cap, K)``
neighbour table holds each tap's slot (``cap`` when inactive), so

    y[s] = concat_k x[nbr[s, k]] @ W        W: (K * Cin, Cout)
"""

from __future__ import annotations

import numpy as np
import torch


def subm_offsets_2d(kernel_size: int = 3) -> np.ndarray:
    """Row-major (dy, dx) offsets, centred; K = kernel_size ** 2."""
    r = kernel_size // 2
    return np.array(
        [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)], np.int32
    )


def build_neighbor_table(
    slot_of_dense: torch.Tensor,
    slot_id: torch.Tensor,
    spatial: tuple,
    offsets: np.ndarray,
    cap: int,
) -> torch.Tensor:
    """(cap, K) int32 neighbour slot per tap, ``cap`` when inactive.

    Args:
        slot_of_dense: (B * prod(spatial),) int32 dense position -> slot.
        slot_id: (cap,) int32 dense position of each slot; unused slots hold
            an out-of-range id.
        spatial: (H, W).
        offsets: (K, 2) int32 tap offsets.
        cap: table capacity (the dump slot).
    """
    sizes = [int(s) for s in spatial]
    strides = [int(np.prod(sizes[i + 1:])) for i in range(len(sizes))]
    cell = int(np.prod(sizes))
    d = slot_id.to(torch.int64)
    in_table = d < slot_of_dense.shape[0]
    d_safe = torch.where(in_table, d, 0)
    rem = d_safe % cell
    coords = []
    for stride in strides:
        coords.append(rem // stride)
        rem = rem % stride
    nbrs = []
    dump = torch.full_like(slot_id, cap)
    for off in offsets:
        ok = in_table
        nd = d_safe
        for i, o in enumerate(int(v) for v in off):
            ci = coords[i] + o
            ok = ok & (ci >= 0) & (ci < sizes[i])
            nd = nd + o * strides[i]
        nd = torch.where(ok, nd, 0)
        nbrs.append(torch.where(ok, slot_of_dense[nd], dump))
    return torch.stack(nbrs, dim=-1)


def subm_conv(table: torch.Tensor, nbr: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SubM conv over a compact table.

    Args:
        table: (cap + 1, Cin); row ``cap`` must be zero.
        nbr: (cap, K) neighbour slots.
        kernel: (K, Cin, Cout).

    Returns:
        (cap, Cout).
    """
    cap, k = nbr.shape
    cin = table.shape[1]
    x = table.index_select(0, nbr.reshape(-1).long()).reshape(cap, k * cin)
    return x @ kernel.reshape(k * cin, -1).to(table.dtype)
