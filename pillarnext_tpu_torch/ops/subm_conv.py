"""Submanifold sparse convolution as gather + matmul.

Counterpart of pillarnext_tpu/ops/subm_conv.py:38-283.  Active sites live
in a compact table ``(cap + 1, C)`` whose last row is zero; a ``(cap, K)``
neighbour table holds each tap's slot (``cap`` when inactive), so

    y[s] = concat_k x[nbr[s, k]] @ W        W: (K * Cin, Cout)

The backward is the JAX custom VJP's shared gather (subm_conv.py:212-280):
the active set is closed under mirroring (``nbr[j, k] = i`` iff
``nbr[i, K-1-k] = j``), so one gather of the cotangent ``H[:, m] =
g[nbr[:, m]]`` gives both ``dx[i] = sum_m H[i, m] @ W[K-1-m]^T`` and
``dW[k] = x^T @ H[:, K-1-k]`` (f32 accumulation), instead of the
scatter-add that autograd of the gather would emit.
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


class _SubMConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, nbr, kernel):
        cap, k = nbr.shape
        cin = table.shape[1]
        ctx.save_for_backward(table, nbr, kernel)
        x = table.index_select(0, nbr.reshape(-1).long()).reshape(cap, k * cin)
        return x @ kernel.reshape(k * cin, -1)

    @staticmethod
    def backward(ctx, g):
        table, nbr, kernel = ctx.saved_tensors
        cap, k = nbr.shape
        cin, cout = kernel.shape[1], kernel.shape[2]
        g_pad = torch.cat([g, g.new_zeros((1, cout))])
        h = g_pad.index_select(0, nbr.reshape(-1).long()).reshape(cap, k * cout)
        # tap m of h pairs with the mirrored tap K-1-m of the kernel
        w_t = kernel.flip(0).transpose(1, 2).reshape(k * cout, cin).to(g.dtype)
        dx = torch.cat([h @ w_t, g.new_zeros((1, cin))])
        dk = (table[:cap].t() @ h).reshape(cin, k, cout).flip(1).permute(1, 0, 2)
        return dx.to(table.dtype), None, dk.to(kernel.dtype)


def subm_conv(table: torch.Tensor, nbr: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SubM conv over a compact table.

    Args:
        table: (cap + 1, Cin); row ``cap`` must be zero.
        nbr: (cap, K) neighbour slots.
        kernel: (K, Cin, Cout), cast to the table's dtype.

    Returns:
        (cap, Cout).
    """
    return _SubMConv.apply(table, nbr, kernel.to(table.dtype))
