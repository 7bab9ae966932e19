"""Sparse strided convolution over compact tables, active-set dilating.

Counterpart of pillarnext_tpu/ops/sparse_down.py:39-268 (spconv's
``SparseConv2d`` / ``SparseConv3d`` with stride > 1).  An output site is active iff its
receptive window covers at least one active input site; its value is the
windowed sum over the input features (inactive inputs contribute zero).

1. ``downsample_active_set``: the dilated output set is a max-pool of the
   input occupancy; compact slots follow ascending dense ids by one prefix
   sum and a binary search per slot (no sort, no scatter, no host
   synchronisation).
2. ``down_neighbor_table``: per output slot the K strided-tap input slots;
   ``build_down_neighbor_tables`` adds per input slot the K output slots
   it feeds (reverse, for the backward).
3. ``sparse_strided_conv``: a K * Cin gather and one matmul; the backward
   is a reverse gather of the cotangent feeding both ``dx`` and ``dW``.

Convention: kernel tap t (row-major over the kernel, pad p = k // 2 unless
given, stride s) reads input coordinate ``s * oc + t - p`` of output
coordinate ``oc`` — torch's strided cross-correlation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pillarnext_tpu_torch.ops.subm_conv import box_taps, conv_forward, gather_matmul, row_major_strides


def out_spatial_for(spatial, kernel_shape, stride, padding=None) -> tuple:
    """spconv output size: floor((n + 2p - k) / s) + 1, p = k // 2 by default."""
    if padding is None:
        padding = tuple(k // 2 for k in kernel_shape)
    return tuple(
        (n + 2 * p - k) // s + 1 for n, k, s, p in zip(spatial, kernel_shape, stride, padding)
    )


_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}


def downsample_active_set(
    slot_of_dense: torch.Tensor,
    cap_in: int,
    batch: int,
    in_spatial: tuple,
    kernel_shape: tuple,
    stride: tuple,
    cap_out: int,
    padding: tuple | None = None,
):
    """Active output set of a 2-D or 3-D strided sparse conv.

    Args:
        slot_of_dense: (B * prod(in_spatial),) int32 dense -> slot map of
            the input set (``cap_in`` where empty); only occupancy is read.
        padding: per spatial dim, ``k // 2`` by default; the 3-D backbone's
            extra z-downsample uses 0.

    Returns (out_slot_id (cap_out,) int32, out_slot_of_dense (B *
    prod(out_spatial),) int32, out_valid (cap_out,) bool, out_spatial,
    n_out ()) — ``n_out`` is the true dilated count; ``n_out > cap_out``
    means sites were dropped (callers report it as overflow telemetry).
    """
    if padding is None:
        padding = tuple(k // 2 for k in kernel_shape)
    out_sp = out_spatial_for(in_spatial, kernel_shape, stride, padding)
    out_rows = batch * int(np.prod(out_sp))
    # occupancy in the narrowest dtype max-pooling takes on CUDA: at the
    # voxel18 grid it is 72.3M cells; 0/1 are exact in bf16
    occ = (slot_of_dense < cap_in).to(torch.bfloat16).reshape(batch, 1, *in_spatial)
    pooled = _MAX_POOL[len(in_spatial)](occ, kernel_shape, stride, padding).reshape(-1)
    out_mask = pooled > 0
    counts = torch.cumsum(out_mask, 0, dtype=torch.int32)
    n_out = counts[-1]
    slots = counts - 1
    occupied = out_mask & (slots < cap_out)
    out_sod = torch.where(occupied, slots, cap_out).to(torch.int32)
    # slot -> dense id: slot j sits at the first cell whose running count
    # reaches j + 1, and past the last occupied cell at ``out_rows``
    want = torch.arange(1, cap_out + 1, dtype=torch.int32, device=slot_of_dense.device)
    out_slot_id = torch.searchsorted(counts, want, out_int32=True)
    return out_slot_id, out_sod, out_slot_id < out_rows, out_sp, n_out


def down_neighbor_table(
    in_slot_of_dense: torch.Tensor,
    out_slot_id: torch.Tensor,
    cap_in: int,
    batch: int,
    in_spatial: tuple,
    kernel_shape: tuple,
    stride: tuple,
    padding: tuple | None = None,
) -> torch.Tensor:
    """(cap_out, K) int32 input slot of each output slot's strided tap,
    ``cap_in`` where inactive; K = prod(kernel_shape), taps row-major over
    the kernel (z-major in 3-D), all at once."""
    if padding is None:
        padding = tuple(k // 2 for k in kernel_shape)
    in_sp = tuple(int(v) for v in in_spatial)
    out_sp = out_spatial_for(in_sp, kernel_shape, stride, padding)
    out_cell, in_cell = int(np.prod(out_sp)), int(np.prod(in_sp))
    o = out_slot_id.long()
    ok_o = o < batch * out_cell
    o = torch.where(ok_o, o, 0)
    rem = o % out_cell
    ok, did = ok_o[:, None], ((o // out_cell) * in_cell)[:, None]
    taps = box_taps(kernel_shape, out_slot_id.device)
    for tap, s, p, n, n_out, out_st, in_st in zip(
        taps, stride, padding, in_sp, out_sp, row_major_strides(out_sp), row_major_strides(in_sp)
    ):
        ic = (rem // out_st % n_out)[:, None] * s + (tap - p)[None, :]
        ok = ok & (ic >= 0) & (ic < n)
        did = did + ic * in_st
    did = torch.where(ok, did, 0)
    return torch.where(ok, in_slot_of_dense[did], cap_in).to(torch.int32)


def build_down_neighbor_tables(
    in_slot_of_dense: torch.Tensor,
    out_slot_id: torch.Tensor,
    in_slot_id: torch.Tensor,
    batch: int,
    in_spatial: tuple,
    kernel_shape: tuple,
    stride: tuple,
    padding: tuple | None = None,
):
    """(nbr_fwd (cap_out, K) -> input slots, nbr_rev (cap_in, K) -> output
    slots), K = prod(kernel_shape); inactive entries hold the dump index
    (cap_in, cap_out).  The reverse table is the adjoint of the forward
    one (``rev[i, t] = o`` iff ``fwd[o, t] = i``), built by one scatter
    with unique targets."""
    cap_in = in_slot_id.shape[0]
    cap_out = out_slot_id.shape[0]
    device = out_slot_id.device
    nbr_fwd = down_neighbor_table(
        in_slot_of_dense, out_slot_id, cap_in, batch, in_spatial, kernel_shape, stride, padding
    )
    nk = nbr_fwd.shape[1]
    o_ids = torch.arange(cap_out, dtype=torch.long, device=device)
    # inactive taps write distinct shadow rows past cap_in
    target = torch.where(nbr_fwd < cap_in, nbr_fwd.long(), cap_in + 1 + o_ids[:, None])
    rev_full = torch.full(((cap_in + 1 + cap_out) * nk,), cap_out, dtype=torch.int32, device=device)
    flat = target * nk + torch.arange(nk, device=device)[None, :]
    rev_full.scatter_(0, flat.reshape(-1), o_ids[:, None].expand(cap_out, nk).reshape(-1).to(torch.int32))
    nbr_rev = rev_full.reshape(cap_in + 1 + cap_out, nk)[:cap_in]
    return nbr_fwd, nbr_rev


class _SparseStridedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, nbr_fwd, nbr_rev, kernel):
        ctx.save_for_backward(table, nbr_rev, kernel)
        return conv_forward(lambda: gather_matmul(table, nbr_fwd, kernel))

    @staticmethod
    def backward(ctx, g):
        table, nbr_rev, kernel = ctx.saved_tensors
        k, cin, cout = kernel.shape
        cap_in = nbr_rev.shape[0]
        g_pad = torch.cat([g, g.new_zeros((1, cout))])
        gr = g_pad.index_select(0, nbr_rev.reshape(-1).long()).reshape(cap_in, k * cout)
        w_t = kernel.transpose(1, 2).reshape(k * cout, cin).to(g.dtype)
        dx = torch.cat([gr @ w_t, g.new_zeros((1, cin))])
        dk = (table[:cap_in].t() @ gr).reshape(cin, k, cout).permute(1, 0, 2)
        return dx.to(table.dtype), None, None, dk.to(kernel.dtype)


def sparse_strided_conv(table, nbr_fwd, nbr_rev, kernel) -> torch.Tensor:
    """Strided sparse conv over compact tables.

    Args:
        table: (cap_in + 1, Cin); row cap_in is the all-zero dump row.
        nbr_fwd: (cap_out, K) int32 input slot per tap (cap_in = inactive).
        nbr_rev: (cap_in, K) int32 output slot per tap (cap_out = none).
        kernel: (K, Cin, Cout), cast to the table's dtype.

    Returns:
        (cap_out, Cout).
    """
    return _SparseStridedConv.apply(table, nbr_fwd, nbr_rev, kernel.to(table.dtype))
