"""Sparse strided convolution over compact tables, active-set dilating.

Counterpart of pillarnext_tpu/ops/sparse_down.py:39-268 (spconv's
``SparseConv2d`` with stride > 1).  An output site is active iff its
receptive window covers at least one active input site; its value is the
windowed sum over the input features (inactive inputs contribute zero).

1. ``downsample_active_set``: the dilated output set is a max-pool of the
   input occupancy; compact slots follow ascending dense ids by one prefix
   sum (no sort, no host synchronisation).
2. ``build_down_neighbor_tables``: per output slot the K strided-tap input
   slots (forward), and per input slot the K output slots it feeds
   (reverse, for the backward).
3. ``sparse_strided_conv``: a K * Cin gather and one matmul; the backward
   is a reverse gather of the cotangent feeding both ``dx`` and ``dW``.

Convention: kernel tap t (row-major over the kernel, pad p = k // 2,
stride s) reads input coordinate ``s * oc + t - p`` of output coordinate
``oc`` — torch's strided cross-correlation.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F


def out_spatial_for(spatial, kernel_shape, stride, padding=None) -> tuple:
    """spconv output size: floor((n + 2p - k) / s) + 1, p = k // 2 by default."""
    if padding is None:
        padding = tuple(k // 2 for k in kernel_shape)
    return tuple(
        (n + 2 * p - k) // s + 1 for n, k, s, p in zip(spatial, kernel_shape, stride, padding)
    )


def downsample_active_set(
    slot_of_dense: torch.Tensor,
    cap_in: int,
    batch: int,
    in_spatial: tuple,
    kernel_shape: tuple,
    stride: tuple,
    cap_out: int,
):
    """Active output set of a 2-D strided sparse conv.

    Args:
        slot_of_dense: (B * H * W,) int32 dense -> slot map of the input set
            (``cap_in`` where empty); only occupancy is read.

    Returns (out_slot_id (cap_out,) int32, out_slot_of_dense (B * H' * W',)
    int32, out_valid (cap_out,) bool, out_spatial, n_out ()) — ``n_out`` is
    the true dilated count; ``n_out > cap_out`` means sites were dropped
    (callers report it as overflow telemetry).
    """
    out_sp = out_spatial_for(in_spatial, kernel_shape, stride)
    out_rows = batch * int(np.prod(out_sp))
    occ = (slot_of_dense < cap_in).float().reshape(batch, 1, *in_spatial)
    pooled = F.max_pool2d(
        occ, kernel_shape, stride, tuple(k // 2 for k in kernel_shape)
    ).reshape(-1)
    out_mask = pooled > 0
    slots = torch.cumsum(out_mask, 0, dtype=torch.int32) - 1
    n_out = slots[-1] + 1
    occupied = out_mask & (slots < cap_out)
    out_sod = torch.where(occupied, slots, cap_out).to(torch.int32)
    # slot -> dense id; every overflowing or empty cell writes the shadow
    # row cap_out, which is cut off
    idx = torch.where(occupied, slots, cap_out).long()
    out_slot_id = torch.full((cap_out + 1,), out_rows, dtype=torch.int32, device=slot_of_dense.device)
    out_slot_id.scatter_(
        0, idx, torch.arange(out_rows, dtype=torch.int32, device=slot_of_dense.device)
    )
    out_slot_id = out_slot_id[:cap_out]
    return out_slot_id, out_sod, out_slot_id < out_rows, out_sp, n_out


def build_down_neighbor_tables(
    in_slot_of_dense: torch.Tensor,
    out_slot_id: torch.Tensor,
    in_slot_id: torch.Tensor,
    batch: int,
    in_spatial: tuple,
    kernel_shape: tuple,
    stride: tuple,
):
    """(nbr_fwd (cap_out, K) -> input slots, nbr_rev (cap_in, K) -> output
    slots), K = prod(kernel_shape); inactive entries hold the dump index
    (cap_in, cap_out).  The reverse table is the adjoint of the forward
    one (``rev[i, t] = o`` iff ``fwd[o, t] = i``), built by one scatter
    with unique targets."""
    out_sp = out_spatial_for(in_spatial, kernel_shape, stride)
    cap_in = in_slot_id.shape[0]
    cap_out = out_slot_id.shape[0]
    device = out_slot_id.device
    h_in, w_in = (int(v) for v in in_spatial)
    h_out, w_out = (int(v) for v in out_sp)

    o = out_slot_id.long()
    ok_o = o < batch * h_out * w_out
    o = torch.where(ok_o, o, 0)
    ob, rem = o // (h_out * w_out), o % (h_out * w_out)
    oy, ox = rem // w_out, rem % w_out
    fwd = []
    for ty, tx in itertools.product(range(kernel_shape[0]), range(kernel_shape[1])):
        iy = oy * stride[0] + ty - kernel_shape[0] // 2
        ix = ox * stride[1] + tx - kernel_shape[1] // 2
        ok = ok_o & (iy >= 0) & (iy < h_in) & (ix >= 0) & (ix < w_in)
        did = torch.where(ok, (ob * h_in + iy) * w_in + ix, 0)
        fwd.append(torch.where(ok, in_slot_of_dense[did], cap_in))
    nbr_fwd = torch.stack(fwd, dim=-1).to(torch.int32)

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
        cap_out, k = nbr_fwd.shape
        cin = table.shape[1]
        ctx.save_for_backward(table, nbr_rev, kernel)
        x = table.index_select(0, nbr_fwd.reshape(-1).long()).reshape(cap_out, k * cin)
        return x @ kernel.reshape(k * cin, -1)

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
