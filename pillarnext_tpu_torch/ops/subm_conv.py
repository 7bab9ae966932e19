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

Both backwards need only the conv's input table, its tap tables and its
kernel.  So a block recomputed in the backward under JAX's
``save_only_these_names("sparse_conv_out")`` policy (models/layers.py
``recomputed(..., save_conv_out=True)``) keeps each conv's output from
its first pass (``keeping``) and its replay takes them back in call order
(``replaying``) instead of gathering again: the same bits, one gather
sweep per conv in the whole forward and backward.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def subm_offsets_2d(kernel_size: int = 3) -> np.ndarray:
    """Row-major (dy, dx) offsets, centred; K = kernel_size ** 2."""
    r = kernel_size // 2
    return np.array(
        [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)], np.int32
    )


def subm_offsets_3d(kernel_size: int = 3) -> np.ndarray:
    """Row-major (dz, dy, dx) offsets, centred; K = kernel_size ** 3."""
    r = kernel_size // 2
    return np.array(
        [(dz, dy, dx) for dz in range(-r, r + 1) for dy in range(-r, r + 1) for dx in range(-r, r + 1)],
        np.int32,
    )


def row_major_strides(sizes) -> list:
    """Strides of a row-major array of ``sizes``, in elements."""
    return [int(np.prod(sizes[i + 1:])) for i in range(len(sizes))]


def box_taps(kernel_shape, device) -> list:
    """Per spatial dim, the (K,) int64 index along that dim of each tap of
    a kernel box enumerated row-major (z-major in 3-D), built on ``device``
    from an ``arange``: no host-to-device copy."""
    t = torch.arange(int(np.prod(kernel_shape)), device=device)
    return [t // int(np.prod(kernel_shape[i + 1:])) % int(k) for i, k in enumerate(kernel_shape)]


def build_neighbor_table(
    slot_of_dense: torch.Tensor,
    slot_id: torch.Tensor,
    spatial: tuple,
    offsets: np.ndarray,
    cap: int,
) -> torch.Tensor:
    """(cap, K) int32 neighbour slot per tap, ``cap`` when inactive.  All
    taps at once, a few launches per spatial dim.

    Args:
        slot_of_dense: (B * prod(spatial),) int32 dense position -> slot.
        slot_id: (cap,) int32 dense position of each slot; unused slots hold
            an out-of-range id.
        spatial: (H, W) or (D, H, W).
        offsets: (K, len(spatial)) int32 tap offsets: a box enumerated
            row-major, as ``subm_offsets_2d`` / ``subm_offsets_3d`` give.
        cap: table capacity (the dump slot).
    """
    offsets = np.asarray(offsets)
    lo = offsets.min(0)
    shape = tuple(int(v) for v in offsets.max(0) - lo + 1)
    box = np.stack(np.meshgrid(*(np.arange(n) for n in shape), indexing="ij"), -1).reshape(-1, len(shape))
    if not np.array_equal(offsets, box + lo):
        raise ValueError("offsets must enumerate a box row-major")
    sizes = [int(s) for s in spatial]
    d = slot_id.to(torch.int64)
    in_table = d < slot_of_dense.shape[0]
    d_safe = torch.where(in_table, d, 0)
    rem = d_safe % int(np.prod(sizes))
    ok, nd = in_table[:, None], d_safe[:, None]
    for tap, low, size, stride in zip(box_taps(shape, slot_id.device), lo, sizes, row_major_strides(sizes)):
        off = tap + int(low)
        c = (rem // stride % size)[:, None] + off[None, :]
        ok = ok & (c >= 0) & (c < size)
        nd = nd + off * stride
    nd = torch.where(ok, nd, 0)
    return torch.where(ok, slot_of_dense[nd], cap).to(torch.int32)


def gather_matmul(table: torch.Tensor, nbr: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``concat_k table[nbr[:, k]] @ kernel`` for a (rows, K) tap table and
    a (K, Cin, Cout) kernel: the forward of every sparse conv."""
    rows, k = nbr.shape
    cin = table.shape[1]
    x = table.index_select(0, nbr.reshape(-1).long()).reshape(rows, k * cin)
    return x @ kernel.reshape(k * cin, -1)


class ConvOutputs:
    """The sparse convs' outputs of one recomputed block, in call order:
    appended by its first pass, handed back once each by its replay."""

    def __init__(self):
        self.outputs: list[torch.Tensor] = []
        self.replay = False
        self.taken = 0

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.outputs)


# the store of the block running now: torch.utils.checkpoint re-enters a
# block only through the contexts its ``context_fn`` gives (models/layers.py
# ``recomputed``), so the conv Functions find the store here
_active: ConvOutputs | None = None


@contextlib.contextmanager
def _using(store: ConvOutputs, replay: bool):
    global _active
    outer, store.replay, store.taken = _active, replay, 0
    _active = store
    try:
        yield
    finally:
        _active = outer


def keeping(store: ConvOutputs):
    """Inside the block, every sparse conv appends its output to ``store``."""
    return _using(store, False)


def replaying(store: ConvOutputs):
    """Inside the block, every sparse conv returns the next output of
    ``store`` and computes nothing."""
    return _using(store, True)


def conv_forward(compute) -> torch.Tensor:
    """``compute()``, the forward of a sparse conv, kept or replayed as the
    active ``ConvOutputs`` says."""
    store = _active
    if store is None:
        return compute()
    if not store.replay:
        out = compute()
        store.outputs.append(out.detach())
        return out
    if store.taken >= len(store.outputs):
        raise RuntimeError("a replayed block ran more sparse convs than its first pass")
    store.taken += 1
    return store.outputs[store.taken - 1].detach()


class _SubMConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, nbr, kernel):
        ctx.save_for_backward(table, nbr, kernel)
        return conv_forward(lambda: gather_matmul(table, nbr, kernel))

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
