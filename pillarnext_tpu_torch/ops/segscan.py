"""Broadcast segmented reduction over a sorted segment stream — kernel 3.

Counterpart of ``sorted_segment_bcast`` (pillarnext_tpu/ops/pallas_segscan.py:124):
for non-decreasing ``seg``, ``out[i]`` is the max (or sum) of ``x`` over
every row of ``seg[i]``'s segment, i.e. ``segment_<reduce>(x, seg)[seg]``.
The JAX package wrote it for the pair its PFN training forward runs
(``scatter.segment_max`` then ``scatter.gather_segments``,
pillarnext_tpu/models/pillar_encoder.py:66-79); the port runs it there, in
``pillar_max_broadcast``.  A CUDA tensor launches ``csrc/segscan.cu``; a CPU
tensor takes the plain version.  ``sum`` accumulates in f32.
"""

from __future__ import annotations

import ctypes

import torch

from pillarnext_tpu_torch.ops import kernels

FLOAT_TYPES = (torch.float32, torch.bfloat16)
REDUCTIONS = {"max": 0, "sum": 1}
TILE = 4096  # rows per block of csrc/segscan.cu's tile kernel
THREADS = 256  # threads per block (csrc/segscan.cu: kThreads)


def _check_reduce(reduce: str) -> None:
    if reduce not in REDUCTIONS:
        raise ValueError(f"reduce must be 'max' or 'sum', got {reduce!r}")


def sorted_segment_bcast_plain(x: torch.Tensor, seg: torch.Tensor, reduce: str = "max") -> torch.Tensor:
    """``scatter_reduce(amax | sum)`` into one row per run of equal ``seg``
    values, then ``index_select`` back.  Runs are ranked by a cumsum over
    the changes of ``seg``, so no host synchronisation sizes the table."""
    _check_reduce(reduce)
    n, c = x.shape
    if n == 0:
        return x.clone()
    first = torch.ones_like(seg, dtype=torch.bool)
    first[1:] = seg[1:] != seg[:-1]
    rank = torch.cumsum(first, 0) - 1
    xs = x if reduce == "max" else x.float()
    table = xs.new_zeros((n, c)).scatter_reduce_(
        0, rank[:, None].expand(n, c), xs, "amax" if reduce == "max" else "sum", include_self=False
    )
    return table.index_select(0, rank).to(x.dtype)


def vector_bytes(x: torch.Tensor, out: torch.Tensor) -> int:
    """The widest chunk (16, 8, 4 or 2 bytes, at least one value) that
    divides a row of ``x`` and the addresses of ``x`` and ``out``: the
    vector width the kernel is launched with.  One value always fits."""
    es = x.element_size()
    row = x.shape[1] * es
    return next(vb for vb in (16, 8, 4, 2)
                if vb >= es and row % vb == 0 and x.data_ptr() % vb == 0 and out.data_ptr() % vb == 0)


def device_launches(n: int) -> int:
    """Device launches of one kernel call on ``n`` rows: the tile kernel,
    and for more than one tile the entries' own launches and the fill."""
    n_tiles = -(-n // TILE)
    return 1 if n_tiles <= 1 else 2 + device_launches(2 * n_tiles)


def _launch(x: torch.Tensor, seg: torch.Tensor, op: int) -> torch.Tensor:
    """csrc/segscan.cu over ``x``: the tile kernel writes every run inside
    a tile and emits each tile's first and last run as f32 entries; the
    entries are resolved by the same launches, recursively, and the fill
    kernel writes those runs' rows from them."""
    n, c = x.shape
    n_tiles = -(-n // TILE)
    dtype = 0 if x.dtype == torch.float32 else 1
    out = torch.empty_like(x)
    vb = vector_bytes(x, out)
    if n_tiles == 1:
        kernels.launch("pnx_segscan_tiles", x.data_ptr(), seg.data_ptr(), out.data_ptr(),
                       0, 0, 0, n, c, TILE, dtype, op, vb)
        return out
    ent_val = torch.empty((2 * n_tiles, c), dtype=torch.float32, device=x.device)
    ent_seg = torch.empty((2 * n_tiles,), dtype=torch.int32, device=x.device)
    ent_rows = torch.empty((2 * n_tiles,), dtype=torch.int32, device=x.device)
    kernels.launch("pnx_segscan_tiles", x.data_ptr(), seg.data_ptr(), out.data_ptr(),
                   ent_val.data_ptr(), ent_seg.data_ptr(), ent_rows.data_ptr(),
                   n, c, TILE, dtype, op, vb)
    full = _launch(ent_val, ent_seg, op)
    kernels.launch("pnx_segscan_fill", full.data_ptr(), ent_rows.data_ptr(), out.data_ptr(),
                   n, c, TILE, dtype, vb)
    return out


def segscan_launch_shape(dtype: torch.dtype, reduce: str, vb: int = 16) -> dict:
    """The tile kernel's launch shape on the current CUDA device (needs the
    card): threads per block, rows per tile, shared memory per block (all
    static), registers per thread and resident blocks per SM."""
    _check_reduce(reduce)
    threads, smem, regs, per_sm = (ctypes.c_int(0) for _ in range(4))
    err = kernels.entry("pnx_segscan_launch_shape")(
        0 if dtype == torch.float32 else 1, REDUCTIONS[reduce], vb,
        ctypes.byref(threads), ctypes.byref(smem), ctypes.byref(regs), ctypes.byref(per_sm),
    )
    if err != 0:
        raise RuntimeError(f"pnx_segscan_launch_shape failed with error code {err}")
    return {"threads": threads.value, "tile_rows": TILE, "static_smem_bytes": smem.value,
            "dynamic_smem_bytes": 0, "registers": regs.value, "blocks_per_sm": per_sm.value,
            "vector_bytes": vb}


def sorted_segment_bcast(x: torch.Tensor, seg: torch.Tensor, reduce: str = "max") -> torch.Tensor:
    """(N, C) f32/bf16 ``x``, (N,) non-decreasing int32 ``seg`` -> (N, C).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (``seg`` must be sorted: the kernel does not check)."""
    _check_reduce(reduce)
    if x.device.type == "cpu":
        return sorted_segment_bcast_plain(x, seg, reduce)
    kernels.check_cuda_tensor(x, "x", FLOAT_TYPES, ndim=2)
    kernels.check_cuda_tensor(seg, "seg", (torch.int32,), ndim=1)
    if seg.device != x.device or seg.shape[0] != x.shape[0]:
        raise ValueError("seg must be an (N,) tensor on x's device")
    if x.shape[0] == 0 or x.shape[1] == 0:
        return torch.empty_like(x)
    out = _launch(x, seg, REDUCTIONS[reduce])
    sorted_segment_bcast.launches += 1
    return out


sorted_segment_bcast.launches = 0


class _PillarMaxBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg, plain):
        bcast = sorted_segment_bcast_plain if plain else sorted_segment_bcast
        out = bcast(x, seg, "max")
        ctx.save_for_backward(x, seg, out)
        ctx.plain = plain
        return torch.where(torch.isfinite(out), out, 0.0)

    @staticmethod
    def backward(ctx, g):
        x, seg, out = ctx.saved_tensors
        bcast = sorted_segment_bcast_plain if ctx.plain else sorted_segment_bcast
        g_row = bcast(g.float().contiguous(), seg, "sum")
        is_max = x == out
        ties = bcast(is_max.float(), seg, "sum")
        coef = torch.where(is_max, 1.0 / ties, 0.0)
        g_x = torch.where(torch.isfinite(out), g_row, 0.0) * coef
        return g_x.to(x.dtype), None, None


def pillar_max_broadcast(x: torch.Tensor, seg: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Every row gets the max of its pillar: the PFN's max-broadcast.

    Forward: kernel 3 (``sorted_segment_bcast(x, seg, "max")``), with a
    non-finite max set to 0 as ``segment_max`` does
    (pillarnext_tpu/ops/scatter.py:123).  Backward:
    the VJP of the JAX pair ``gather_segments(segment_max(x))``, which has
    no backward kernel on the TPU (pallas_segscan.py is forward-only):
    the cotangent summed over each segment, split evenly among the
    segment's tied maxima (XLA's scatter-max rule, ``g * (1 / ties)``), and
    zeroed where the max is not finite, in f32.  The two segment sums are
    kernel 3's ``sum`` on the card and its plain version on the CPU; the
    rest is plain PyTorch.  ``plain`` keeps CUDA tensors on the plain
    versions."""
    return _PillarMaxBroadcast.apply(x, seg, plain)
