"""Tile-stack submanifold convolution.

Counterpart of pillarnext_tpu/ops/tile_subm.py.  The active set is covered
by t x t tiles (t = 8 by default) and a stride-1 3x3 SubM conv runs as a
dense VALID conv over the stack of active tiles, each tile framed by a
one-cell halo read from its 8 neighbours:

    compact table (site_cap, C) -> stack (T, t, t, C)       pack_stack
    stack -> (T, t + 2, t + 2, C)                           halo_gather
    y = conv_VALID(halo, W)                                  tile_conv
    stack -> table / dense (B, H, W, C)                      unpack_stack, stack_to_dense

Every row movement is one row gather (kernel 2, ops/gather.py, on a CUDA
tensor; ``index_select`` on the CPU or with ``plain``), which returns a
zero row for an out-of-range index: the dump tile of the JAX version.
JAX moves rows by unique-index scatters; here each scatter becomes a
gather by its inverse map, built once per ``TileMap``: for each stack cell
its pillar slot (``slot_of_cell``), for each dense cell its stack row
(``row_of_dense``), and for each halo cell its stack row (``halo_rows``).
Each function's backward is the gather by the forward map.  The halo's
backward sums what a stack cell gave to its own interior, to one vertical
and one horizontal neighbour's edge and to one diagonal neighbour's corner:
one gather of those 4 rows per cell (``halo_sources``), added in JAX's
order (interior, vertical, horizontal, corner) with no atomics, so it is
deterministic.

Exactness: identical to SubM on the active set.  Inactive cells of active
tiles hold exact zeros (each block re-zeroes them after BN), inactive
tiles are read only through halos and give zeros, and the outputs are
re-masked to the active set.  The conv is ``F.conv2d`` (cuDNN on the
card), as JAX's is ``lax.conv``.

On the H100 the tile path is an opt-in mode, as on the TPU: measured
by ``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 at 700 W, a
``sparse_stages_eval='tile'`` frame's reader and backbone take 16.8
device ms against the per-site path's 10.7 (the full tile grid at the
largest bucket), and a ``tile_stride1`` train step at B = 4 takes 439 ms
against 365 (PERF.md).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from pillarnext_tpu_torch.ops.gather import monotone_row_gather, monotone_row_gather_plain
from pillarnext_tpu_torch.ops.subm_conv import build_neighbor_table, subm_offsets_2d


class TileMap(NamedTuple):
    """Active-tile index structures for one (batch, H, W) grid.  The first
    six fields are JAX's ``TileMap``; the rest are the inverse maps the
    gathers read."""

    tile_sod: torch.Tensor      # (B*TH*TW,) int32 dense tile id -> tile slot, cap if empty
    tile_id: torch.Tensor       # (cap,) int32 dense tile id per slot (B*TH*TW if unused)
    nbr: torch.Tensor           # (cap, 9) int32 3x3 tile-neighbourhood slots (cap = none)
    out_mask: torch.Tensor      # (cap, t, t) bool: active sites within each tile slot
    row_of_slot: torch.Tensor   # (site_cap,) int32 stack row of each pillar slot (>= cap*t*t: none)
    n_tiles: torch.Tensor       # () int32 true active-tile count (overflow telemetry)
    slot_of_cell: torch.Tensor  # (cap*t*t,) int32 pillar slot of each stack cell (site_cap: none)
    dense_of_cell: torch.Tensor  # (cap*t*t,) int32 dense row of each stack cell (B*H*W: none)
    row_of_dense: torch.Tensor  # (B*H*W,) int32 stack row of each dense cell (cap*t*t: none)
    halo_rows: torch.Tensor     # (cap*(t+2)^2,) int32 stack row of each halo cell (cap*t*t: none)
    halo_sources: torch.Tensor  # (4*cap*t*t,) int32 halo rows each stack cell feeds, by part
    batch: int
    spatial: tuple              # (H, W)
    tile: int
    cap: int


def _halo_rows(nbr: torch.Tensor, cap: int, t: int) -> torch.Tensor:
    """Stack row of each cell of each haloed tile, row-major over (cap,
    t + 2, t + 2): the tile's own cell inside, the facing row, column or
    corner cell of the neighbour at that side on the frame; ``cap*t*t``
    (a zero row) where that neighbour is inactive."""
    dev = nbr.device
    i = torch.arange(t + 2, device=dev)
    side = torch.where(i == 0, -1, torch.where(i == t + 1, 1, 0))  # neighbour offset along the axis
    src = torch.where(side == -1, t - 1, torch.where(side == 1, 0, i - 1))
    k = ((side[:, None] + 1) * 3 + side[None, :] + 1).reshape(-1)  # tap of subm_offsets_2d(3)
    local = (src[:, None] * t + src[None, :]).reshape(-1)
    own = torch.arange(cap, device=dev)[:, None]
    tiles = torch.where(k[None, :] == 4, own, nbr[:, k].long())
    rows = torch.where(tiles < cap, tiles * (t * t) + local[None, :], cap * t * t)
    return rows.reshape(-1).to(torch.int32)


def _halo_sources(nbr: torch.Tensor, cap: int, t: int) -> torch.Tensor:
    """The halo rows (in the flat ``(cap*(t+2)^2, C)`` halo) that read each
    stack cell, as 4 parts of ``cap*t*t`` rows: its own interior cell; the
    edge cell of the tile above (a top-row cell) or below (a bottom-row
    cell); the edge cell of the tile left or right of it; the corner cell
    of the diagonal tile (a corner cell).  ``cap*(t+2)^2`` (a zero row)
    where no such reader exists."""
    dev = nbr.device
    t2 = t + 2
    i = torch.arange(t, device=dev)
    # the side at which a reader tile sits: -1 above / left, +1 below / right
    side = torch.where(i == 0, -1, torch.where(i == t - 1, 1, 0))
    frame = torch.where(side == -1, t + 1, 0)  # the reader's frame row / column holding this cell
    r, c = i[:, None].expand(t, t), i[None, :].expand(t, t)
    sr, sc = side[:, None].expand(t, t), side[None, :].expand(t, t)
    fr, fc = frame[:, None].expand(t, t), frame[None, :].expand(t, t)
    none = cap * t2 * t2
    own = torch.arange(cap, device=dev)[:, None]

    def part(reader_k, at_r, at_c, present):
        k = reader_k.reshape(-1)
        reader = torch.where(k[None, :] == 4, own, nbr[:, k].long())
        ok = present.reshape(-1)[None, :] & (reader < cap)
        return torch.where(ok, reader * (t2 * t2) + (at_r * t2 + at_c).reshape(-1)[None, :], none)

    parts = [
        part(torch.full_like(sr, 4), r + 1, c + 1, torch.ones_like(sr, dtype=torch.bool)),
        part((sr + 1) * 3 + 1, fr, c + 1, sr != 0),
        part(3 + sc + 1, r + 1, fc, sc != 0),
        part((sr + 1) * 3 + sc + 1, fr, fc, (sr != 0) & (sc != 0)),
    ]
    return torch.stack(parts).reshape(-1).to(torch.int32)


def build_tile_map(
    slot_of_dense: torch.Tensor,
    slot_id: torch.Tensor,
    batch: int,
    spatial: tuple,
    site_cap: int,
    tile: int,
    tile_cap: int,
) -> TileMap:
    """Cover the active set with ``tile`` x ``tile`` tiles, sort free
    (pillarnext_tpu/ops/tile_subm.py:74-158): tile slots are ranks of a
    cumsum over the dense tile occupancy, so the active tiles take slots in
    dense (row-major) order.

    Args:
        slot_of_dense: (B*H*W,) int32 dense position -> pillar slot
            (``site_cap`` where empty).
        slot_id: (site_cap,) int32 dense position of each pillar slot.
        site_cap: pillar table capacity.
        tile: tile side (H and W must divide by it).
        tile_cap: tile slots; tiles ranked beyond it are dropped: callers
            report ``n_tiles`` against it as overflow telemetry.
    """
    h, w = spatial
    if h % tile or w % tile:
        raise ValueError(f"the grid {tuple(spatial)} does not divide into {tile} x {tile} tiles")
    t = tile
    th, tw = h // t, w // t
    n_cells = batch * th * tw
    dev = slot_of_dense.device

    occ = slot_of_dense < site_cap
    occ_tile = occ.reshape(batch, th, t, tw, t).any(4).any(2).reshape(-1)
    counts = torch.cumsum(occ_tile.to(torch.int32), 0, dtype=torch.int32)
    ranks = counts - 1
    n_tiles = counts[-1]
    tile_sod = torch.where(occ_tile & (ranks < tile_cap), ranks, tile_cap).to(torch.int32)
    # slot r holds the (r+1)-th occupied tile: the first tile whose count is r + 1
    want = torch.arange(1, tile_cap + 1, device=dev, dtype=torch.int32)
    tile_id = torch.searchsorted(counts, want).to(torch.int32)  # n_cells past the last tile

    nbr = build_neighbor_table(tile_sod, tile_id, (th, tw), subm_offsets_2d(3), tile_cap)

    # each stack cell's dense row, then its pillar slot
    tid = tile_id.long()
    used = tid < n_cells
    tid_safe = torch.where(used, tid, 0)
    b, rem = tid_safe // (th * tw), tid_safe % (th * tw)
    ty, tx = rem // tw, rem % tw
    ly = torch.arange(t, device=dev)
    y = ty[:, None, None] * t + ly[None, :, None]
    x = tx[:, None, None] * t + ly[None, None, :]
    hw = h * w
    dense = b[:, None, None] * hw + y * w + x
    dense = torch.where(used[:, None, None], dense, batch * hw).reshape(-1)
    safe = torch.where(dense < batch * hw, dense, 0)
    slot_of_cell = torch.where(dense < batch * hw, slot_of_dense[safe].long(), site_cap)
    out_mask = (slot_of_cell < site_cap).reshape(tile_cap, t, t)

    # each pillar slot's stack row; shadow rows past the stack where none
    n_rows = tile_cap * t * t
    d = slot_id.long()
    valid_slot = d < batch * hw
    d_safe = torch.where(valid_slot, d, 0)
    sb, sr, sc = d_safe // hw, (d_safe % hw) // w, d_safe % w
    tslot = tile_sod[sb * (th * tw) + (sr // t) * tw + sc // t].long()
    local = (sr % t) * t + sc % t
    row_of_slot = torch.where(valid_slot & (tslot < tile_cap), tslot * (t * t) + local,
                              n_rows + torch.arange(site_cap, device=dev))

    # each dense cell's stack row
    dd = torch.arange(batch * hw, device=dev)
    db, dr, dc = dd // hw, (dd % hw) // w, dd % w
    dslot = tile_sod[db * (th * tw) + (dr // t) * tw + dc // t].long()
    row_of_dense = torch.where(dslot < tile_cap, dslot * (t * t) + (dr % t) * t + dc % t, n_rows)

    return TileMap(
        tile_sod, tile_id, nbr, out_mask, row_of_slot.to(torch.int32), n_tiles,
        slot_of_cell.to(torch.int32), dense.to(torch.int32), row_of_dense.to(torch.int32),
        _halo_rows(nbr, tile_cap, t), _halo_sources(nbr, tile_cap, t),
        batch, (h, w), t, tile_cap,
    )


def _gather(plain: bool):
    return monotone_row_gather_plain if plain else monotone_row_gather


class _RowGather(torch.autograd.Function):
    """``out = table[fwd]`` (zero rows out of range) whose backward is the
    gather of the cotangent by ``bwd``: the transpose wherever ``fwd`` and
    ``bwd`` are inverse maps over their in-range entries."""

    @staticmethod
    def forward(ctx, table, fwd, bwd, plain):
        ctx.save_for_backward(bwd)
        ctx.plain = plain
        return _gather(plain)(table.contiguous(), fwd)

    @staticmethod
    def backward(ctx, g):
        (bwd,) = ctx.saved_tensors
        return _gather(ctx.plain)(g.contiguous(), bwd), None, None, None


def pack_stack(table: torch.Tensor, tm: TileMap, plain: bool = False) -> torch.Tensor:
    """Compact table (site_cap[+1], C) -> tile stack (cap, t, t, C); cells
    without an active pillar are zeros (one gather by ``slot_of_cell``)."""
    site_cap = tm.row_of_slot.shape[0]
    flat = _RowGather.apply(table[:site_cap], tm.slot_of_cell, tm.row_of_slot, plain)
    return flat.reshape(tm.cap, tm.tile, tm.tile, table.shape[-1])


def unpack_stack(stack: torch.Tensor, tm: TileMap, plain: bool = False) -> torch.Tensor:
    """Tile stack -> compact table (site_cap, C) (one gather by
    ``row_of_slot``; slots of dropped tiles read zeros)."""
    c = stack.shape[-1]
    return _RowGather.apply(stack.reshape(-1, c), tm.row_of_slot, tm.slot_of_cell, plain)


def stack_to_dense(stack: torch.Tensor, tm: TileMap, plain: bool = False) -> torch.Tensor:
    """Tile stack -> dense (B, H, W, C): one gather by ``row_of_dense``."""
    c = stack.shape[-1]
    h, w = tm.spatial
    dense = _RowGather.apply(stack.reshape(-1, c), tm.row_of_dense, tm.dense_of_cell, plain)
    return dense.reshape(tm.batch, h, w, c)


class _HaloGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stack, rows, sources, plain):
        cap, t, _, c = stack.shape
        ctx.save_for_backward(sources)
        ctx.plain, ctx.shape = plain, stack.shape
        return _gather(plain)(stack.reshape(-1, c).contiguous(), rows).reshape(cap, t + 2, t + 2, c)

    @staticmethod
    def backward(ctx, g):
        (sources,) = ctx.saved_tensors
        c = g.shape[-1]
        parts = _gather(ctx.plain)(g.reshape(-1, c).contiguous(), sources).reshape(4, -1, c)
        dx = ((parts[0] + parts[1]) + parts[2]) + parts[3]
        return dx.reshape(ctx.shape), None, None, None


def halo_gather(stack: torch.Tensor, tm: TileMap, plain: bool = False) -> torch.Tensor:
    """(cap, t, t, C) stack -> (cap, t + 2, t + 2, C) haloed tiles
    (inactive neighbours read zeros): one gather by ``halo_rows``; its
    backward one gather by ``halo_sources`` and a fixed-order sum."""
    return _HaloGather.apply(stack, tm.halo_rows, tm.halo_sources, plain)


def tile_conv(stack: torch.Tensor, tm: TileMap, weight: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """SubM conv over the tile stack: halo, then a 3x3 VALID conv.
    ``weight``: (Cout, Cin, 3, 3), cast to the stack's dtype.  The output
    (cap, t, t, Cout) is not re-masked: blocks re-zero inactive cells after
    BN."""
    if tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"the tile halo of 1 takes 3x3 kernels, got {tuple(weight.shape[2:])}")
    halo = halo_gather(stack, tm, plain).permute(0, 3, 1, 2)
    return F.conv2d(halo, weight.to(stack.dtype)).permute(0, 2, 3, 1)
