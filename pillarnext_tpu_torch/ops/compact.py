"""Static-capacity compaction of sparse segment ids.

Counterpart of pillarnext_tpu/ops/compact.py:24-85.  Capacities stay
static (a table of ``capacity`` slots plus the dump slot ``capacity``), so
the port's tables have the JAX package's shapes and the overflow count is
exact telemetry for serving.
"""

from __future__ import annotations

import torch


def compactify(ids: torch.Tensor, invalid_id: int, capacity: int):
    """Assign compact slots to segment ids.

    Args:
        ids: (N,) int32 segment ids; ``invalid_id`` (the largest id) marks
            padded or out-of-range entries.
        invalid_id: the dump id.
        capacity: number of compact slots.

    Returns:
        order: (N,) int64 stable sort permutation of ``ids``.
        sorted_slot: (N,) int32 slot per sorted point, ascending;
            ``capacity`` for invalid and overflowing points.
        slot_id: (capacity,) int32 segment id of each slot (``invalid_id``
            for unused slots).
        n_unique: () int32 number of occupied ids before the capacity clamp.
    """
    sorted_ids, order = torch.sort(ids, stable=True)
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    first &= sorted_ids != invalid_id
    rank = torch.cumsum(first, 0, dtype=torch.int32) - 1
    n_unique = rank[-1] + 1
    dump = (sorted_ids == invalid_id) | (rank >= capacity)
    rank = torch.where(dump, torch.full_like(rank, capacity), rank)
    slot_id = torch.full((capacity + 1,), invalid_id, dtype=torch.int32, device=ids.device)
    # every point of a slot carries the same id; only the dump slot sees
    # differing writes, and it is cut off below
    slot_id.scatter_(0, rank.long(), sorted_ids.to(torch.int32))
    return order, rank, slot_id[:capacity], n_unique


def invert_slot_map(slot_id: torch.Tensor, dense_rows: int):
    """(slot_of_dense (dense_rows,) int32 with ``cap`` for empty cells,
    occupied (cap,) bool) from the slot -> dense-position map.  Unused slots
    write to distinct shadow rows past the dense range, so the scatter has
    unique indices and needs no host sync."""
    cap = slot_id.shape[0]
    occupied = slot_id < dense_rows
    ar = torch.arange(cap, dtype=torch.int32, device=slot_id.device)
    target = torch.where(occupied, slot_id, dense_rows + ar)
    slot_of_dense = torch.full((dense_rows + cap,), cap, dtype=torch.int32, device=slot_id.device)
    slot_of_dense[target.long()] = ar
    return slot_of_dense[:dense_rows], occupied
