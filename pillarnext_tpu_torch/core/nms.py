"""Rotated NMS with fixed-size outputs, batched over lanes.

Counterpart of ``rotated_nms`` and its helpers
(pillarnext_tpu/core/nms.py:41-172).  Candidates stream in score order in
chunks of 128; each chunk is tested against the kept set, then resolved
within itself by the greedy fixpoint ``keep <- valid & ~(keep @ over)``.

The JAX package's data-dependent ``while_loop`` exits become Python loops
whose conditions are read on the host: one device sync per chunk and one
per fixpoint round.  A batch of lanes runs until every lane has finished;
a finished lane's state no longer changes (its chunks hold no valid
candidates, and a reached fixpoint is stable), so each lane gets exactly
its own greedy result.
"""

from __future__ import annotations

import torch

from pillarnext_tpu_torch.core import torch_box_ops

NEG_INF = -1e9
_CHUNK = 128


def _greedy_suppress(over: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(L, c) keep mask over score-sorted (L, c, c) overlaps, where
    ``over[l, j, i]`` means j would suppress a later i."""
    c = over.shape[-1]
    idx = torch.arange(c, device=over.device)
    over = over & valid[:, None, :] & valid[:, :, None] & (idx[None, :] > idx[:, None])
    overf = over.float()
    keep = valid
    for _ in range(c):
        suppressed = (keep.float()[:, None, :] @ overf)[:, 0] > 0.0
        new_keep = valid & ~suppressed
        if torch.equal(new_keep, keep):  # host sync
            break
        keep = new_keep
    return keep


def _chunked_greedy(cand: torch.Tensor, valid: torch.Tensor, overlap_fn, post_max: int):
    """Streaming greedy NMS: cand (L, K, D) score-sorted rows, valid (L, K)
    (a prefix of each lane), overlap_fn(a (L, M, D), b (L, N, D)) -> (L, M, N)
    bool.  Returns the (L, K) keep mask."""
    lanes, k, d = cand.shape
    c = min(_CHUNK, k)
    n_chunks = -(-k // c)
    kept_cap = min(-(-post_max // c) * c, k)
    pad = n_chunks * c - k
    if pad:
        cand = torch.cat([cand, cand.new_zeros((lanes, pad, d))], dim=1)
        valid = torch.cat([valid, valid.new_zeros((lanes, pad))], dim=1)
    n_valid = valid.sum(1)
    keep_out = torch.zeros_like(valid)
    kept_rows = cand.new_zeros((lanes, kept_cap + 1, d))  # +1: overflow row
    kept_valid = valid.new_zeros((lanes, kept_cap + 1))
    kept_count = torch.zeros(lanes, dtype=torch.int64, device=cand.device)
    for chunk_i in range(n_chunks):
        start = chunk_i * c
        active = (start < n_valid) & (kept_count < post_max)
        if not bool(active.any()):  # host sync
            break
        chunk = cand[:, start:start + c]
        chunk_valid = valid[:, start:start + c] & active[:, None]
        sup = overlap_fn(kept_rows, chunk) & kept_valid[:, :, None]
        free = chunk_valid & ~sup.any(dim=1)
        chunk_keep = _greedy_suppress(overlap_fn(chunk, chunk), free)
        keep_out[:, start:start + c] = chunk_keep
        pos = kept_count[:, None] + torch.cumsum(chunk_keep, dim=1) - 1
        pos = torch.where(chunk_keep & (pos < kept_cap), pos, kept_cap)
        kept_rows.scatter_(1, pos[..., None].expand(-1, -1, d), chunk)
        kept_valid.scatter_(1, pos, chunk_keep)
        # the overflow row only collects rows past kept_cap >= post_max,
        # after which the lane is finished
        kept_valid[:, kept_cap] = False
        kept_count = kept_count + chunk_keep.sum(1)
    return keep_out[:, :k]


def _select(order: torch.Tensor, keep: torch.Tensor, post_max: int):
    """Stable-compact kept (score-sorted) rows per lane, pad to post_max."""
    lanes, k = order.shape
    rank = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    kept_sorted = torch.gather(order, 1, rank)
    keep_sorted = torch.gather(keep, 1, rank)
    if k >= post_max:
        sel, sel_valid = kept_sorted[:, :post_max], keep_sorted[:, :post_max]
    else:
        sel = order.new_zeros((lanes, post_max))
        sel_valid = keep.new_zeros((lanes, post_max))
        sel[:, :k] = kept_sorted
        sel_valid[:, :k] = keep_sorted
    return torch.where(sel_valid, sel, 0), sel_valid


def rotated_nms(boxes, scores, thresh, pre_max_size: int, post_max_size: int):
    """Rotated BEV NMS per lane.

    Args:
        boxes: (L, N, 7) [x, y, z, dx, dy, dz, yaw].
        scores: (L, N); ``NEG_INF`` marks invalid rows.
        thresh: (L,) IoU thresholds (or a float).
        pre_max_size / post_max_size: truncation sizes.

    Returns:
        (L, post_max_size) indices into the N rows, and their validity.
    """
    lanes, n, _ = boxes.shape
    k = min(pre_max_size, n)
    top_scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, order = top_scores[:, :k], order[:, :k]
    valid = top_scores > NEG_INF / 2
    cand = torch.gather(boxes, 1, order[..., None].expand(-1, -1, boxes.shape[-1]))
    th = torch.as_tensor(thresh, dtype=boxes.dtype, device=boxes.device).reshape(-1, 1, 1)

    def overlaps(a, b):
        return torch_box_ops.boxes_iou_bev(a, b) > th

    keep = _chunked_greedy(cand, valid, overlaps, post_max_size)
    return _select(order, keep, post_max_size)
