"""Rotated, axis-aligned and circle NMS with fixed-size outputs, batched
over lanes.

Counterpart of ``rotated_nms``, ``axis_aligned_nms``, ``circle_nms`` and
their helpers (pillarnext_tpu/core/nms.py:41-232).  Candidates stream in score order in
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


def _greedy_nms(cand, scores, pre_max_size: int, post_max_size: int, overlaps):
    """Greedy NMS per lane over (L, N, D) candidate rows: the top
    ``pre_max_size`` by score (ties in ascending index, ``lax.top_k``'s
    order), ``overlaps(a, b)`` -> (L, M, N) bool, the kept rows compacted
    and padded to ``post_max_size``."""
    k = min(pre_max_size, cand.shape[1])
    top_scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, order = top_scores[:, :k], order[:, :k]
    valid = top_scores > NEG_INF / 2
    rows = torch.gather(cand, 1, order[..., None].expand(-1, -1, cand.shape[-1]))
    keep = _chunked_greedy(rows, valid, overlaps, post_max_size)
    return _select(order, keep, post_max_size)


def _lane_thresholds(thresh, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(thresh, dtype=like.dtype, device=like.device).reshape(-1, 1, 1)


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
    th = _lane_thresholds(thresh, boxes)

    def overlaps(a, b):
        return torch_box_ops.boxes_iou_bev(a, b) > th

    return _greedy_nms(boxes, scores, pre_max_size, post_max_size, overlaps)


def axis_aligned_nms(boxes, scores, thresh, pre_max_size: int, post_max_size: int):
    """Axis-aligned BEV NMS per lane (nms.py:175-211, the reference's
    ``nms_normal_gpu``: greedy over the IoU of the boxes' axis-aligned
    footprints, yaw ignored); the interface of ``rotated_nms``."""
    th = _lane_thresholds(thresh, boxes)

    def overlaps(a, b):
        half_a, half_b = a[..., None, 3:5] / 2, b[..., None, :, 3:5] / 2
        lo = torch.maximum(a[..., None, :2] - half_a, b[..., None, :, :2] - half_b)
        hi = torch.minimum(a[..., None, :2] + half_a, b[..., None, :, :2] + half_b)
        inter = torch.clamp(hi - lo, min=0.0).prod(-1)
        area_a = a[..., 3:5].prod(-1)[..., :, None]
        area_b = b[..., 3:5].prod(-1)[..., None, :]
        return inter / torch.clamp(area_a + area_b - inter, min=1e-9) > th

    return _greedy_nms(boxes, scores, pre_max_size, post_max_size, overlaps)


def circle_nms(centers, scores, radius, pre_max_size: int, post_max_size: int):
    """CenterPoint's circle NMS per lane (nms.py:214-232): a later
    candidate is suppressed when its centre lies within the lane's
    ``radius`` (metres) of a kept one.  ``centers`` (L, N, >= 2), x and y
    first; the interface of ``rotated_nms``."""
    r2 = torch.square(_lane_thresholds(radius, centers))

    def overlaps(a, b):
        d2 = torch.square(a[..., :, None, :] - b[..., None, :, :]).sum(-1)
        return d2 < r2

    return _greedy_nms(centers[..., :2], scores, pre_max_size, post_max_size, overlaps)
