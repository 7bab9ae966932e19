"""Rotated, axis-aligned and circle NMS with fixed-size outputs, batched
over lanes.

Counterpart of ``rotated_nms``, ``axis_aligned_nms``, ``circle_nms`` and
their helpers (pillarnext_tpu/core/nms.py:41-232).  Each lane's candidates
are sorted by score and cut to ``pre_max_size``; row i is kept iff it is
valid and no kept row before it overlaps it; a lane stops at
``post_max_size`` kept rows, compacted in score order and padded.

Which path runs where:

- CUDA tensors, ``rotated_nms`` and ``circle_nms``: one hand-written
  kernel (``csrc/nms.cu``, ``card_greedy_nms``) builds every lane's
  suppression bitmask and walks it greedily on the card: two device
  launches from one entry call, no host read, the kept rows compacted
  there too.
- CPU tensors, and ``axis_aligned_nms`` on any device: the chunk loop
  (``_chunked_nms``, ``_streamed``).
  Candidates stream in score order in chunks of 128; each chunk is tested
  against the kept set, then resolved within itself by the greedy
  fixpoint ``keep <- valid & ~(keep @ over)``; ``_select`` compacts.  The
  JAX package's data-dependent ``while_loop`` exits become Python loops
  whose conditions are read on the host: one read per chunk and one per
  fixpoint round.  A batch of lanes runs until every lane has finished; a
  finished lane's state no longer changes (its chunks hold no valid
  candidates, and a reached fixpoint is stable), so each lane gets exactly
  its own greedy result.  It is the tests' oracle for the kernel.

Spans (utils/profiling.annotate): ``nms`` around one greedy NMS over a
group's lanes on either path.  Inside it, on the card, ``nms.kernel``
around the kernel's launches; on the CPU path, ``nms.sync`` around each
host read, the chunk's ``active.any()`` and each fixpoint round's
``torch.equal``.
"""

from __future__ import annotations

import torch

from pillarnext_tpu_torch.core import torch_box_ops
from pillarnext_tpu_torch.ops import kernels
from pillarnext_tpu_torch.utils import profiling

NEG_INF = -1e9
_CHUNK = 128
MAX_CARD_CANDIDATES = 16384  # the kernel's mask: k * ceil(k / 64) words a lane, 32 MB here


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
        with profiling.annotate("nms.sync"):
            same = torch.equal(new_keep, keep)
        if same:
            break
        keep = new_keep
    return keep


def _chunked_greedy(cand: torch.Tensor, valid: torch.Tensor, overlap_fn, post_max: int):
    """Streaming greedy NMS: cand (L, K, D) score-sorted rows, valid (L, K)
    (a prefix of each lane), overlap_fn(a (L, M, D), b (L, N, D)) -> (L, M, N)
    bool.  Returns the (L, K) keep mask."""
    with profiling.annotate("nms"):
        return _streamed(cand, valid, overlap_fn, post_max)


def _streamed(cand, valid, overlap_fn, post_max: int):
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
        with profiling.annotate("nms.sync"):
            finished = not bool(active.any())
        if finished:
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


def card_greedy_nms(rows, valid, order, thresh, post_max: int, circle: bool):
    """``_streamed`` + ``_select`` in one kernel (``csrc/nms.cu``): the
    (L, post_max) kept ``order`` entries and their validity.  rows (L, K, 7)
    float32 score-sorted boxes, or (L, K, 2) centres when ``circle``;
    valid (L, K) bool; order (L, K) int64 with unit column stride; thresh
    (L,) float32, the IoU threshold or, for ``circle``, the squared radius.
    Launches on the current stream and never synchronises."""
    kernels.check_cuda_tensor(rows, "rows", (torch.float32,), ndim=3)
    kernels.check_cuda_tensor(valid, "valid", (torch.bool,), ndim=2)
    kernels.check_cuda_tensor(thresh, "thresh", (torch.float32,), ndim=1)
    lanes, k, d = rows.shape
    if order.device != rows.device or order.dtype != torch.int64 or order.dim() != 2 or order.stride(1) != 1:
        raise ValueError("order: expected an int64 (L, K) tensor with unit column stride on the rows' device")
    if valid.device != rows.device or thresh.device != rows.device:
        raise ValueError("rows, valid and thresh must be on the same device")
    if d != (2 if circle else 7):
        raise ValueError(f"rows: expected {2 if circle else 7} values a row, got {d}")
    if tuple(valid.shape) != (lanes, k) or tuple(order.shape) != (lanes, k) or thresh.shape[0] != lanes:
        raise ValueError(f"shapes do not agree: rows {tuple(rows.shape)}, valid {tuple(valid.shape)}, "
                         f"order {tuple(order.shape)}, thresh {tuple(thresh.shape)}")
    if k > MAX_CARD_CANDIDATES or lanes > 65535 or post_max < 0:
        raise ValueError(f"{lanes} lanes of {k} candidates, post_max {post_max}: beyond the kernel's sizes")
    mask = torch.empty((lanes, k, -(-k // 64)), dtype=torch.int64, device=rows.device)
    sel = torch.empty((lanes, post_max), dtype=torch.int64, device=rows.device)
    sel_valid = torch.empty((lanes, post_max), dtype=torch.bool, device=rows.device)
    with profiling.annotate("nms.kernel"):
        kernels.launch(
            "pnx_nms", rows.data_ptr(), valid.data_ptr(), order.data_ptr(), order.stride(0),
            thresh.data_ptr(), mask.data_ptr(), sel.data_ptr(), sel_valid.data_ptr(),
            lanes, k, d, post_max, int(circle),
        )
    card_greedy_nms.launches += 1
    return sel, sel_valid


card_greedy_nms.launches = 0


def _top_rows(cand, scores, pre_max_size: int):
    """Each lane's top ``pre_max_size`` rows of (L, N, D) ``cand`` by score
    (ties in ascending index, ``lax.top_k``'s order): the rows, their
    validity and their indices."""
    k = min(pre_max_size, cand.shape[1])
    top_scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, order = top_scores[:, :k], order[:, :k]
    rows = torch.gather(cand, 1, order[..., None].expand(-1, -1, cand.shape[-1]))
    return rows, top_scores > NEG_INF / 2, order


def _chunked_nms(cand, scores, pre_max_size: int, post_max_size: int, overlaps):
    """Greedy NMS per lane by the chunk loop: ``overlaps(a, b)`` ->
    (L, M, N) bool, the kept rows compacted and padded to
    ``post_max_size``."""
    rows, valid, order = _top_rows(cand, scores, pre_max_size)
    return _select(order, _chunked_greedy(rows, valid, overlaps, post_max_size), post_max_size)


def _greedy_nms(cand, scores, pre_max_size: int, post_max_size: int, overlaps, th, circle: bool = False):
    """``_chunked_nms`` on the CPU; on CUDA rows the kernel, at the
    thresholds ``th`` (L or 1, 1, 1) that ``overlaps`` compares with (the
    squared radii for ``circle``)."""
    if not cand.is_cuda:
        return _chunked_nms(cand, scores, pre_max_size, post_max_size, overlaps)
    rows, valid, order = _top_rows(cand, scores, pre_max_size)
    thresh = th.reshape(-1).expand(rows.shape[0]).contiguous()
    with profiling.annotate("nms"):
        return card_greedy_nms(rows, valid, order, thresh, post_max_size, circle)


def _lane_thresholds(thresh, like: torch.Tensor) -> torch.Tensor:
    """(L or 1, 1, 1) thresholds in ``like``'s dtype on its device; a value
    from the host goes up without a synchronisation."""
    th = torch.as_tensor(thresh, dtype=like.dtype)
    return th.to(like.device, non_blocking=True).reshape(-1, 1, 1)


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

    return _greedy_nms(boxes, scores, pre_max_size, post_max_size, overlaps, th)


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

    return _chunked_nms(boxes, scores, pre_max_size, post_max_size, overlaps)


def circle_nms(centers, scores, radius, pre_max_size: int, post_max_size: int):
    """CenterPoint's circle NMS per lane (nms.py:214-232): a later
    candidate is suppressed when its centre lies within the lane's
    ``radius`` (metres) of a kept one.  ``centers`` (L, N, >= 2), x and y
    first; the interface of ``rotated_nms``."""
    r2 = torch.square(_lane_thresholds(radius, centers))

    def overlaps(a, b):
        d2 = torch.square(a[..., :, None, :] - b[..., None, :, :]).sum(-1)
        return d2 < r2

    return _greedy_nms(centers[..., :2], scores, pre_max_size, post_max_size, overlaps, r2, circle=True)
