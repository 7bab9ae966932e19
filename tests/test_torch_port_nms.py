"""The NMS kernel's contract (csrc/nms.cu), held on the CPU.

The oracle is the kernel's algorithm in NumPy: a dense suppression bitmask
of 64-bit words per lane (bit i of row j set iff j < i, both valid, and
``torch_box_ops.boxes_iou_bev(j, i) > th``; circle: d^2 < r^2), then a
sequential sweep that keeps a valid row not yet removed, ORs in its mask
row, stops at ``post_max`` kept rows, and compacts the kept rows' sort
indices in score order, padded with 0 / False.  ``nms.rotated_nms`` and
``nms.circle_nms`` on CPU tensors (the host-driven chunk loop) must return
exactly that, over lane counts, ``post_max`` below and above the kept
count, and scores full of ties.  The kernel is held against the same
contract on the card (tests/test_torch_port_cuda.py).  Last, the route
every kernel's launch takes: the dispatcher op ``pnx::launch``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pillarnext_tpu_torch.core import nms, torch_box_ops
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _scene(rng, lanes, n, ties, spread=8.0):
    """(L, N, 7) boxes clustered so that many overlap, and (L, N) scores
    with some rows invalid; ``ties``: scores drawn from four values."""
    boxes = np.zeros((lanes, n, 7), np.float32)
    centres = rng.uniform(-spread, spread, (lanes, max(n // 6, 1), 2))
    pick = rng.integers(0, centres.shape[1], (lanes, n))
    boxes[..., :2] = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(0, 0.6, (lanes, n, 2))
    boxes[..., 2] = rng.uniform(-1, 1, (lanes, n))
    boxes[..., 3:6] = rng.uniform(0.5, 4.5, (lanes, n, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (lanes, n))
    if ties:
        scores = rng.choice(np.float32([0.2, 0.4, 0.6, 0.8]), (lanes, n))
    else:
        scores = rng.random((lanes, n), np.float32)
    scores[rng.random((lanes, n)) < 0.15] = nms.NEG_INF
    return boxes.astype(np.float32), scores.astype(np.float32)


def _bitmask(over: np.ndarray) -> np.ndarray:
    """(K, K) bool -> (K, ceil(K / 64)) uint64 words, bit c of word w for
    column 64 w + c."""
    k = over.shape[0]
    words = -(-k // 64)
    padded = np.zeros((k, words * 64), bool)
    padded[:, :k] = over
    weights = np.uint64(1) << np.arange(64, dtype=np.uint64)
    return (padded.reshape(k, words, 64).astype(np.uint64) * weights).sum(-1, dtype=np.uint64)


def _oracle(boxes, scores, thresh, pre_max, post_max, circle=False):
    """Per lane: sort, cut, dense bitmask, sequential sweep, compaction."""
    lanes, n = scores.shape
    k = min(pre_max, n)
    sel = np.zeros((lanes, post_max), np.int64)
    sel_valid = np.zeros((lanes, post_max), bool)
    for lane in range(lanes):
        order = np.argsort(-scores[lane], kind="stable")[:k]
        valid = scores[lane][order] > nms.NEG_INF / 2
        rows = torch.from_numpy(boxes[lane][order])
        if circle:
            d2 = torch.square(rows[:, None, :2] - rows[None, :, :2]).sum(-1)
            over = (d2 < torch.square(torch.tensor(thresh[lane], dtype=torch.float32))).numpy()
        else:
            over = (torch_box_ops.boxes_iou_bev(rows, rows) > torch.tensor(thresh[lane], dtype=torch.float32)).numpy()
        over &= np.triu(np.ones((k, k), bool), 1) & valid[:, None] & valid[None, :]
        mask = _bitmask(over)
        removed = np.zeros(mask.shape[1], np.uint64)
        kept = []
        for i in range(k):
            if valid[i] and not (int(removed[i // 64]) >> (i % 64)) & 1:
                kept.append(order[i])
                if len(kept) == post_max:
                    break
                removed |= mask[i]
        sel[lane, :len(kept)] = kept
        sel_valid[lane, :len(kept)] = True
    return sel, sel_valid


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("post_max", [7, 500])
@pytest.mark.parametrize("lanes", [1, 3, 12])
def test_rotated_nms_on_the_cpu_is_the_kernels_contract(lanes, post_max, ties):
    rng = np.random.default_rng(100 * lanes + post_max + ties)
    boxes, scores = _scene(rng, lanes, 300, ties)
    thresh = rng.choice(np.float32([0.0, 0.1, 0.2, 0.55]), lanes)
    sel, sel_valid = nms.rotated_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                     torch.from_numpy(thresh), 260, post_max)
    want, want_valid = _oracle(boxes, scores, thresh, 260, post_max)
    np.testing.assert_array_equal(sel_valid.numpy(), want_valid)
    np.testing.assert_array_equal(sel.numpy(), want)
    assert post_max < 300 or not want_valid.all()  # 500 lies above every lane's kept count


@pytest.mark.parametrize("post_max", [5, 400])
@pytest.mark.parametrize("lanes", [1, 4, 10])
def test_circle_nms_on_the_cpu_is_the_kernels_contract(lanes, post_max):
    rng = np.random.default_rng(7 * lanes + post_max)
    boxes, scores = _scene(rng, lanes, 250, ties=lanes % 2 == 0)
    radius = rng.choice(np.float32([0.5, 1.0, 2.5]), lanes)
    sel, sel_valid = nms.circle_nms(torch.from_numpy(boxes[..., :2].copy()), torch.from_numpy(scores),
                                    torch.from_numpy(radius), 250, post_max)
    want, want_valid = _oracle(boxes, scores, radius, 250, post_max, circle=True)
    np.testing.assert_array_equal(sel_valid.numpy(), want_valid)
    np.testing.assert_array_equal(sel.numpy(), want)


def test_a_chain_past_the_chunk_boundary_is_the_kernels_contract():
    """A chain of 300 unit boxes 0.6 m apart, each overlapping its
    neighbours (IoU 0.25): greedy keeps every other one, across the
    128-candidate chunks."""
    n = 300
    boxes = np.zeros((2, n, 7), np.float32)
    boxes[..., 0] = np.arange(n, dtype=np.float32) * 0.6
    boxes[..., 3:6] = 1.0
    boxes[1, :, 1] = 5.0
    scores = np.tile(np.linspace(1.0, 0.1, n, dtype=np.float32), (2, 1))
    thresh = np.float32([0.2, 0.2])
    sel, sel_valid = nms.rotated_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.2, n, 200)
    want, want_valid = _oracle(boxes, scores, thresh, n, 200)
    np.testing.assert_array_equal(sel.numpy(), want)
    np.testing.assert_array_equal(sel_valid.numpy(), want_valid)
    assert want_valid[0].sum() == n // 2 and (want[0, :3] == [0, 2, 4]).all()


def test_cpu_tensors_never_reach_the_kernel():
    """The CPU keeps the chunk loop; the kernel's wrapper takes CUDA
    tensors only and raises on the rest."""
    rng = np.random.default_rng(3)
    boxes, scores = _scene(rng, 2, 40, ties=False)
    before = nms.card_greedy_nms.launches
    nms.rotated_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.2, 40, 10)
    nms.circle_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 1.0, 40, 10)
    assert nms.card_greedy_nms.launches == before
    rows = torch.from_numpy(boxes)
    valid = torch.ones(2, 40, dtype=torch.bool)
    order = torch.arange(40).repeat(2, 1)
    with pytest.raises(ValueError, match="CUDA"):
        nms.card_greedy_nms(rows, valid, order, torch.full((2,), 0.2), 10, circle=False)


def test_every_kernel_launches_inside_the_dispatcher_op(monkeypatch):
    """``kernels.launch`` (kernels 1-4) calls the C entry point inside the
    op ``pnx::launch``, the host event a trace gives the kernel's device
    time to, nested in the caller's spans; a non-zero return raises."""
    import types

    from pillarnext_tpu_torch.ops import kernels
    from pillarnext_tpu_torch.utils import profiling
    from torch.profiler import ProfilerActivity, profile

    calls, codes = [], {"pnx_ok": 0, "pnx_bad": 7}

    def entry(name):
        return lambda *args: calls.append((name, args)) or codes[name]

    monkeypatch.setattr(kernels, "entry", entry)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=99))
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.annotate("outer"):
        kernels.launch("pnx_ok", 1, 2**46, 3)
    assert calls == [("pnx_ok", (1, 2**46, 3, 99))]
    events = {e.name: e for e in prof.events()}
    assert events["pnx::launch"].time_range.start >= events["outer"].time_range.start
    assert events["pnx::launch"].time_range.end <= events["outer"].time_range.end
    with pytest.raises(RuntimeError, match="pnx_bad: launch failed with error code 7"):
        kernels.launch("pnx_bad", 5)
