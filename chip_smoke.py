#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pillarnext_tpu_torch/csrc`` (one
``nvcc`` per source, all at once), drives the port's main paths at full
width, random weights from a seed:

- serving: frames through the port's AdaptivePredictor, bf16, batch 1, of
  the flagship PillarNeXt-B config (nusc_det_pp18_aspp_iou_sp);
- serving_voxel18: the same for the voxel18 config
  (nusc_det_voxel18_aspp_iou_sp: 40 x 1344 x 1344 voxels, the fully
  sparse 3-D ResNet, kernel 2 as its final densify), with its f32 BEV
  held bit-identical between kernel 2 and its plain version;
- train: the port's Trainer, bf16, batch 4 of seeded synthetic scenes
  at the dataloader's 300000-point capacity, five steps (flagship);
- train_voxel18: the same for voxel18 at its config's grid (the fully
  sparse 3-D ResNet's backward, kernel 2's densify and its backward),
  with each table's active count beside its rows, and an f32 step whose
  BEV must be bit-identical between the kernels and their plain versions;

then holds each kernel against its plain PyTorch version at the shapes
those paths give it.  Kernel 3 (``sorted_segment_bcast``) also carries
the segment sums of both readers (ops/scatter.py), so it runs on every
path.  An f32 model keeps TF32 off by itself (``model.precision()``):
the script sets no TF32 flag.  Each kernel record carries two times:
``ms``, the median of CUDA events around single calls of the wrapper (what the
serving path pays per call, host time included), and ``device_ms``, the
device time of the kernels those calls launched under torch.profiler
(likewise ``device_plain_ms`` and ``device_library_ms``).  The kernel
phase comes last so that torch.profiler has not traced the process while
the main paths are timed (whether tracing leaves later launches slower is
open).  ``bound_ms`` counts the bytes and operations that this run's data
needs; the inputs stay the same from call to call, so inputs and outputs
that fit the 50 MB L2 can beat it.  Kernel 3's records also carry its
launch shape and device launches per call, and one record gives the device
time of ``pillar_max_broadcast`` forward and backward with kernel 3's
share of it.

Each path runs with the launch counters set to 0 just before it and read
just after, and fails unless every kernel of that path launched.  Every
phase prints one JSON line; before the last line come the card's name and
power limit and the ``kernels`` line; the last line is ``{"ok": true,
"device": {...}}``.  Any mismatch raises and the script exits non-zero;
without a CUDA device it exits non-zero before doing anything.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
FLAGSHIP = REPO / "pillarnext_tpu/configs/experiments/nusc_det_pp18_aspp_iou_sp.yaml"
VOXEL18 = REPO / "pillarnext_tpu/configs/experiments/nusc_det_voxel18_aspp_iou_sp.yaml"
N_POINTS = 200_000
TIMED_RUNS = 25
PROFILED_CALLS = 20
PROFILE_WINDOWS = 4
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel, launched between profiled calls
LATENCY_FRAMES = 10
TRAIN_STEPS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 non-tensor


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def median_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median of per-run CUDA-event times after two warm-up runs."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def split_calls(events: list) -> list:
    """A window's device records in start order, cut at the marker kernels
    launched between calls into one list per call; records before the
    first marker and after the last are dropped."""
    groups, cur = [], None
    for e in sorted(events, key=lambda e: e.time_range.start):
        if MARKER in e.name:
            if cur is not None:
                groups.append(cur)
            cur = []
        elif cur is not None:
            cur.append(e)
    return groups


def device_profile(fn, calls: int = PROFILED_CALLS, launches: int | None = None) -> dict:
    """Device time of one call under torch.profiler: the summed duration of
    every CUDA kernel, copy and fill that one call launched, averaged over
    the whole calls of a window of ``calls`` (after one warm-up call); the
    same split by kernel name; the device records of a whole call; and how
    many calls were whole.  Unlike ``median_ms`` it leaves out the host
    time of the wrapper and of the launches.

    torch.profiler at times loses device records (on the H100: one in most
    windows, or all of a window).  A marker kernel (``torch.cuda._sleep``)
    launched between calls cuts the window into calls, and a call counts
    only when it holds ``launches`` records (by default the count most
    calls hold): a lost record drops its call, never part of one.  A
    window with no whole call is profiled again, up to
    ``PROFILE_WINDOWS`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                torch.cuda._sleep(1)
                fn()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        groups = split_calls([e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA])
        sizes = [len(g) for g in groups if g]
        want = launches if launches is not None else max(set(sizes), key=sizes.count, default=0)
        whole = [g for g in groups if g and len(g) == want]
        if whole:
            break
    else:
        raise AssertionError(f"torch.profiler recorded no whole call in {PROFILE_WINDOWS} windows")
    by_name: dict = {}
    for e in (e for g in whole for e in g):
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.device_time / 1e3 / len(whole)
    return {"device_ms": sum(by_name.values()), "device_ms_by_kernel": by_name,
            "device_launches_per_call": want, "device_whole_calls": len(whole), "device_calls": calls}


def device_ms(fn, calls: int = PROFILED_CALLS) -> float:
    return device_profile(fn, calls)["device_ms"]


def device_fields(kernel, plain, library=None, launches: int | None = None) -> dict:
    """``device_profile`` of a kernel's wrapper (whole calls hold
    ``launches`` device records, where given), and the device times of its
    plain version and library call."""
    return {**device_profile(kernel, launches=launches), "device_plain_ms": device_ms(plain),
            "device_library_ms": device_ms(library) if library is not None else None}


def bound(nbytes: float, flops: float, dtype) -> dict:
    """The least time the card could take: bytes over the memory rate, or
    operations over the peak rate for their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def frame(pc_range, seed: int, device):
    from pillarnext_tpu_torch.utils.synth import lidar_like_points

    pts, mask = lidar_like_points(1, N_POINTS, pc_range, seed=seed)
    return torch.from_numpy(pts).to(device), torch.from_numpy(mask).to(device)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise |a - b| in bf16 ulps of the larger magnitude, with
    magnitudes below 2^-9 counted at 2^-9 (ulp 2^-16 ~ 1.5e-5): there the
    two f32 summation orders (kernel vs matmul, up to 64 terms of inputs
    as large as the 50 m coordinates) differ by ~1e-5, the f32 bar, which
    can flip a value across the ReLU boundary (0 vs ~1e-7)."""
    a, b = a.float(), b.float()
    hi = torch.maximum(a.abs(), b.abs()).clamp(min=2.0**-9)
    return (a - b).abs() / torch.exp2(torch.floor(torch.log2(hi)) - 7)


def matched_fraction(a: dict, b: dict) -> float:
    """Share of two predictions' valid boxes that have a box of the same
    label within 1 cm of their centre in the other.  The distances are
    direct differences: cdist's matrix-product form (its default beyond 25
    rows) loses ~1 cm to cancellation at 50 m coordinates, so equal boxes
    could fail to match."""
    va, vb = a["valid"][0], b["valid"][0]
    ka = torch.cat([a["label_preds"][0][va, None].float(), a["box3d_lidar"][0][va, :3]], 1)
    kb = torch.cat([b["label_preds"][0][vb, None].float(), b["box3d_lidar"][0][vb, :3]], 1)
    if not (len(ka) and len(kb)):
        return 0.0
    dist = torch.cdist(ka, kb, compute_mode="donot_use_mm_for_euclid_dist")
    return int((dist.min(1).values < 1e-2).sum()) / max(len(ka), len(kb))


def same_prediction(a: dict, b: dict) -> bool:
    """Every output of two predictions is the same bits."""
    return all(torch.equal(a[k], b[k]) for k in a)


def check_pfn(reader, points, mask, gen, device, records):
    """Kernel 1 vs its plain version on the flagship's decorated points."""
    from pillarnext_tpu_torch.ops.pfn import pfn_launch_shape, pfn_two_layer, pfn_two_layer_plain

    df, c0, c1 = reader.num_input_features + 5, reader.num_filters[0] // 2, reader.num_filters[1]
    w0 = torch.randn(df, c0, generator=gen) / df**0.5
    w1 = torch.randn(2 * c0, c1, generator=gen) / (2 * c0) ** 0.5
    bn0 = torch.stack([torch.rand(c0, generator=gen) + 0.5, 0.2 * torch.randn(c0, generator=gen)])
    bn1 = torch.stack([torch.rand(c1, generator=gen) + 0.5, 0.2 * torch.randn(c1, generator=gen)])
    w0, w1, bn0, bn1 = (t.to(device) for t in (w0, w1, bn0, bn1))
    feats16, slot, _, _, cap, _ = reader.decorate(points, mask)  # bf16 model
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        feats = feats16.to(dtype)
        args = (feats, slot, w0, bn0, w1, bn1, cap)
        got, want = pfn_two_layer(*args), pfn_two_layer_plain(*args)
        torch.cuda.synchronize()
        zero_rows_equal = torch.equal((got == 0).all(1), (want == 0).all(1))
        err = (got.float() - want.float()).abs()
        # the bound counts what the function must do on this frame: the points
        # in slots below cap (the dump slot's need no work), layer 1's pillar
        # half once per occupied slot, every output row written once
        n, es = feats.shape[0], feats.element_size()
        n_eff = int((slot < cap).sum())
        occupied = int(torch.unique_consecutive(slot[:n_eff]).numel())
        nbytes = n_eff * (df * es + 4) + (cap + 1) * c1 * es
        nbytes += (df * c0 + 2 * c0 + 2 * c0 * c1 + 2 * c1) * 4
        flops = 2.0 * n_eff * (df * c0 + c0 * c1) + 2.0 * occupied * c0 * c1
        rec = {
            "phase": "kernel_vs_plain", "kernel": "pfn_two_layer", "dtype": str(dtype),
            "shape": {"points": n, "df": df, "c0": c0, "c1": c1, "cap": cap},
            "points_below_cap": n_eff, "occupied_pillars": occupied,
            "launch_shape": pfn_launch_shape(c0, c1, dtype),
            "max_points_per_pillar": int(torch.bincount(slot[slot < cap].long()).max()),
            "max_abs_err": float(err.max()), "zero_rows_equal": zero_rows_equal,
            "ms": median_ms(lambda: pfn_two_layer(*args)),
            "plain_ms": median_ms(lambda: pfn_two_layer_plain(*args)),
            "library_ms": None,
            **bound(nbytes, flops, dtype),
        }
        if dtype == torch.float32:
            ok = torch.allclose(got, want, atol=1e-5, rtol=1e-5)
            rec["tolerance"] = "atol=rtol=1e-5"
        else:
            ulps = bf16_ulps(got, want)
            rec["elements_differing"] = int((got != want).sum())
            rec["relu_boundary_flips"] = int(((got == 0) != (want == 0)).sum())
            rec["elements_total"] = ulps.numel()
            rec["max_ulp"] = float(ulps.max())
            ok = rec["max_ulp"] <= 1.0
            rec["tolerance"] = "<= 1 bf16 ulp of the larger magnitude, floored at 2^-9"
        rec.update(device_fields(lambda: pfn_two_layer(*args), lambda: pfn_two_layer_plain(*args)))
        emit(rec)
        if not (ok and zero_rows_equal):
            raise AssertionError(f"pfn_two_layer disagrees with its plain version: {rec}")
        out[str(dtype)] = rec
    records["pfn_two_layer"] = out["torch.bfloat16"]
    return slot, cap


@contextlib.contextmanager
def captured(module, name: str):
    """Inside the block, every call of the kernel wrapper ``module.name``
    also appends a copy of its tensor arguments to the yielded list."""
    real, calls = getattr(module, name), []

    def capture(*args):
        calls.append(tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args))
        return real(*args)

    setattr(module, name, capture)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def train_step_calls(model_cfg, batch, device, module, name: str) -> list:
    """The arguments of every call of ``module.name`` in one bf16 train
    step (forward and backward, no update) of ``model_cfg`` on ``batch``."""
    from pillarnext_tpu_torch.train.trainer import batch_to_device
    from pillarnext_tpu_torch.utils.builders import build_model

    model = build_model(model_cfg, device=device, generator=torch.Generator().manual_seed(0), train=True)
    with captured(module, name) as calls:
        loss, _ = model.loss(batch_to_device(batch, device))
        loss.backward()
    del model, loss
    return calls


def named(names: tuple, calls: list, what: str) -> list:
    if len(calls) != len(names):
        raise AssertionError(f"{what} made {len(calls)} calls, expected {len(names)}")
    return [(n, *c) for n, c in zip(names, calls)]


def train_gather_inputs(cfg, vcfg, batch, vbatch, device) -> list:
    """(name, table, idx) of every kernel-2 launch in one bf16 train step
    of each family: the flagship's cluster-mean gather, its H/8 densify
    and the densify's backward gather; voxel18's final densify at
    (2, 168, 168) and its backward gather."""
    from pillarnext_tpu_torch.ops import densify, scatter

    with captured(scatter, "monotone_row_gather") as cluster:
        dens = train_step_calls(cfg["model"], batch, device, densify, "monotone_row_gather")
    voxel = train_step_calls(vcfg["model"], vbatch, device, densify, "monotone_row_gather")
    return (named(("train_cluster_mean_gather", "train_densify_h8", "train_densify_backward"), cluster + dens,
                  "a flagship train step's kernel 2")
            + named(("train_voxel18_densify", "train_voxel18_densify_backward"), voxel,
                    "a voxel18 train step's kernel 2"))


def segment_sum_inputs(model, points, mask, vmodel, vpoints, vmask, cfg, vcfg, batch, vbatch, device) -> list:
    """(name, x, seg, reduce) of kernel 3's segment sums (ops/scatter.py)
    on the four main paths: the flagship's cluster mean and voxel18's
    voxel mean in a serving frame and in a bf16 train step, and the ties
    count of the flagship PFN's last-layer max in its backward."""
    from pillarnext_tpu_torch.ops import scatter

    with torch.inference_mode(), captured(scatter, "sorted_segment_bcast") as serving:
        model.reader(points, mask)
        vmodel.reader(vpoints, vmask)
    train = train_step_calls(cfg["model"], batch, device, scatter, "sorted_segment_bcast")
    vtrain = train_step_calls(vcfg["model"], vbatch, device, scatter, "sorted_segment_bcast")
    return named(("serving_cluster_mean", "serving_voxel_mean", "train_cluster_mean", "train_pfn_max_ties",
                  "train_voxel_mean"), serving + train + vtrain, "the segment sums")


def check_gather(reader, points, mask, slot, cap, gen, device, records, path_cases):
    """Kernel 2 vs its plain version, bit-exact, at the main paths' shapes:
    the flagship serving shapes on random tables, and ``path_cases`` — the
    tables and index streams of a train step of each family and of the
    voxel18 serving densify, in the dtypes those paths used."""
    from pillarnext_tpu_torch.ops.compact import invert_slot_map
    from pillarnext_tpu_torch.ops.gather import monotone_row_gather, monotone_row_gather_plain

    _, _, slot_id, _, _, _ = reader.decorate(points, mask)
    slot_of_dense, _ = invert_slot_map(slot_id, reader.grid.num_pillars)

    def random_table(rows, c, dtype):
        return torch.randn(rows, c, generator=gen).to(device=device, dtype=dtype)

    cases = [
        ("densify", random_table(cap, 64, torch.bfloat16), slot_of_dense),
        ("pfn_back_gather", random_table(cap, 32, torch.bfloat16), slot),
        ("cluster_mean_gather", random_table(cap, 3, torch.float32), slot),
        *path_cases,
    ]
    for name, table, idx in cases:
        (rows, c), dtype = table.shape, table.dtype
        got = monotone_row_gather(table, idx)
        want = monotone_row_gather_plain(table, idx)
        torch.cuda.synchronize()
        es = table.element_size()
        # the library call: index_select on the table with its zero dump row
        # (the densify's own (cap + 1)-row table), which the idx stream
        # addresses directly
        full = torch.cat([table, table.new_zeros((1, c))])
        # the bound reads each table row that an index refers to once
        rows_read = int(torch.unique(idx[(idx >= 0) & (idx < rows)]).numel())
        rec = {
            "phase": "kernel_vs_plain", "kernel": "monotone_row_gather", "case": name,
            "dtype": str(dtype), "shape": {"rows": idx.shape[0], "table_rows": rows, "c": c},
            "table_rows_read": rows_read,
            "bit_exact": torch.equal(got, want),
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "ms": median_ms(lambda: monotone_row_gather(table, idx)),
            "plain_ms": median_ms(lambda: monotone_row_gather_plain(table, idx)),
            "library_ms": median_ms(lambda: full.index_select(0, idx)),
            **bound(rows_read * c * es + idx.shape[0] * (4 + c * es), 0.0, dtype),
        }
        rec.update(device_fields(lambda: monotone_row_gather(table, idx),
                                 lambda: monotone_row_gather_plain(table, idx),
                                 lambda: full.index_select(0, idx)))
        emit(rec)
        if not rec["bit_exact"]:
            raise AssertionError(f"monotone_row_gather is not bit-exact: {rec}")
        records.setdefault("gather_cases", {})[name] = rec
        if name == "densify":
            records["monotone_row_gather"] = rec


def check_segscan(train_slot, gen, device, records, sum_cases):
    """Kernel 3 vs its plain version at the train shape (B = 4 x 300000
    points, 32 channels), on the train batch's own slot stream and on a
    stream whose last segment holds half the rows (600k), and on
    ``sum_cases``, the rows and slot streams of the segment sums the main
    paths run (ops/scatter.py, f32): max bit-exact, sum within 1e-5 of the
    segment's sum of magnitudes in f32 (sums in another order; the plain
    version adds with atomics) and one bf16 rounding in bf16.  Each record
    carries the tile kernel's launch shape and the device launches of one
    call, as the wrapper plans them and as the profiler counted them."""
    from pillarnext_tpu_torch.ops.segscan import (
        device_launches,
        segscan_launch_shape,
        sorted_segment_bcast,
        sorted_segment_bcast_plain,
        vector_bytes,
    )

    def check(case, x, seg, reduce):
        got = sorted_segment_bcast(x, seg, reduce)
        want = sorted_segment_bcast_plain(x, seg, reduce)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        (n, c), dtype, es = x.shape, x.dtype, x.element_size()
        rec = {
            "phase": "kernel_vs_plain", "kernel": "sorted_segment_bcast", "case": case,
            "dtype": str(dtype), "reduce": reduce,
            "shape": {"rows": n, "c": c, "segments": int(torch.unique_consecutive(seg).numel())},
            "max_abs_err": float(err.max()), "bit_exact": torch.equal(got, want),
        }
        if reduce == "max":
            ok, rec["tolerance"] = torch.equal(got, want), "bit-exact"
        elif dtype == torch.float32:
            mag = sorted_segment_bcast_plain(x.abs(), seg, "sum")
            ok, rec["tolerance"] = bool((err <= 1e-5 * mag).all()), "<= 1e-5 of the segment's sum of |x|"
            rec["max_err_over_magnitude"] = float((err / mag.clamp(min=1e-30)).max())
        else:
            ok, rec["tolerance"] = float(bf16_ulps(got, want).max()) <= 1.0, "<= 1 bf16 ulp"
        rec.update({
            "ms": median_ms(lambda: sorted_segment_bcast(x, seg, reduce)),
            "plain_ms": median_ms(lambda: sorted_segment_bcast_plain(x, seg, reduce)),
            "library_ms": None,
            **bound(n * c * es * 2 + n * 4, float(n * c), dtype),
            "launch_shape": segscan_launch_shape(dtype, reduce, vector_bytes(x, got)),
            "device_launches_planned": device_launches(n),
        })
        rec.update(device_fields(lambda: sorted_segment_bcast(x, seg, reduce),
                                 lambda: sorted_segment_bcast_plain(x, seg, reduce),
                                 launches=device_launches(n)))
        emit(rec)
        if not ok:
            raise AssertionError(f"sorted_segment_bcast disagrees with its plain version: {rec}")
        return rec

    n = train_slot.shape[0]
    half = n // 2  # 600k rows at the train shape
    giant = torch.cat([
        torch.sort(torch.randint(0, max(half // 5, 1), (n - half,), generator=gen)).values,
        torch.full((half,), half // 5 + 1),
    ]).to(device=device, dtype=torch.int32)
    for case, seg in (("train_slots", train_slot), ("one_segment_of_half", giant)):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(n, 32, generator=gen).to(device=device, dtype=dtype)
            for reduce in ("max", "sum"):
                rec = check(case, x, seg, reduce)
                if case == "train_slots" and dtype == torch.bfloat16 and reduce == "max":
                    records["sorted_segment_bcast"] = rec
    records["segment_sums"] = {case: check(case, x, seg, reduce) for case, x, seg, reduce in sum_cases}
    max_broadcast_record(train_slot, gen, device)


def max_broadcast_record(seg, gen, device):
    """Device time of ``pillar_max_broadcast`` forward + backward at the
    train shape (bf16 rows, as the PFN's training forward gives them), and
    kernel 3's share of it: the rest is the backward's elementwise glue."""
    from pillarnext_tpu_torch.ops.segscan import pillar_max_broadcast

    with torch.inference_mode(False), torch.enable_grad():
        seg = seg.clone()
        x = torch.relu(torch.randn(seg.shape[0], 32, generator=gen)).to(device, torch.bfloat16)
        x.requires_grad_()
        cot = torch.randn(seg.shape[0], 32, generator=gen).to(device, torch.bfloat16)

        def step():
            pillar_max_broadcast(x, seg).backward(cot)
            x.grad = None

        prof = device_profile(step)
    by_name = prof["device_ms_by_kernel"]
    kernel_ms = sum(v for k, v in by_name.items() if "seg_tile_kernel" in k or "seg_fill_kernel" in k)
    emit({"phase": "pillar_max_broadcast_fwd_bwd", "shape": {"rows": seg.shape[0], "c": 32},
          "dtype": "torch.bfloat16", **prof, "kernel3_device_ms": kernel_ms,
          "kernel3_share": kernel_ms / prof["device_ms"]})


def layer_breakdown(model, points, mask, capacity):
    """CUDA-synchronised host time of each layer of one predict (ms)."""
    from pillarnext_tpu_torch.core import nms

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    nms_ms = []
    rotated_nms = nms.rotated_nms

    def timed_nms(*args):
        out, ms = timed(lambda: rotated_nms(*args))
        nms_ms.append(ms)
        return out

    cfg = model.post_processing
    if cfg.get("candidate_sparse_head", False):
        def head(x):
            return model.head(x, test_cfg=cfg)
    else:
        def head(x):
            return model.head.predict(model.head(x), cfg)

    tel = {}
    with torch.inference_mode():
        sb, reader_ms = timed(lambda: model.reader(points, mask, capacity=capacity, telemetry=tel))
        x, backbone_ms = timed(lambda: model.backbone(sb))
        x, neck_ms = timed(lambda: model.neck(x))
        nms.rotated_nms = timed_nms
        try:
            _, head_ms = timed(lambda: head(x))
        finally:
            nms.rotated_nms = rotated_nms
    return {
        "reader": reader_ms, "backbone": backbone_ms, "neck": neck_ms,
        "head_decode_nms": head_ms, "of_which_nms": sum(nms_ms),
    }


def train_breakdown(model, optimizer, batch, device):
    """CUDA-synchronised host time of each part of one train step (ms)."""
    from pillarnext_tpu_torch.train.trainer import batch_to_device

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    model.train()
    ex, h2d_ms = timed(lambda: batch_to_device(batch, device))
    sb, reader_ms = timed(lambda: model.reader(ex["points"], ex["points_mask"]))
    x, backbone_ms = timed(lambda: model.backbone(sb))
    x, neck_ms = timed(lambda: model.neck(x))
    (loss, _), head_ms = timed(lambda: model.head.loss(ex, model.head(x)))
    for p in optimizer.params:
        p.grad = None
    _, backward_ms = timed(loss.backward)
    _, opt_ms = timed(optimizer.step)
    return {"host_to_device": h2d_ms, "reader": reader_ms, "backbone": backbone_ms,
            "neck": neck_ms, "head_and_loss": head_ms, "backward": backward_ms,
            "clip_adamw": opt_ms}


def profile_train_steps(model, optimizer, batches, device, steps: int = 2) -> dict:
    """``profile_device`` of ``steps`` train steps."""
    from pillarnext_tpu_torch.train.train_state import train_step
    from pillarnext_tpu_torch.train.trainer import batch_to_device

    it = iter(batches[:steps])
    return profile_device(lambda: train_step(model, optimizer, batch_to_device(next(it), device)), steps)


def profile_device(run, steps: int) -> dict:
    """Device time of ``steps`` calls of ``run`` (a train step, a frame)
    under torch.profiler: the card's busy share of the wall time, kernel
    launches, and the kernels and the PyTorch ops whose kernels took the
    most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:10]
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "launches_per_step": len(kernels) / steps,
            "top_kernels_ms_per_step": [
                {"name": k[:90], "ms": t / steps, "launches": n / steps} for k, (t, n) in top
            ],
            "top_ops_ms_per_step": [
                {"op": e.key[:60], "ms": e.self_device_time_total / 1e3 / steps, "calls": e.count / steps}
                for e in ops if e.self_device_time_total > 0
            ]}


class TimedLoader:
    """The train batches, with a CUDA-synchronised timestamp at each yield:
    the time between two yields is one step of the Trainer."""

    def __init__(self, batches):
        self.batches = batches
        self.stamps: list[float] = []

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for b in self.batches:
            torch.cuda.synchronize()
            self.stamps.append(time.perf_counter())
            yield b
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())


def serving_path(cfg, model, pc_range, device):
    """The serving main path, bf16, through AdaptivePredictor."""
    from pillarnext_tpu_torch.ops.gather import monotone_row_gather
    from pillarnext_tpu_torch.ops.pfn import pfn_two_layer
    from pillarnext_tpu_torch.ops.segscan import sorted_segment_bcast
    from pillarnext_tpu_torch.serving import AdaptivePredictor

    engine = AdaptivePredictor(model)
    frames = [frame(pc_range, seed, device) for seed in (0, 1, 2)]
    counters = (pfn_two_layer, monotone_row_gather, sorted_segment_bcast)
    for k in counters:
        k.launches = 0
    engine.warmup(*frames[0])
    per_frame = []
    for seed, (p, m) in zip((0, 1, 2), frames):
        out = engine.predict(p, m)
        d = 10 * int(cfg["post_processing"]["nms"]["nms_post_max_size"])
        for key in ("box3d_lidar", "scores", "label_preds", "valid"):
            if tuple(out[key].shape[:2]) != (1, d):
                raise AssertionError(f"{key} has shape {tuple(out[key].shape)}, expected (1, {d}, ...)")
        if not (torch.isfinite(out["box3d_lidar"]).all() and torch.isfinite(out["scores"]).all()):
            raise AssertionError(f"non-finite detections for frame seed {seed}")
        per_frame.append({"seed": seed, "valid": int(out["valid"].sum())})
    latencies = []
    for _ in range(LATENCY_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.predict(*frames[0])
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    launches = {k.__name__: k.launches for k in counters}
    emit({"phase": "main_path", "path": "serving", "dtype": "bfloat16", "frames": per_frame,
          "buckets": list(engine.buckets), "operating_bucket": engine._operating_bucket(),
          "peak_required": engine.peak_required, "repaired": engine.repaired,
          "latency_ms_median": statistics.median(latencies), "latency_ms": latencies,
          "launches": launches,
          "breakdown_ms": layer_breakdown(model, *frames[0], engine._operating_bucket()),
          "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2**20})
    for name in ("pfn_two_layer", "monotone_row_gather", "sorted_segment_bcast"):
        if launches[name] == 0:
            raise AssertionError(f"the serving path never launched {name}")
    return frames, launches


def table_report(model, tel: dict, bucket: int, batch: int = 1) -> dict:
    """Each compact table of a voxel18 predict: its active count (the
    reader's voxels, each strided stage's sites) beside its rows."""
    grid = model.reader.grid
    spatial = (grid.size_z, grid.size_y, grid.size_x)
    cap = min(bucket * batch, grid.num_voxels * batch)
    caps = {"voxel": cap, **model.backbone.table_capacities(cap, batch, spatial)}
    return {name: {"active": int(tel[f"{name}_active"]), "capacity": c,
                   "overflow": int(tel[f"{name}_overflow"])} for name, c in caps.items()}


def voxel_serving_path(cfg, device):
    """The voxel18 serving main path, bf16, batch 1, through
    AdaptivePredictor at the config's 40 x 1344 x 1344 grid."""
    from pillarnext_tpu_torch.ops.gather import monotone_row_gather
    from pillarnext_tpu_torch.ops.pfn import pfn_two_layer
    from pillarnext_tpu_torch.ops.segscan import sorted_segment_bcast
    from pillarnext_tpu_torch.serving import AdaptivePredictor
    from pillarnext_tpu_torch.utils.builders import build_model

    pc_range = cfg["model"]["reader"]["pc_range"]
    model = build_model(cfg["model"], device=device, generator=torch.Generator().manual_seed(0))
    engine = AdaptivePredictor(model)
    frames = [frame(pc_range, seed, device) for seed in (0, 1, 2)]
    counters = (pfn_two_layer, monotone_row_gather, sorted_segment_bcast)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in counters:
        k.launches = 0
    engine.warmup(*frames[0])
    per_frame = []
    d = 10 * int(cfg["model"]["post_processing"]["nms"]["nms_post_max_size"])
    for seed, (p, m) in zip((0, 1, 2), frames):
        out = engine.predict(p, m)
        for key in ("box3d_lidar", "scores", "label_preds", "valid"):
            if tuple(out[key].shape[:2]) != (1, d):
                raise AssertionError(f"voxel18 {key} has shape {tuple(out[key].shape)}, expected (1, {d}, ...)")
        if not (torch.isfinite(out["box3d_lidar"]).all() and torch.isfinite(out["scores"]).all()):
            raise AssertionError(f"voxel18: non-finite detections for frame seed {seed}")
        bucket = engine._operating_bucket()
        tel = {}
        with torch.inference_mode():
            model.predict(p, m, capacity=bucket, telemetry=tel)
        per_frame.append({"seed": seed, "valid": int(out["valid"].sum()), "bucket": bucket,
                          "tables": table_report(model, tel, bucket)})
    latencies = []
    for _ in range(LATENCY_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.predict(*frames[0])
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    launches = {k.__name__: k.launches for k in counters}
    emit({"phase": "main_path", "path": "serving_voxel18", "dtype": "bfloat16", "frames": per_frame,
          "buckets": list(engine.buckets), "operating_bucket": engine._operating_bucket(),
          "peak_required": engine.peak_required, "repaired": engine.repaired,
          "latency_ms_median": statistics.median(latencies), "latency_ms": latencies,
          "launches": launches,
          "breakdown_ms": layer_breakdown(model, *frames[0], engine._operating_bucket()),
          "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2**20})
    for name in ("monotone_row_gather", "sorted_segment_bcast"):
        if launches[name] == 0:
            raise AssertionError(f"the voxel18 serving path never launched {name}")
    return model, frames, launches


def voxel_f32_kernels_vs_plain(cfg, points, mask, device):
    """The f32 voxel18 backbone on one reader table with kernel 2 and with
    its plain version: the densify is an exact copy, so the BEV must be
    bit-identical.  The frame's detections, kernel vs plain, are reported
    as a matched fraction (the reader runs again in each predict; its
    mean is the same bits on both routes)."""
    from pillarnext_tpu_torch.utils.builders import build_model

    model = build_model(dict(cfg["model"], dtype="float32"), device=device,
                        generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        sb = model.reader(points, mask)
        bev, bev_plain = model.backbone(sb), model.backbone(sb, plain=True)
        a, b = model.predict(points, mask), model.predict(points, mask, plain=True)
    rec = {"phase": "voxel18_f32_kernels_vs_plain", "bev_shape": list(bev.shape),
           "bev_bit_identical": torch.equal(bev, bev_plain),
           "bev_max_abs_diff": float((bev - bev_plain).abs().max()),
           "bev_nonzero_share": float((bev != 0).float().mean()),
           "valid": [int(a["valid"][0].sum()), int(b["valid"][0].sum())],
           "matched_fraction": matched_fraction(a, b), "bit_identical": same_prediction(a, b)}
    emit(rec)
    if not rec["bev_bit_identical"]:
        raise AssertionError(f"voxel18 f32 BEV differs between kernel 2 and its plain version: {rec}")


def voxel_gather_inputs(model, points, mask) -> list:
    """(name, table, idx) of kernel 2's one launch in a bf16 voxel18
    forward: the densify at the final (2, 168, 168) grid."""
    from pillarnext_tpu_torch.ops import densify

    with torch.inference_mode(), captured(densify, "monotone_row_gather") as calls:
        model.backbone(model.reader(points, mask))
    return named(("voxel18_densify",), calls, "a voxel18 forward's kernel 2")


def train_path(cfg, batches, device, work_dir, path: str, required: tuple):
    """A training main path, bf16, B = 4, through the port's Trainer: its
    record carries the step times, losses, the last step's tables (each
    active count beside its rows, voxel18), peak memory, a breakdown and a
    2-step device profile; it fails unless every kernel in ``required``
    launched."""
    from pillarnext_tpu_torch.ops.gather import monotone_row_gather
    from pillarnext_tpu_torch.ops.pfn import pfn_two_layer
    from pillarnext_tpu_torch.ops.segscan import sorted_segment_bcast
    from pillarnext_tpu_torch.train.trainer import Trainer
    from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer

    model = build_model(cfg["model"], device=device, generator=torch.Generator().manual_seed(0), train=True)
    opt, sched = build_optimizer(cfg, len(batches), list(model.parameters()))
    loader = TimedLoader(batches)
    trainer = Trainer(model, loader, opt, sched, max_epochs=1, log_every_niters=1,
                      work_dir=work_dir, device=device)
    counters = (pfn_two_layer, monotone_row_gather, sorted_segment_bcast)
    torch.cuda.reset_peak_memory_stats()
    for k in counters:
        k.launches = 0
    trainer.train_epoch()
    launches = {k.__name__: k.launches for k in counters}
    losses = [float(v) for v in trainer.epoch_losses]
    tel = {k: int(v) for k, v in trainer.last_scalars["telemetry"].items()}
    step_ms = [(b - a) * 1e3 for a, b in zip(loader.stamps[:-1], loader.stamps[1:])]
    batch_size = int(batches[0]["points"].shape[0])
    rec = {
        "phase": "main_path", "path": path, "dtype": cfg["model"].get("dtype", "bfloat16"),
        "batch_size": batch_size, "max_points": int(batches[0]["points"].shape[1]),
        "points_per_scene": N_POINTS, "steps": len(step_ms), "losses": losses,
        "grad_norm_last": float(trainer.last_scalars["grad_norm"]),
        "step_ms": step_ms, "step_ms_median_after_first": statistics.median(step_ms[1:]),
        "telemetry_last_step": tel, "launches": launches,
        "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2**20,
    }
    if "voxel_active" in tel:
        rec["tables_last_step"] = table_report(model, tel, model.reader.capacity, batch_size)
    rec["breakdown_ms"] = train_breakdown(model, opt, batches[0], device)
    rec["profile"] = profile_train_steps(model, opt, batches, device)
    emit(rec)
    if len(losses) < TRAIN_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{path} path losses: {losses}")
    for name in required:
        if launches[name] == 0:
            raise AssertionError(f"the {path} path never launched {name}")
    return model, launches


def f32_train_kernels_vs_plain(cfg, batch, device, phase: str):
    """One f32 train step with the kernels and one with their plain
    versions, same weights and batch, PyTorch's deterministic algorithms
    on.  Kernel 3's max and kernel 2's gathers are exact and the segment
    sums run the same way on both routes, so the losses agree to 1e-6
    relative; the gradients differ by kernel 3's ``sum`` order in the
    flagship PFN's backward: each tensor within 1e-3 of its largest
    magnitude.  For voxel18 the backbone's output in train mode must also
    be bit-identical on both routes."""
    from pillarnext_tpu_torch.models.voxel_encoder import VoxelFeatureNet
    from pillarnext_tpu_torch.train.train_state import train_step
    from pillarnext_tpu_torch.train.trainer import batch_to_device
    from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer

    cfg32 = dict(cfg["model"], dtype="float32")
    ex = batch_to_device(batch, device)
    runs, rec = [], {"phase": phase}
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for plain in (False, True):
            model = build_model(cfg32, device=device, generator=torch.Generator().manual_seed(0), train=True)
            if isinstance(model.reader, VoxelFeatureNet) and not plain:
                with torch.no_grad(), model.precision():
                    sb = model.reader(ex["points"], ex["points_mask"])
                    bev, bev_plain = model.backbone(sb), model.backbone(sb, plain=True)
                rec.update(bev_shape=list(bev.shape), bev_bit_identical=torch.equal(bev, bev_plain),
                           bev_max_abs_diff=float((bev - bev_plain).abs().max()))
                del sb, bev, bev_plain
            opt, _ = build_optimizer(cfg, 10, list(model.parameters()))
            scalars, _ = train_step(model, opt, ex, plain=plain)
            runs.append((float(scalars["loss"]), {n: p.grad.clone() for n, p in model.named_parameters()}))
            del model, opt
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    (l_k, g_k), (l_p, g_p) = runs
    rel = {n: float((g_k[n] - g_p[n]).abs().max() / g_p[n].abs().max().clamp(min=1e-30)) for n in g_k}
    worst = max(rel, key=rel.get)
    rec.update({"loss_kernels": l_k, "loss_plain": l_p,
                "loss_abs_diff": abs(l_k - l_p), "max_rel_grad_diff": rel[worst], "worst_tensor": worst,
                "grads_bit_identical": all(torch.equal(g_k[n], g_p[n]) for n in g_k),
                "tolerance": "loss within 1e-6 relative; every gradient within 1e-3 of its largest magnitude"})
    emit(rec)
    if abs(l_k - l_p) > 1e-6 * abs(l_p) or rel[worst] > 1e-3 or rec.get("bev_bit_identical") is False:
        raise AssertionError(f"f32 train step with kernels disagrees with plain: {rec}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; a CUDA GPU is required")
    sys.path.insert(0, str(REPO))
    from pillarnext_tpu_torch.data.synthetic import synthetic_batches
    from pillarnext_tpu_torch.ops import kernels
    from pillarnext_tpu_torch.utils.builders import build_model
    from pillarnext_tpu_torch.utils.config import load_experiment

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)})

    # phase 2: build every kernel from the checkout's sources
    t0 = time.perf_counter()
    _, build = kernels.library()
    ptxas = [ln.strip() for ln in build["ptxas"].splitlines()
             if "registers" in ln or "Compiling" in ln or "spill" in ln]
    emit({"phase": "build", "nvcc_seconds": build["seconds"],
          "wall_seconds": time.perf_counter() - t0, "ptxas": ptxas})

    cfg = load_experiment(FLAGSHIP)
    pc_range = cfg["model"]["reader"]["pc_range"]
    t0 = time.perf_counter()
    batch_size = int(cfg["dataloader"]["train"]["batch_size"])
    batches = synthetic_batches(cfg, TRAIN_STEPS, batch_size, N_POINTS, seed=0)
    emit({"phase": "train_data", "batches": len(batches), "batch_size": batch_size,
          "points_per_scene": N_POINTS, "max_points": int(cfg["dataloader"]["max_points"]),
          "host_seconds": time.perf_counter() - t0})

    # phase 3: the serving main path, bf16
    model = build_model(cfg["model"], device=device, generator=torch.Generator().manual_seed(0))
    frames, serve_launches = serving_path(cfg["model"], model, pc_range, device)

    # phase 4: how far the detections of one frame move: f32 and bf16
    # kernels vs plain versions (reported), and bf16 kernels run twice,
    # which must give the same bits (the segment sums are deterministic)
    cfg32 = dict(cfg["model"], dtype="float32")
    model32 = build_model(cfg32, device=device, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        a32, b32 = model32.predict(*frames[0]), model32.predict(*frames[0], plain=True)
        a16, r16 = model.predict(*frames[0]), model.predict(*frames[0])
        b16 = model.predict(*frames[0], plain=True)
    for name, a, b in (("f32_kernels_vs_plain", a32, b32), ("bf16_kernels_vs_plain", a16, b16),
                       ("bf16_kernels_repeat", a16, r16)):
        emit({"phase": name, "valid": [int(a["valid"][0].sum()), int(b["valid"][0].sum())],
              "matched_fraction": matched_fraction(a, b), "bit_identical": same_prediction(a, b)})
    if not same_prediction(a16, r16):
        raise AssertionError("two bf16 predicts of one frame differ: the serving path is not deterministic")
    del model, model32, frames
    torch.cuda.empty_cache()

    # phase 5: the voxel18 serving main path, bf16, batch 1, at the config's
    # 40 x 1344 x 1344 grid; then its f32 BEV with kernel 2 and with the
    # plain version, and the densify's inputs for the kernel phase
    vcfg = load_experiment(VOXEL18)
    vmodel, vframes, voxel_launches = voxel_serving_path(vcfg, device)
    voxel_cases = voxel_gather_inputs(vmodel, *vframes[0])
    del vmodel
    torch.cuda.empty_cache()
    voxel_f32_kernels_vs_plain(vcfg, *vframes[0], device)
    del vframes
    torch.cuda.empty_cache()

    # phase 6: the training main path, bf16, B = 4, through the Trainer
    # (its checkpoint goes to a directory of the checkout that is removed)
    with tempfile.TemporaryDirectory(dir=REPO) as work_dir:
        train_model, train_launches = train_path(cfg, batches, device, work_dir, "train",
                                                 ("monotone_row_gather", "sorted_segment_bcast"))
    del train_model
    torch.cuda.empty_cache()

    # phase 7: f32 train step, kernels vs plain versions
    f32_train_kernels_vs_plain(cfg, batches[0], device, "f32_train_kernels_vs_plain")

    # phase 8: voxel18 training, bf16, B = 4 at the config's grid, through
    # the Trainer; then an f32 step, kernels vs plain versions
    t0 = time.perf_counter()
    vbatches = synthetic_batches(vcfg, TRAIN_STEPS, batch_size, N_POINTS, seed=0)
    emit({"phase": "train_data", "config": "voxel18", "batches": len(vbatches), "batch_size": batch_size,
          "points_per_scene": N_POINTS, "max_points": int(vcfg["dataloader"]["max_points"]),
          "host_seconds": time.perf_counter() - t0})
    with tempfile.TemporaryDirectory(dir=REPO) as work_dir:
        train_model, vtrain_launches = train_path(vcfg, vbatches, device, work_dir, "train_voxel18",
                                                  ("monotone_row_gather", "sorted_segment_bcast"))
    del train_model
    torch.cuda.empty_cache()
    f32_train_kernels_vs_plain(vcfg, vbatches[0], device, "voxel18_f32_train_kernels_vs_plain")
    torch.cuda.empty_cache()

    # phase 9: each kernel vs its plain version at the main paths' shapes (after
    # the main paths, so that torch.profiler has not traced the process they run in)
    gen = torch.Generator().manual_seed(0)
    model = build_model(cfg["model"], device=device, generator=gen)
    vmodel = build_model(vcfg["model"], device=device, generator=torch.Generator().manual_seed(0))
    points, mask = frame(pc_range, 0, device)
    vpoints, vmask = frame(vcfg["model"]["reader"]["pc_range"], 0, device)
    records: dict = {}
    train_cases = train_gather_inputs(cfg, vcfg, batches[0], vbatches[0], device)
    sum_cases = segment_sum_inputs(model, points, mask, vmodel, vpoints, vmask, cfg, vcfg,
                                   batches[0], vbatches[0], device)
    torch.cuda.empty_cache()
    with torch.inference_mode():
        slot, cap = check_pfn(model.reader, points, mask, gen, device, records)
        check_gather(model.reader, points, mask, slot, cap, gen, device, records,
                     train_cases + voxel_cases)
        del train_cases, voxel_cases
        pts = torch.from_numpy(batches[0]["points"]).to(device)
        pmask = torch.from_numpy(batches[0]["points_mask"]).to(device)
        train_cap = int(cfg["model"]["reader"]["train_pillar_capacity"])
        train_slot = model.reader.decorate(pts, pmask, train_cap)[1]
        check_segscan(train_slot, gen, device, records, sum_cases)
        del pts, pmask, train_slot, sum_cases

    # phase 10: where a serving frame's time goes on the device, for both
    # serving paths at the reader's largest bucket (profiled last, as above)
    with torch.inference_mode():
        for path, mdl, (p, m) in (("serving", model, (points, mask)),
                                  ("serving_voxel18", vmodel, (vpoints, vmask))):
            mdl.predict(p, m)
            emit({"phase": "frame_profile", "path": path,
                  "predict": profile_device(lambda: mdl.predict(p, m), 3),
                  "reader_and_backbone": profile_device(lambda: mdl.backbone(mdl.reader(p, m)), 3)})
    del vmodel, vpoints, vmask

    summary_keys = ("shape", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "device_ms", "device_plain_ms", "device_library_ms")

    def summary(rec):
        return {k: rec[k] for k in summary_keys}

    def line(name, route, source, replaces, launches, **extra):
        rec = records[name]
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "device_ms": rec["device_ms"], "device_library_ms": rec["device_library_ms"], **extra}

    paths = {"serving": serve_launches, "serving_voxel18": voxel_launches, "train": train_launches,
             "train_voxel18": vtrain_launches}
    gather_launches = {p: n["monotone_row_gather"] for p, n in paths.items()}
    bcast_launches = {p: n["sorted_segment_bcast"] for p, n in paths.items()}
    cases = records["gather_cases"]
    kernels_line = [
        line("pfn_two_layer", "cuda", "pillarnext_tpu_torch/csrc/pfn.cu",
             "pillarnext_tpu/ops/pallas_pfn.py:93", serve_launches["pfn_two_layer"]),
        line("monotone_row_gather", "cuda", "pillarnext_tpu_torch/csrc/gather.cu",
             "pillarnext_tpu/ops/pallas_gather.py:60", sum(gather_launches.values()),
             launches_by_path=gather_launches,
             voxel18_densify=summary(cases["voxel18_densify"]),
             train_voxel18_densify=summary(cases["train_voxel18_densify"]),
             train_voxel18_densify_backward=summary(cases["train_voxel18_densify_backward"])),
        line("sorted_segment_bcast", "cuda", "pillarnext_tpu_torch/csrc/segscan.cu",
             "pillarnext_tpu/ops/pallas_segscan.py:124", sum(bcast_launches.values()),
             launches_by_path=bcast_launches,
             launches_per_train_step={p: bcast_launches[p] / TRAIN_STEPS for p in ("train", "train_voxel18")},
             device_launches_per_call=records["sorted_segment_bcast"]["device_launches_per_call"],
             segment_sums={case: summary(rec) for case, rec in records["segment_sums"].items()}),
    ]
    foreign = sorted(
        m for m in sys.modules
        if m.split(".")[0].startswith(("jax", "flax")) or m.split(".")[0] == "pillarnext_tpu"
    )
    if foreign:
        raise AssertionError(f"the port imported JAX or the JAX package: {foreign[:5]}")
    print(smi, flush=True)
    emit({"kernels": kernels_line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
