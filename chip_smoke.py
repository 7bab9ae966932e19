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
- serving_waymo_pp18, serving_waymo_voxel18, serving_mvf: the same for
  the two-task Waymo configs (waymo_det_pp18_aspp_iou_car_sp and
  waymo_det_voxel18_aspp_iou_car at 2048^2 and 40 x 2048^2, and the MVF
  reader of waymo_det_mvf18_aspp_iou_car: pillar and cylinder views with
  dense towers, kernels 2 and 3; its BN statistics set from the first
  frame, ``calibrate_bn``), each frame's tables beside their rows;
  the f32 MVF BEV held bit-identical between the kernels and their plain
  versions, and two bf16 MVF predicts of one frame the same bits;
- train: the port's Trainer, bf16, batch 4 of seeded synthetic scenes
  at the dataloader's 300000-point capacity, five steps (flagship);
- train_voxel18: the same for voxel18 at its config's grid (the fully
  sparse 3-D ResNet's backward, kernel 2's densify and its backward),
  with each table's active count beside its rows, and an f32 step whose
  BEV must be bit-identical between the kernels and their plain versions;
- train_mvf, train_waymo_pp18, train_waymo_voxel18: the same for the
  three Waymo configs at their full grids (MVF: both views' PFN, densify
  and tower, each tower block recomputed in the backward, the readback's
  and the coarse max's backwards); for MVF also an f32 step with the
  kernels against their plain versions and two bf16 steps that must give
  the same bits;
- cli_train, cli_test: the port's CLIs in this process (``cli.train.main``,
  ``cli.test.main``) on a nuScenes-format tree the script writes from its
  seed (8 train and 8 val samples of 10 sweeps, ~300k points a sample, a
  GT database): the flagship as its YAML gives it trains 2 steps, runs the
  epoch's ``val_epoch`` and the scorer, and ``cli.test`` scores the
  checkpoint; step and loader-wait ms, host ms per sample (GT paste
  apart), val ms per batch, repairs and scorer seconds; ``cli.test``'s
  detections must be the bits of ``cli.train``'s;

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
WAYMO_PP18 = REPO / "pillarnext_tpu/configs/experiments/waymo_det_pp18_aspp_iou_car_sp.yaml"
WAYMO_VOXEL18 = REPO / "pillarnext_tpu/configs/experiments/waymo_det_voxel18_aspp_iou_car.yaml"
MVF = REPO / "pillarnext_tpu/configs/experiments/waymo_det_mvf18_aspp_iou_car.yaml"
KERNELS = ("pfn_two_layer", "monotone_row_gather", "sorted_segment_bcast")
N_POINTS = 200_000
TIMED_RUNS = 25
PROFILED_CALLS = 20
PROFILE_WINDOWS = 4
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel, launched between profiled calls
LATENCY_FRAMES = 10
TRAIN_STEPS = 5
CLI_SAMPLES = 8  # train and val samples of the CLIs' nuScenes tree
SWEEPS = 10
SWEEP_POINTS = 30_000
POINTS_PER_SURFACE = 40  # the CLIs' scenes: ~55k occupied pillars a 300k-point frame
DB_CROPS = 24  # GT-database crops per class
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


def check_pfn(reader, points, mask, gen, device, records, case: str = "serving"):
    """Kernel 1 vs its plain version on a pillar reader's decorated points
    of one frame (``case`` names the path)."""
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
            "phase": "kernel_vs_plain", "kernel": "pfn_two_layer", "case": case, "dtype": str(dtype),
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
    records.setdefault("pfn_cases", {})[case] = out["torch.bfloat16"]
    return slot, cap


@contextlib.contextmanager
def captured(module, name: str):
    """Inside the block, every call of the kernel wrapper ``module.name``
    also appends a copy of its tensor arguments to the yielded list."""
    real, calls = getattr(module, name), []

    def capture(*args):
        calls.append(tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args))
        return real(*args)

    # a wrapper counts its launches through its own module's name, which is
    # ``capture`` inside the block when ``module`` is the wrapper's module
    capture.launches = 0
    setattr(module, name, capture)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def train_step_calls(model_cfg, batch, device, *wrappers) -> list:
    """For each ``(module, name)`` of ``wrappers``, the arguments of every
    call of ``module.name`` in one bf16 train step (forward and backward,
    no update) of ``model_cfg`` on ``batch``."""
    from pillarnext_tpu_torch.train.trainer import batch_to_device
    from pillarnext_tpu_torch.utils.builders import build_model

    model = build_model(model_cfg, device=device, generator=torch.Generator().manual_seed(0), train=True)
    with contextlib.ExitStack() as stack:
        calls = [stack.enter_context(captured(module, name)) for module, name in wrappers]
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

    cluster, dens = train_step_calls(cfg["model"], batch, device, (scatter, "monotone_row_gather"),
                                     (densify, "monotone_row_gather"))
    voxel, = train_step_calls(vcfg["model"], vbatch, device, (densify, "monotone_row_gather"))
    return (named(("train_cluster_mean_gather", "train_densify_h8", "train_densify_backward"), cluster + dens,
                  "a flagship train step's kernel 2")
            + named(("train_voxel18_densify", "train_voxel18_densify_backward"), voxel,
                    "a voxel18 train step's kernel 2"))


def segment_sum_inputs(model, points, mask, vmodel, vpoints, vmask, cfg, vcfg, batch, vbatch, device) -> list:
    """(name, x, seg, reduce) of kernel 3's segment sums (ops/scatter.py)
    on the four main paths: the flagship's cluster mean and voxel18's
    voxel mean in a serving frame and in a bf16 train step."""
    from pillarnext_tpu_torch.ops import scatter

    with torch.inference_mode(), captured(scatter, "sorted_segment_bcast") as serving:
        model.reader(points, mask)
        vmodel.reader(vpoints, vmask)
    train, = train_step_calls(cfg["model"], batch, device, (scatter, "sorted_segment_bcast"))
    vtrain, = train_step_calls(vcfg["model"], vbatch, device, (scatter, "sorted_segment_bcast"))
    return named(("serving_cluster_mean", "serving_voxel_mean", "train_cluster_mean", "train_voxel_mean"),
                 serving + train + vtrain, "the segment sums")


def mvf_train_kernel_inputs(cfg, batch, device) -> tuple[list, list]:
    """The kernel inputs new in an MVF train step (bf16, B = 4): (name,
    table, idx) of kernel 2 as the pillar densify's backward (the 2048^2
    map's gradient gathered at the slot ids); (name, x, seg, reduce) of
    kernel 3 as the PFN's max broadcast (the pillar view's), the two sums
    of its backward (the view whose backward runs first) and the pillar
    readback's backward sum."""
    from pillarnext_tpu_torch.ops import densify, scatter, segscan

    b, n = batch["points"].shape[:2]
    pc, vs = cfg["model"]["reader"]["pc_range"], cfg["model"]["reader"]["voxel_size"]
    dense_rows = b * round((pc[3] - pc[0]) / vs[0]) * round((pc[4] - pc[1]) / vs[1])
    dens, bcast, sums = train_step_calls(cfg["model"], batch, device, (densify, "monotone_row_gather"),
                                         (segscan, "sorted_segment_bcast"), (scatter, "sorted_segment_bcast"))
    # the first two calls are the views' densifies, the backwards follow
    gathers = [("train_mvf_pillar_densify_backward", *c) for c in dens[2:] if c[0].shape[0] == dense_rows]
    maxes = [c for c in bcast if c[2] == "max"]
    bsums = [c for c in bcast if c[2] == "sum"]
    # the readbacks' sums have 4 rows a point; the pillar view's ids are the larger
    readback = max((c for c in sums if c[0].shape[0] == 4 * b * n), key=lambda c: int(c[1].max()))
    del dens, sums
    segs = [("train_mvf_max_broadcast", *maxes[0]), ("train_mvf_max_broadcast_grad_sum", *bsums[0]),
            ("train_mvf_max_broadcast_tie_count", *bsums[1]), ("train_mvf_pillar_readback_sum", *readback)]
    return gathers, segs


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
    paths run (ops/scatter.py; beside each, the device time of
    ``torch.segment_reduce``, one call that computes the same sums one row
    per segment) and of the MVF PFN's max broadcast and its backward's sums
    (ops/segscan.py): max bit-exact, sum within 1e-5 of the
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

    def check(case, x, seg, reduce, library=None):
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
            "library_ms": median_ms(library) if library is not None else None,
            **bound(n * c * es * 2 + n * 4, float(n * c), dtype),
            "launch_shape": segscan_launch_shape(dtype, reduce, vector_bytes(x, got)),
            "device_launches_planned": device_launches(n),
        })
        rec.update(device_fields(lambda: sorted_segment_bcast(x, seg, reduce),
                                 lambda: sorted_segment_bcast_plain(x, seg, reduce), library,
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

    def segment_reduce(x, seg):
        """The library call that computes ``scatter.segment_sum`` (one row
        per occupied segment) in one call."""
        lengths = torch.unique_consecutive(seg, return_counts=True)[1]
        return lambda: torch.segment_reduce(x, "sum", lengths=lengths, unsafe=True)

    records["segment_sums"] = {case: check(case, x, seg, reduce, segment_reduce(x, seg))
                               for case, x, seg, reduce in sum_cases if reduce == "sum"}
    records["max_broadcasts"] = {case: check(case, x, seg, reduce)
                                 for case, x, seg, reduce in sum_cases if reduce == "max"}
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


def synced_ms(fn):
    """(fn(), its CUDA-synchronised host time in ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def span_timer(spans: dict):
    """Inside the block, the CUDA-synchronised host time from the start of
    module ``first`` to the end of module ``last`` for each ``name: (first,
    last)`` of ``spans``, summed into the yielded dict (ms)."""
    times, handles = {name: 0.0 for name in spans}, []
    for name, (first, last) in spans.items():
        start = {}

        def pre(*_, name=name, start=start):
            torch.cuda.synchronize()
            start[name] = time.perf_counter()

        def post(*_, name=name, start=start):
            torch.cuda.synchronize()
            times[name] += (time.perf_counter() - start.pop(name)) * 1e3

        handles += [first.register_forward_pre_hook(pre), last.register_forward_hook(post)]
    try:
        yield times
    finally:
        for h in handles:
            h.remove()


def layer_breakdown(model, points, mask, capacity):
    """CUDA-synchronised host time of each layer of one predict (ms); an
    MVF reader also split into its views (each view's dense tower apart)
    and its point-wise MLPs."""
    from pillarnext_tpu_torch.core import nms

    nms_ms = []
    rotated_nms = nms.rotated_nms

    def timed_nms(*args):
        out, ms = synced_ms(lambda: rotated_nms(*args))
        nms_ms.append(ms)
        return out

    cfg = model.post_processing
    if cfg.get("candidate_sparse_head", False):
        def head(x):
            return model.head(x, test_cfg=cfg)
    else:
        def head(x):
            return model.head.predict(model.head(x), cfg)

    reader, spans = model.reader, {}
    if type(reader).__name__ == "MVFFeatureNet":
        for view in ("pillar_view", "cylinder_view"):
            mod = getattr(reader, view)
            spans[view] = (mod, mod)
            spans[f"{view}_tower"] = (mod.blocks[0][0], mod.blocks[-1][-1])
        spans["pointnets"] = (reader.pointnet1, reader.pointnet2)
    tel = {}
    with torch.inference_mode():
        with span_timer(spans) as reader_parts:
            x, reader_ms = synced_ms(lambda: model.reader(points, mask, capacity=capacity, telemetry=tel))
        backbone_ms = None
        if model.backbone is not None:
            x, backbone_ms = synced_ms(lambda: model.backbone(x))
        x, neck_ms = synced_ms(lambda: model.neck(x))
        nms.rotated_nms = timed_nms
        try:
            _, head_ms = synced_ms(lambda: head(x))
        finally:
            nms.rotated_nms = rotated_nms
    out = {"reader": reader_ms, "backbone": backbone_ms, "neck": neck_ms,
           "head_decode_nms": head_ms, "of_which_nms": sum(nms_ms)}
    if spans:
        out["reader_parts"] = reader_parts
    return out


def train_breakdown(model, optimizer, batch, device):
    """CUDA-synchronised host time of each part of one train step (ms)."""
    from pillarnext_tpu_torch.train.trainer import batch_to_device

    timed = synced_ms
    model.train()
    ex, h2d_ms = timed(lambda: batch_to_device(batch, device))
    x, reader_ms = timed(lambda: model.reader(ex["points"], ex["points_mask"]))
    backbone_ms = None
    if model.backbone is not None:
        x, backbone_ms = timed(lambda: model.backbone(x))
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


def calibrate_bn(model, points, mask) -> None:
    """Set the running statistics of every BatchNorm of ``model`` to those
    of its input in one predict of (points, mask), layer by layer (each BN
    normalises with the statistics just set, so the next layer sees what a
    trained model's would), over the valid rows where the layer masks its
    statistics.  MVF's raw features hold phi in degrees and rho in metres:
    with identity statistics, random weights drive its bf16 activations
    through the neck to box sizes whose exp overflows."""
    from pillarnext_tpu_torch.models.layers import BatchNorm

    def set_statistics(bn, args, kwargs):
        x = args[0]
        channel_dim = kwargs.get("channel_dim", args[1] if len(args) > 1 else 1)
        xf = x.float().movedim(channel_dim, -1).reshape(-1, x.shape[channel_dim])
        if kwargs.get("valid") is not None:
            xf = xf[kwargs["valid"].reshape(-1)]
        bn.running_mean.copy_(xf.mean(0))
        bn.running_var.copy_(xf.var(0, unbiased=False))

    handles = [m.register_forward_pre_hook(set_statistics, with_kwargs=True)
               for m in model.modules() if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            model.predict(points, mask)
    finally:
        for h in handles:
            h.remove()


def serving_model(model_cfg, device):
    """A bf16 serving model with random weights from seed 0; an MVF model's
    BN statistics set from the frame of seed 0 (``calibrate_bn``)."""
    from pillarnext_tpu_torch.utils.builders import build_model

    model = build_model(model_cfg, device=device, generator=torch.Generator().manual_seed(0))
    if type(model.reader).__name__ == "MVFFeatureNet":
        calibrate_bn(model, *frame(model_cfg["reader"]["pc_range"], 0, device))
    return model


def kernel_counters():
    """The three kernel wrappers, whose ``launches`` count their launches."""
    from pillarnext_tpu_torch.ops.gather import monotone_row_gather
    from pillarnext_tpu_torch.ops.pfn import pfn_two_layer
    from pillarnext_tpu_torch.ops.segscan import sorted_segment_bcast

    return pfn_two_layer, monotone_row_gather, sorted_segment_bcast


def table_report(model, tel: dict, bucket: int, batch: int = 1) -> dict:
    """Each compact table of a predict or a train step: its active count
    beside its rows.  Pillar reader: the pillar table, and in training each
    strided stage's sites; MVF: the pillar and the cylinder tables;
    voxel18: the reader's voxels and each strided stage's sites."""
    reader = model.reader
    kind = type(reader).__name__
    if kind == "VoxelFeatureNet":
        grid = reader.grid
        spatial = (grid.size_z, grid.size_y, grid.size_x)
        cap = min(bucket * batch, grid.num_voxels * batch)
        caps = {"voxel": cap, **model.backbone.table_capacities(cap, batch, spatial)}
    elif kind == "MVFFeatureNet":
        caps = {"pillar": min(bucket * batch, reader.pillar_grid.num_pillars * batch),
                "cylinder": min(reader.cylinder_capacity * batch, reader.cylinder_grid.num_pillars * batch)}
    else:
        caps = {"pillar": min(bucket * batch, reader.grid.num_pillars * batch)}
        if "stage1_active" in tel:  # the all-sparse training backbone (models/resnet.py)
            spatial = (reader.grid.size_y, reader.grid.size_x)
            caps.update(model.backbone.table_capacities(caps["pillar"], batch, spatial))
    return {name: {"active": int(tel[f"{name}_active"]), "capacity": c,
                   "overflow": int(tel[f"{name}_overflow"])} for name, c in caps.items()}


def serving_path(path: str, model_cfg, model, device, required: tuple):
    """A serving main path, bf16, batch 1, through AdaptivePredictor at the
    config's full grid: per frame the valid count, the bucket it ran at,
    whether it was repaired and each table's active count beside its rows;
    the latency median, a breakdown, peak memory and the launches; fails
    unless every kernel in ``required`` launched."""
    from pillarnext_tpu_torch.serving import AdaptivePredictor

    pc_range = model_cfg["reader"]["pc_range"]
    engine = AdaptivePredictor(model)
    frames = [frame(pc_range, seed, device) for seed in (0, 1, 2)]
    counters = kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in counters:
        k.launches = 0
    engine.warmup(*frames[0])
    per_frame = []
    d = sum(len(t) for t in model_cfg["head"]["tasks"]) * int(model_cfg["post_processing"]["nms"]["nms_post_max_size"])
    for seed, (p, m) in zip((0, 1, 2), frames):
        repaired = engine.repaired
        pending = engine(p, m)
        out = engine.resolve([pending])[0]
        bucket = pending.bucket if engine.repaired == repaired else engine.buckets[-1]
        for key in ("box3d_lidar", "scores", "label_preds", "valid"):
            if tuple(out[key].shape[:2]) != (1, d):
                raise AssertionError(f"{path}: {key} has shape {tuple(out[key].shape)}, expected (1, {d}, ...)")
        if not (torch.isfinite(out["box3d_lidar"]).all() and torch.isfinite(out["scores"]).all()):
            raise AssertionError(f"{path}: non-finite detections for frame seed {seed}")
        tel = {}
        with torch.inference_mode():
            model.predict(p, m, capacity=bucket, telemetry=tel)
        per_frame.append({"seed": seed, "points": int(m.sum()), "valid": int(out["valid"].sum()),
                          "bucket": bucket, "repaired": engine.repaired > repaired,
                          "tables": table_report(model, tel, bucket)})
    latencies = []
    for _ in range(LATENCY_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.predict(*frames[0])
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    launches = {k.__name__: k.launches for k in counters}
    emit({"phase": "main_path", "path": path, "dtype": "bfloat16", "frames": per_frame,
          "buckets": list(engine.buckets), "operating_bucket": engine._operating_bucket(),
          "peak_required": engine.peak_required, "repaired": engine.repaired,
          "latency_ms_median": statistics.median(latencies), "latency_ms": latencies,
          "launches": launches,
          "breakdown_ms": layer_breakdown(model, *frames[0], engine._operating_bucket()),
          "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2**20})
    for name in required:
        if launches[name] == 0:
            raise AssertionError(f"the {path} path never launched {name}")
    return frames, launches


def f32_bev_kernels_vs_plain(phase: str, model_cfg, points, mask, device):
    """The f32 BEV (the reader's output, through the backbone where there is
    one) of one frame with the kernels and with their plain versions: kernel
    2 is an exact copy and kernel 3's sums run the same way on both routes,
    so the BEV must be bit-identical.  The frame's detections, kernel vs
    plain, are reported as a matched fraction and bit identity."""
    from pillarnext_tpu_torch.utils.builders import build_model

    model = build_model(dict(model_cfg, dtype="float32"), device=device,
                        generator=torch.Generator().manual_seed(0))

    def bev(plain):
        x = model.reader(points, mask, plain=plain)
        return x if model.backbone is None else model.backbone(x, plain=plain)

    with torch.inference_mode(), model.precision():
        bev_k, bev_plain = bev(False), bev(True)
        a, b = model.predict(points, mask), model.predict(points, mask, plain=True)
    rec = {"phase": phase, "bev_shape": list(bev_k.shape),
           "bev_bit_identical": torch.equal(bev_k, bev_plain),
           "bev_max_abs_diff": float((bev_k - bev_plain).abs().max()),
           "bev_nonzero_share": float((bev_k != 0).float().mean()),
           "valid": [int(a["valid"][0].sum()), int(b["valid"][0].sum())],
           "matched_fraction": matched_fraction(a, b), "bit_identical": same_prediction(a, b)}
    emit(rec)
    if not rec["bev_bit_identical"]:
        raise AssertionError(f"{phase}: the f32 BEV differs between the kernels and their plain versions: {rec}")


def predict_kernel_inputs(model, points, mask, gathers: tuple, densifies: tuple, sums: tuple):
    """The arguments of kernels 2 and 3 in one bf16 predict, named: (name,
    table, idx) of each row gather in ``ops/scatter.py`` (``gathers``) and
    in ``ops/densify.py`` (``densifies``), in call order, and (name, x,
    seg, reduce) of each segment sum (``sums``)."""
    from pillarnext_tpu_torch.ops import densify, scatter

    with (torch.inference_mode(), captured(scatter, "monotone_row_gather") as g,
          captured(densify, "monotone_row_gather") as d, captured(scatter, "sorted_segment_bcast") as ss):
        model.predict(points, mask)
    return (named(gathers, g, "the predict's row gathers") + named(densifies, d, "the predict's densifies"),
            named(sums, ss, "the predict's segment sums"))


def train_path(cfg, batches, device, work_dir, path: str, required: tuple):
    """A training main path, bf16, B = 4, through the port's Trainer: its
    record carries the step times, losses, the last step's tables (each
    active count beside its rows), peak memory, a breakdown and a 2-step
    device profile; it fails unless every kernel in ``required`` launched
    and every loss is finite (the Trainer raises on an overflowed table)."""
    from pillarnext_tpu_torch.train.trainer import Trainer
    from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer

    model = build_model(cfg["model"], device=device, generator=torch.Generator().manual_seed(0), train=True)
    opt, sched = build_optimizer(cfg, len(batches), list(model.parameters()))
    loader = TimedLoader(batches)
    trainer = Trainer(model, loader, opt, sched, max_epochs=1, log_every_niters=1,
                      work_dir=work_dir, device=device)
    counters = kernel_counters()
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
    cap = getattr(model.reader, "train_pillar_capacity", None) or model.reader.capacity
    rec["tables_last_step"] = table_report(model, tel, cap, batch_size)
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


def bf16_train_repeat(cfg, batch, device, phase: str):
    """Two bf16 train steps from the same weights (a model from seed 0
    each) on the same batch, under PyTorch's default flags: the losses,
    every gradient and every BN statistic after the step must be the same
    bits.  The port adds in one order everywhere (kernel 3's sorted sums,
    integer tie counts, no float atomics)."""
    from pillarnext_tpu_torch.train.train_state import train_step
    from pillarnext_tpu_torch.train.trainer import batch_to_device
    from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer

    ex = batch_to_device(batch, device)

    def step():
        model = build_model(cfg["model"], device=device, generator=torch.Generator().manual_seed(0), train=True)
        opt, _ = build_optimizer(cfg, 10, list(model.parameters()))
        scalars, _ = train_step(model, opt, ex)
        return {"loss": scalars["loss"], **{n: p.grad for n, p in model.named_parameters()},
                **{n: b.clone() for n, b in model.named_buffers()}}

    a, b = step(), step()
    differing = [k for k in a if not torch.equal(a[k], b[k])]
    rec = {"phase": phase, "bit_identical": not differing, "differing": len(differing),
           "first_differing": differing[:5], "compared": len(a), "loss": float(a["loss"])}
    emit(rec)
    if differing:
        raise AssertionError(f"two bf16 train steps differ: {rec}")


def write_nuscenes_tree(root: Path, pc_range, class_names: list, seed: int) -> dict:
    """A nuScenes-format tree (the infos pickle schema of the converter, .bin
    sweeps, a GT database) of ``CLI_SAMPLES`` train and as many val samples.

    Each sample is one synthetic scene of ``SWEEPS x SWEEP_POINTS`` points
    (``utils/synth.synth_detection_scene``: 20-40 GT boxes at class-typical
    sizes over beam-structured ``lidar_like_points`` surfaces of
    ``POINTS_PER_SURFACE`` points, so that the sweeps see the same surfaces
    and a frame occupies ~55k pillars, as real 10-sweep frames occupy
    40-65k of the 1344^2), dealt into a keyframe and ``SWEEPS - 1``
    sweeps; sweep k is written in the frame of an ego ``0.5 k`` m behind
    (and 0.002 k rad turned), with the transform back to the keyframe and
    ``time_lag`` 0.05 k in its info, as a 10-sweep nuScenes frame has
    them.  The GT database holds ``DB_CROPS`` crops of each class."""
    import pickle

    import numpy as np

    from pillarnext_tpu_torch.utils.synth import CLASS_SPECS, synth_detection_scene

    rng = np.random.default_rng(seed)
    (root / "samples").mkdir(parents=True)
    (root / "gtdb").mkdir()

    def sweep_transform(k):
        c, s = math.cos(0.002 * k), math.sin(0.002 * k)
        tm = np.eye(4)
        tm[:2, :2] = [[c, -s], [s, c]]
        tm[0, 3] = -0.5 * k
        return tm

    def split(split_name):
        infos = []
        for i in range(CLI_SAMPLES):
            token = f"{split_name}_{i:02d}"
            pts, boxes, names = synth_detection_scene(rng, SWEEPS * SWEEP_POINTS, pc_range,
                                                      int(rng.integers(20, 41)), class_names,
                                                      points_per_surface=POINTS_PER_SURFACE)
            pts = pts[rng.permutation(len(pts))]
            sweeps = []
            for k, chunk in enumerate(np.array_split(pts, SWEEPS)):
                path = f"samples/{token}_{k}.bin"
                if k:
                    tm = sweep_transform(k)
                    chunk = chunk.copy()
                    chunk[:, :3] = (chunk[:, :3] - tm[:3, 3]) @ tm[:3, :3]  # keyframe -> sweep frame
                    sweeps.append({"lidar_path": path, "transform_matrix": tm, "time_lag": 0.05 * k})
                chunk.astype(np.float32).tofile(root / path)
            car_from_global = np.eye(4)
            car_from_global[:2, 3] = rng.uniform(-500, 500, 2)
            infos.append({"lidar_path": f"samples/{token}_0.bin", "token": token, "sweeps": sweeps,
                          "ref_from_car": np.eye(4), "car_from_global": car_from_global,
                          "timestamp": float(i), "gt_boxes": boxes.astype(np.float64), "gt_names": names})
        with open(root / f"infos_{split_name}.pkl", "wb") as f:
            pickle.dump(infos, f)
        return infos

    train, val = split("train"), split("val")
    db = {}
    for name in class_names:
        (l, w, h), zc, _ = CLASS_SPECS[name]
        db[name] = []
        for j in range(DB_CROPS):
            n = int(rng.integers(20, 200))
            crop = np.zeros((n, 5), np.float32)
            crop[:, :3] = rng.uniform(-0.5, 0.5, (n, 3)) * [l, w, h]
            crop[:, 3] = rng.uniform(0, 255, n)
            path = f"gtdb/{name}_{j}.bin"
            crop.tofile(root / path)
            box = np.array([*rng.uniform(-45, 45, 2), zc, l, w, h, 0.0, 0.0, rng.uniform(-math.pi, math.pi)],
                           np.float32)
            db[name].append({"name": name, "path": path, "box3d_lidar": box, "num_points_in_gt": n})
    with open(root / "dbinfos.pkl", "wb") as f:
        pickle.dump(db, f)
    points = [sum(np.fromfile(root / p, np.float32).size // 5 for p in
                  [info["lidar_path"], *(s["lidar_path"] for s in info["sweeps"])]) for info in train + val]
    return {"samples": {"train": len(train), "val": len(val)}, "points_per_sample": [min(points), max(points)],
            "gt_boxes_per_sample": [min(len(i["gt_names"]) for i in train + val),
                                    max(len(i["gt_names"]) for i in train + val)],
            "db_crops_per_class": DB_CROPS}


def pipeline_host_ms(ds_cfg, max_points: int, batch_size: int) -> dict:
    """Host time of the train pipeline in this process, one sample after
    another (``dataset.get``): ms per sample in all, and the GT paste's
    share apart (the sampler's draw with its collision tests, and the
    deletion of points inside the pasted boxes); then ms per collated
    batch, and the pickling and unpickling a worker's queue does to one
    (its size beside them)."""
    import pickle
    from multiprocessing.reduction import ForkingPickler

    import numpy as np

    from pillarnext_tpu_torch.core import box_ops, native_geometry
    from pillarnext_tpu_torch.data.collate import collate
    from pillarnext_tpu_torch.utils.builders import build_dataset

    ds = build_dataset(ds_cfg)
    native_geometry.library()  # built before the clock starts
    paste = [0.0]

    def timed(fn):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                paste[0] += time.perf_counter() - t0
        return run

    sample_all, points_in_rbbox = ds.sampler.sample_all, box_ops.points_in_rbbox
    ds.sampler.sample_all, box_ops.points_in_rbbox = timed(sample_all), timed(points_in_rbbox)
    try:
        t0 = time.perf_counter()
        samples = [ds.get(i, np.random.RandomState(i)) for i in range(len(ds))]
        total = time.perf_counter() - t0
    finally:
        ds.sampler.sample_all, box_ops.points_in_rbbox = sample_all, points_in_rbbox
    t0 = time.perf_counter()
    batches = [collate(samples[i:i + batch_size], max_points, np.random.default_rng(i))
               for i in range(0, len(samples) - batch_size + 1, batch_size)]
    collate_s = time.perf_counter() - t0
    # what a worker's queue does to a batch on its way to the trainer
    t0 = time.perf_counter()
    payloads = [ForkingPickler.dumps(b) for b in batches]
    pickle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for payload in payloads:
        pickle.loads(payload)
    unpickle_s = time.perf_counter() - t0
    n = max(len(batches), 1)
    return {"samples": len(samples), "ms_per_sample": total / len(samples) * 1e3,
            "gt_paste_ms_per_sample": paste[0] / len(samples) * 1e3,
            "points_per_sample_after_paste": [int(min(len(s["points"]) for s in samples)),
                                              int(max(len(s["points"]) for s in samples))],
            "collate_ms_per_batch": collate_s / n * 1e3, "pickled_mb_per_batch": sum(map(len, payloads)) / n / 2**20,
            "pickle_ms_per_batch": pickle_s / n * 1e3, "unpickle_ms_per_batch": unpickle_s / n * 1e3}


@contextlib.contextmanager
def cli_instruments(counters):
    """Inside the block, every ``Trainer.train_step`` is fenced by CUDA
    synchronisations and timed into ``out["step_ms"]``, and every
    ``Trainer.val_epoch`` records the launch counts at its start and end and
    its result into ``out["val"]``."""
    from pillarnext_tpu_torch.train.trainer import Trainer

    out = {"step_ms": [], "val": []}
    train_step, val_epoch = Trainer.train_step, Trainer.val_epoch

    def timed_step(self, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = train_step(self, batch)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        return result

    def counted_val(self):
        before = {k.__name__: k.launches for k in counters}
        result = val_epoch(self)
        out["val"].append({"before": before, "after": {k.__name__: k.launches for k in counters},
                           "result": result})
        return result

    Trainer.train_step, Trainer.val_epoch = timed_step, counted_val
    try:
        yield out
    finally:
        Trainer.train_step, Trainer.val_epoch = train_step, val_epoch


def cli_paths(device) -> tuple[dict, dict]:
    """The port's CLIs in this process on a nuScenes-format tree written
    here (``write_nuscenes_tree``): ``cli.train`` on the flagship as its
    YAML gives it (1344^2, B = 4, 300000 points, bf16, its GT paste and
    augmentations) for one epoch of 2 steps, with the epoch's ``val_epoch``
    over the 8 val samples and the scorer; then ``cli.test`` of the
    checkpoint.  The overrides only point the config at the tree, train one
    epoch without CBGS and set the workers to ``min(16, cores)``.  Fails
    unless kernels 2 and 3 launched in training, 1 and 2 in ``val_epoch``
    and in ``cli.test``, the scorer wrote one entry per val sample, every
    loss is finite and ``cli.test``'s detections are the bits of
    ``cli.train``'s.  Returns the launches of each CLI run."""
    import os

    import numpy as np

    from pillarnext_tpu_torch.cli import test as cli_test
    from pillarnext_tpu_torch.cli import train as cli_train
    from pillarnext_tpu_torch.utils.config import load_experiment

    cfg = load_experiment(FLAGSHIP)
    class_names = [n for task in cfg["data"]["train_dataset"]["class_names"] for n in task]
    counters = kernel_counters()
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        root, tmp = Path(tmp) / "nuscenes", Path(tmp)
        t0 = time.perf_counter()
        tree = write_nuscenes_tree(root, cfg["model"]["reader"]["pc_range"], class_names, seed=0)
        tree["host_seconds"] = time.perf_counter() - t0
        workers = min(16, os.cpu_count() or 1)
        overrides = [f"data.train_dataset.root_path={root}", "data.train_dataset.info_path=infos_train.pkl",
                     "data.val_dataset.info_path=infos_val.pkl",
                     "data.train_dataset.sampler.dbinfo_path=dbinfos.pkl", "trainer.max_epochs=1",
                     "data.train_dataset.resampling=false", f"dataloader.train.num_workers={workers}",
                     f"dataloader.val.num_workers={workers}"]
        run_cfg = load_experiment(FLAGSHIP, overrides)
        dl = run_cfg["dataloader"]
        host = pipeline_host_ms(run_cfg["data"]["train_dataset"], int(dl["max_points"]),
                                int(dl["train"]["batch_size"]))
        common = ["--config", str(FLAGSHIP), "--device", str(device)]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in counters:
            k.launches = 0
        t0 = time.perf_counter()
        # the CLIs' progress bars go to stderr: stdout holds the JSON lines
        with cli_instruments(counters) as inst, contextlib.redirect_stdout(sys.stderr):
            trained = cli_train.main([*common, "--work-dir", str(tmp / "work"), *overrides])
        train_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in counters}
        val, = inst["val"]
        in_training, in_val = val["before"], {k: val["after"][k] - val["before"][k] for k in val["after"]}
        losses = [float(v) for v in trained.epoch_losses]
        results = json.loads((tmp / "work/results/epoch_1/results_nusc.json").read_text())["results"]
        timing = trained.val_timing
        rec = {"phase": "main_path", "path": "cli_train", "dtype": run_cfg["model"].get("dtype", "bfloat16"),
               "data": tree, "num_workers": workers, "batch_size": int(dl["train"]["batch_size"]),
               "max_points": int(dl["max_points"]), "steps": len(inst["step_ms"]), "step_ms": inst["step_ms"],
               "loader_wait_ms": [w * 1e3 for w in trained.loader_wait_s],
               "loader_start_ms": trained.train_dataloader.start_s * 1e3,
               "loader_batch_ms_in_worker": [t * 1e3 for t in trained.train_dataloader.load_s], "losses": losses,
               "host_pipeline": host, "val_batches": len(timing["batch_s"]),
               "val_ms_per_batch": [b * 1e3 for b in timing["batch_s"]],
               "val_loader_wait_ms": [w * 1e3 for w in timing["loader_wait_s"]],
               "val_loader_start_ms": trained.val_dataloader.start_s * 1e3,
               "val_loader_batch_ms_in_worker": [t * 1e3 for t in trained.val_dataloader.load_s],
               "eval_repairs": trained.eval_repairs, "scorer_seconds": timing["scorer_s"],
               "results_nusc_entries": len(results), "mean_ap": val["result"]["mean_ap"],
               "nd_score": val["result"]["nd_score"], "cli_seconds": train_s,
               "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2**20,
               "launches": launches, "launches_in_training": in_training, "launches_in_val_epoch": in_val}
        emit(rec)
        failures = []
        if len(losses) != 2 or not all(math.isfinite(v) for v in losses):
            failures.append(f"losses {losses}")
        failures += [f"{name} never launched in training" for name in KERNELS[1:] if not in_training[name]]
        failures += [f"{name} never launched in val_epoch" for name in KERNELS[:2] if not in_val[name]]
        if len(results) != CLI_SAMPLES:
            failures.append(f"results_nusc.json holds {len(results)} entries, expected {CLI_SAMPLES}")
        if not (math.isfinite(rec["mean_ap"]) and math.isfinite(rec["nd_score"])):
            failures.append("mean_ap / nd_score not finite")
        if not all(np.isfinite(d[k]).all() and d["box3d_lidar"].shape == (len(d["scores"]), 9)
                   for d in trained.last_detections.values() for k in ("box3d_lidar", "scores")):
            failures.append("detections not finite or not (D, 9) boxes")
        if failures:
            raise AssertionError(f"cli_train: {failures}")

        for k in counters:
            k.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            tested = cli_test.main([*common, "--checkpoint", str(tmp / "work/checkpoints/epoch_1.pt"),
                                    "--work-dir", str(tmp / "work_test"), *overrides])
        test_s = time.perf_counter() - t0
        test_launches = {k.__name__: k.launches for k in counters}
        ref, got = trained.last_detections, tested.last_detections
        differing = sorted(t for t in ref if t not in got or any(
            not np.array_equal(ref[t][k], got[t][k]) for k in ref[t]))
        timing = tested.val_timing
        emit({"phase": "main_path", "path": "cli_test", "cli_seconds": test_s,
              "val_batches": len(timing["batch_s"]), "val_ms_per_batch": [b * 1e3 for b in timing["batch_s"]],
              "val_loader_wait_ms": [w * 1e3 for w in timing["loader_wait_s"]],
              "val_loader_start_ms": tested.val_dataloader.start_s * 1e3,
              "val_loader_batch_ms_in_worker": [t * 1e3 for t in tested.val_dataloader.load_s],
              "eval_repairs": tested.eval_repairs, "scorer_seconds": timing["scorer_s"],
              "detections": sum(len(d["scores"]) for d in got.values()),
              "detections_bit_identical_to_cli_train": not differing and got.keys() == ref.keys(),
              "differing_tokens": differing, "launches": test_launches})
        failures = [f"{name} never launched" for name in KERNELS[:2] if not test_launches[name]]
        if differing or got.keys() != ref.keys():
            failures.append(f"detections differ from cli_train's for {differing or 'the token set'}")
        if failures:
            raise AssertionError(f"cli_test: {failures}")
        del trained, tested
    torch.cuda.empty_cache()
    return launches, test_launches


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
    frames, serve_launches = serving_path("serving", cfg["model"], model, device, KERNELS)

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
    vmodel = build_model(vcfg["model"], device=device, generator=torch.Generator().manual_seed(0))
    vframes, voxel_launches = serving_path("serving_voxel18", vcfg["model"], vmodel, device, KERNELS[1:])
    voxel_cases, _ = predict_kernel_inputs(vmodel, *vframes[0], (), ("voxel18_densify",), ("voxel_mean",))
    del vmodel
    torch.cuda.empty_cache()
    f32_bev_kernels_vs_plain("voxel18_f32_kernels_vs_plain", vcfg["model"], *vframes[0], device)
    del vframes
    torch.cuda.empty_cache()

    # phase 5b: the Waymo serving paths, bf16, batch 1, 200k points, at the
    # configs' full grids: pp18 (2048^2 pillars), voxel18 (40 x 2048^2
    # voxels) and MVF (2048^2 pillars, 100 x 2560 cylinder cells, dense
    # view towers); the MVF f32 BEV with the kernels and with their plain
    # versions, and two bf16 MVF predicts of one frame; each path's kernel
    # inputs for the kernel phase
    waymo = {}
    for path, config, required, names in (
        ("serving_waymo_pp18", WAYMO_PP18, KERNELS,
         (("waymo_pp18_cluster_mean_gather",), ("waymo_pp18_densify",), ("waymo_pp18_cluster_mean",))),
        ("serving_waymo_voxel18", WAYMO_VOXEL18, KERNELS[1:],
         ((), ("waymo_voxel18_densify",), ("waymo_voxel18_voxel_mean",))),
        ("serving_mvf", MVF, KERNELS[1:],
         (("mvf_pillar_cluster_mean_gather", "mvf_cylinder_cluster_mean_gather", "mvf_pillar_pfn_back_gather",
           "mvf_cylinder_pfn_back_gather"), ("mvf_pillar_densify", "mvf_cylinder_densify"),
          ("mvf_pillar_decoration_mean", "mvf_cylinder_decoration_mean"))),
    ):
        wcfg = load_experiment(config)
        wmodel = serving_model(wcfg["model"], device)
        wframes, launches = serving_path(path, wcfg["model"], wmodel, device, required)
        gathers, sums = predict_kernel_inputs(wmodel, *wframes[0], *names)
        waymo[path] = {"cfg": wcfg, "launches": launches, "gathers": gathers, "sums": sums}
        if path == "serving_mvf":
            with torch.inference_mode():
                a, b = wmodel.predict(*wframes[0]), wmodel.predict(*wframes[0])
            emit({"phase": "mvf_bf16_repeat", "valid": [int(a["valid"][0].sum()), int(b["valid"][0].sum())],
                  "matched_fraction": matched_fraction(a, b), "bit_identical": same_prediction(a, b)})
            if not same_prediction(a, b):
                raise AssertionError("two bf16 MVF predicts of one frame differ")
            del a, b
            f32_bev_kernels_vs_plain("mvf_f32_kernels_vs_plain", wcfg["model"], *wframes[0], device)
        del wmodel, wframes
        torch.cuda.empty_cache()

    # phase 6: the training main path, bf16, B = 4, through the Trainer
    # (its checkpoint goes to a directory of the checkout that is removed)
    with tempfile.TemporaryDirectory(dir=REPO) as work_dir:
        train_model, train_launches = train_path(cfg, batches, device, work_dir, "train",
                                                 KERNELS[1:])
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
                                                  KERNELS[1:])
    del train_model
    torch.cuda.empty_cache()
    f32_train_kernels_vs_plain(vcfg, vbatches[0], device, "voxel18_f32_train_kernels_vs_plain")
    torch.cuda.empty_cache()

    # phase 8b: training of the three Waymo configs, bf16, B = 4 at the
    # configs' full grids, through the Trainer: MVF (2048^2 pillar view,
    # 100 x 2560 cylinder view, tower blocks recomputed in the backward),
    # then an MVF f32 step with the kernels and with their plain versions
    # and two bf16 MVF steps that must be the same bits; pp18 (2048^2 at
    # train_pillar_capacity) and voxel18 (40 x 2048^2); then the kernel
    # inputs these steps add, for the kernel phase (captured after the
    # three paths, so that no path's peak memory holds them)
    from pillarnext_tpu_torch.ops import densify

    wtrain, first_batch = {}, {}
    for path, serving in (("train_mvf", "serving_mvf"), ("train_waymo_pp18", "serving_waymo_pp18"),
                          ("train_waymo_voxel18", "serving_waymo_voxel18")):
        wcfg = waymo[serving]["cfg"]
        t0 = time.perf_counter()
        wbatches = synthetic_batches(wcfg, TRAIN_STEPS, batch_size, N_POINTS, seed=0)
        emit({"phase": "train_data", "config": path, "batches": len(wbatches), "batch_size": batch_size,
              "points_per_scene": N_POINTS, "max_points": int(wcfg["dataloader"]["max_points"]),
              "host_seconds": time.perf_counter() - t0})
        with tempfile.TemporaryDirectory(dir=REPO) as work_dir:
            train_model, wtrain[path] = train_path(wcfg, wbatches, device, work_dir, path, KERNELS[1:])
        del train_model
        torch.cuda.empty_cache()
        if path == "train_mvf":
            f32_train_kernels_vs_plain(wcfg, wbatches[0], device, "mvf_f32_train_kernels_vs_plain")
            torch.cuda.empty_cache()
            bf16_train_repeat(wcfg, wbatches[0], device, "mvf_bf16_train_repeat")
        first_batch[path] = wbatches[0]
        del wbatches
        torch.cuda.empty_cache()
    waymo_gathers, waymo_segs = mvf_train_kernel_inputs(waymo["serving_mvf"]["cfg"], first_batch["train_mvf"],
                                                        device)
    pp18, = train_step_calls(waymo["serving_waymo_pp18"]["cfg"]["model"], first_batch["train_waymo_pp18"], device,
                             (densify, "monotone_row_gather"))
    waymo_gathers += named(("train_waymo_pp18_densify_h8", "train_waymo_pp18_densify_backward"), pp18,
                           "a Waymo pp18 train step's densify")
    del first_batch, pp18
    torch.cuda.empty_cache()

    # phase 8c: the CLIs, cli.train (2 steps, val_epoch, scorer) then
    # cli.test, on a nuScenes-format tree of 300k-point 10-sweep frames
    cli_train_launches, cli_test_launches = cli_paths(device)

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
    for w in waymo.values():
        train_cases += w.pop("gathers")
        sum_cases += w.pop("sums")
    train_cases += waymo_gathers
    sum_cases += waymo_segs
    del waymo_gathers, waymo_segs
    torch.cuda.empty_cache()
    with torch.inference_mode():
        slot, cap = check_pfn(model.reader, points, mask, gen, device, records)
        wpcfg = waymo["serving_waymo_pp18"]["cfg"]["model"]
        wpmodel = build_model(wpcfg, device=device, generator=torch.Generator().manual_seed(0))
        check_pfn(wpmodel.reader, *frame(wpcfg["reader"]["pc_range"], 0, device), gen, device, records,
                  "serving_waymo_pp18")
        del wpmodel
        check_gather(model.reader, points, mask, slot, cap, gen, device, records,
                     train_cases + voxel_cases)
        del train_cases, voxel_cases
        pts = torch.from_numpy(batches[0]["points"]).to(device)
        pmask = torch.from_numpy(batches[0]["points_mask"]).to(device)
        train_cap = int(cfg["model"]["reader"]["train_pillar_capacity"])
        train_slot = model.reader.decorate(pts, pmask, train_cap)[1]
        check_segscan(train_slot, gen, device, records, sum_cases)
        del pts, pmask, train_slot, sum_cases
    torch.cuda.empty_cache()

    # phase 10: where a serving frame's time goes on the device, for every
    # serving path at the reader's largest bucket (profiled last, as above)
    profiled = [("serving", model, (points, mask)), ("serving_voxel18", vmodel, (vpoints, vmask))]
    profiled += [(path, serving_model(w["cfg"]["model"], device), frame(w["cfg"]["model"]["reader"]["pc_range"], 0, device))
                 for path, w in waymo.items()]
    with torch.inference_mode():
        for path, mdl, (p, m) in profiled:
            mdl.predict(p, m)

            def reader_and_backbone(mdl=mdl, p=p, m=m):
                x = mdl.reader(p, m)
                return x if mdl.backbone is None else mdl.backbone(x)

            emit({"phase": "frame_profile", "path": path,
                  "predict": profile_device(lambda: mdl.predict(p, m), 3),
                  "reader_and_backbone": profile_device(reader_and_backbone, 3)})
    del profiled, vmodel, vpoints, vmask

    summary_keys = ("shape", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "device_ms", "device_plain_ms", "device_library_ms")

    def summary(rec):
        return {k: rec[k] for k in summary_keys}

    def line(name, rec, route, source, replaces, launches_by_path, **extra):
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": sum(launches_by_path.values()), "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "device_ms": rec["device_ms"], "device_library_ms": rec["device_library_ms"],
                "launches_by_path": launches_by_path, **extra}

    paths = {"serving": serve_launches, "serving_voxel18": voxel_launches,
             **{path: w["launches"] for path, w in waymo.items()},
             "train": train_launches, "train_voxel18": vtrain_launches, **wtrain,
             "cli_train": cli_train_launches, "cli_test": cli_test_launches}
    by_path = {k: {p: n[k] for p, n in paths.items()} for k in KERNELS}
    cases = records["gather_cases"]
    kernels_line = [
        line("pfn_two_layer", records["pfn_cases"]["serving"], "cuda", "pillarnext_tpu_torch/csrc/pfn.cu",
             "pillarnext_tpu/ops/pallas_pfn.py:93", by_path["pfn_two_layer"],
             cases={case: summary(rec) for case, rec in records["pfn_cases"].items()}),
        line("monotone_row_gather", records["monotone_row_gather"], "cuda", "pillarnext_tpu_torch/csrc/gather.cu",
             "pillarnext_tpu/ops/pallas_gather.py:60", by_path["monotone_row_gather"],
             cases={case: summary(rec) for case, rec in cases.items()}),
        line("sorted_segment_bcast", records["sorted_segment_bcast"], "cuda", "pillarnext_tpu_torch/csrc/segscan.cu",
             "pillarnext_tpu/ops/pallas_segscan.py:124", by_path["sorted_segment_bcast"],
             launches_per_train_step={p: by_path["sorted_segment_bcast"][p] / TRAIN_STEPS
                                      for p in ("train", "train_voxel18", *wtrain)},
             device_launches_per_call=records["sorted_segment_bcast"]["device_launches_per_call"],
             segment_sums={case: summary(rec) for case, rec in records["segment_sums"].items()},
             max_broadcasts={case: summary(rec) for case, rec in records["max_broadcasts"].items()}),
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
