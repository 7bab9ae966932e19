#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

(``chip_smoke.py ddp-worker DIR`` and ``cli-ddp-worker DIR ARGV...`` are
its own ranks.)  Builds the port's CUDA kernels from ``pillarnext_tpu_torch/csrc`` (one
``nvcc`` per source, all at once), drives the port's main paths at full
width, random weights from a seed:

- serving: frames through the port's AdaptivePredictor, bf16, batch 1, of
  the flagship PillarNeXt-B config (nusc_det_pp18_aspp_iou_sp), whose
  head runs the fused eval branches (``fuse_eval``, as in JAX);
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
  seed (8 train and 8 val samples of 10 sweeps, ~300k points a sample,
  under the infos names the YAML reads) with the GT database that the
  port's ``create_groundtruth_database`` cuts from the train split's own
  boxes: the flagship as its YAML gives it trains 2 steps, runs the
  epoch's ``val_epoch`` and the scorer, and ``cli.test`` scores the
  checkpoint; step and loader-wait ms, host ms per sample (GT paste
  apart), val ms per batch, repairs and scorer seconds; ``cli.test``'s
  detections must be the bits of ``cli.train``'s;
- cli_train_ddp: ``cli.train`` under torchrun on 2 ranks over gloo on the
  one card, one epoch with its evaluation on the same tree: each rank
  takes half the steps, one checkpoint, rank 0 scores every val token
  once;
- cli_waymo, cli_waymo_test: the same CLIs on a Waymo tree in the
  converter's schema (8 train and 8 val frames of 200k points, ~3% of
  each flagged as no-label zone, up to 4 prior frames as sweeps) with its
  GT database by the same tool: waymo_det_pp18_aspp_iou_car_sp as its
  YAML gives it (2048^2, B = 4, 3 sweeps) trains 2 steps, runs
  ``val_epoch`` and the Waymo export, and ``cli.test`` scores the
  checkpoint; the loaded batch must hold no flagged point, the export one
  entry per val frame, and ``cli.test``'s detections the bits of
  ``cli.train``'s;
- ddp_train: the port's data-parallel step (``parallel``: synced
  BatchNorm, global loss normalisers, one gradient all-reduce) on 2 ranks
  over gloo sharing the card, in processes of their own: an f32 step of
  the flagship at B = 2 a rank held against the 1-process B = 4 step with
  JAX's multi-device bars, then 3 timed bf16 steps a rank (step ms, the
  all-reduce's bytes and ms, peak memory a rank, launches);
- ddp_nccl: one rank over NCCL, three bf16 steps through the same code;
- serving_tile, serving_leading_down, serving_all, serving_packed,
  serving_dense_first, serving_unmasked, serving_dense_image: the
  flagship's other backbone stage modes (models/resnet.py), one override
  of its YAML each (``SERVING_MODES``), served like the serving path
  (``MODE_LATENCY_FRAMES`` latency frames, as the option paths; their
  device profiles, and those of the mode and option train paths, trace the
  card alone): the
  tile stack (the tile capacity following the bucket, the full tile grid
  at the largest), the sparse first strided stage, the all-sparse
  backbone, the packed densify and 2x2 down conv, the dense-first and
  the unmasked tails, and the dense-image strides [2, 2, 2, 1]; the five
  exact on the active set hold their f32 backbone output against the
  leading path's within 1e-3, the other two their f32 BEV bit-identical
  between the kernels and their plain versions, and each reports its bf16
  detections' matched fraction against leading's;
- train_tile_stride1, train_tile, train_leading, train_leading_down,
  train_force_dense, train_dense_image: the same in training
  (``TRAIN_MODES``), B = 4, ``MODE_TRAIN_STEPS`` steps through the
  Trainer, each table and tile map beside its rows; an f32
  ``tile_stride1`` step's BEV bit-identical between the kernels and their
  plain versions;

- serving_head_unfused, serving_merge_branches, serving_merge_tasks,
  serving_pfn_unfused, serving_pfn3, serving_circle_nms,
  serving_approx_topk: the flagship with one option of its head, reader or
  post-processing each (``OPTION_PATHS``), served like the serving path;
  those that compute the default path's function hold their f32
  detections against its, and the 3-layer PFN's f32 BEV is held
  bit-identical between the kernels and their plain versions;
- train_merge_tasks, train_merge_branches: the merged heads in training,
  B = 4, ``MODE_TRAIN_STEPS`` steps through the Trainer;
- voxel_dense: voxel18 with the dense (1, 40, 1344, 1344, 5) volume
  (``model.reader.output=dense``) and the dense 3-D backbone (cuDNN 3-D
  convs), served like the serving path with ``VOXEL_DENSE_FRAMES``
  latency frames; its f32 BEV bit-identical between the kernels and
  their plain versions; train_voxel_dense: the same model trained,
  B = 2, on a 40 x 672 x 672 grid, ``VOXEL_DENSE_TRAIN_STEPS`` steps;
- every train path recomputes in the backward what JAX remats: each
  sparse and strided block keeping its sparse convs' outputs
  (``remat_save_conv_out``, the default), each tile block and the ASPP
  neck keeping their inputs; train_no_save_conv_out: the flagship with
  JAX's other policy, B = 4; train_waymo_voxel18_b8: Waymo voxel18 at
  B = ``LARGE_BATCH``; recompute_block_check: one full-width SubM
  residual block of the flagship and one of voxel18, on the tables of a
  train step, run bare and recomputed under both policies (output, input
  gradient and parameter gradients: bitwise or their largest
  difference; the outputs must be the same bits);
- reference_checkpoint: ``cli.train``'s weights written in the
  reference's checkpoint layout (``state_dict``, ``module.``, spconv's
  (O, kH, kW, I) sparse kernels, ``num_batches_tracked``), imported by
  ``cli.import_checkpoint``: the same tensors, ``cli.test``'s detections
  the bits of ``cli.train``'s, one served frame the bits of the source
  model's;
- overfit_flagship: ``tools.overfit_sanity`` on the flagship at its
  1344^2 grid, ``OVERFIT_STEPS`` steps on JAX's planted scene, which
  must meet JAX's bar (the loss halves, 8 of 10 objects within 2 m);
- parity_flagship, parity_flagship_trained, parity_voxel18_trained,
  parity_mvf_trained (``PARITY_PHASES``): the port's f32 detections,
  served by AdaptivePredictor, held against its copy of the reference
  mirror (``tools/reference_mirror*.py``, in full f32 on the card) on the
  same frame with the same weights at the configs' grids: the flagship
  with the mirror's random weights (200k points; JAX's bar: 85% matched,
  box delta under 0.5, score delta under 2e-3), then the flagship,
  voxel18 and MVF each overfitted ``PARITY_STEPS`` bf16 steps on a
  planted scene of 24 objects (200k points; exact set equality, more than
  0 detections, box 1e-2 and score 1e-3 for the flagship, 5e-2 and 5e-3
  for the 3-D families); each prints both sides' counts, the
  matched and same-label fractions, the largest deltas, the mirror's,
  the port's and the overfit's seconds and its launches.  voxel18's and
  MVF's trained phases (``PARITY_PROCESSES``) each run in a process of
  their own on the card (``parity-worker``), started before
  overfit_flagship: the overfits are host-bound, so the processes share
  the card and the host's cores (their seconds are those of a shared
  card); each writes its line and launches, which the script prints;
- eval_breakdown, train_breakdown, baseline_probe, loader_bench
  (``tool_paths``): the port's measurement tools (``pillarnext_tpu_torch/
  tools/``) at full width: the flagship's eval pipeline cut into eight
  cumulative prefixes of the served model (masked, B = 1: median ms,
  device ms and launches each); its train step by truncated models
  (B = 4: forward and backward ms apart, device ms of each, peak
  memory; with a ``remat_save_conv_out=false`` row); the reference mirror
  against the port's f32 predict on the card, which must first pass the
  random-weight bar; the host loader's frames/s at 0-8 workers beside what
  the train path's step consumes;
- dist_train_waymo: the multi-host Waymo launcher
  (``pillarnext_tpu_torch/tools/dist_train_waymo.sh``, torchrun) on one
  node with one rank over NCCL, one epoch on ``cli_waymo``'s tree with its
  evaluation; the rank's launches and loaded modules come back through a
  ``sitecustomize`` on its path (``child_probe``);

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
just after (in each rank's process for the multi-process paths, summed
over the ranks), and fails unless every kernel of that path launched.
Every process the script starts is killed at ``DDP_TIMEOUT_S`` (a hung
collective fails the run).  Every
phase prints one JSON line with its ``seconds``; before the last line come
the ``phase_seconds`` line, the card's name and power limit and the
``kernels`` line; the last line is ``{"ok": true,
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
LATENCY_FRAMES = 10
MODE_LATENCY_FRAMES = 3  # the stage-mode and option serving paths (cut to keep the script inside its limit)
# torch.profiler's processing of a window, not its calls, takes most of a
# profiled phase's seconds: one call or step a window keeps the script
# inside its time limit
FRAME_PROFILE_CALLS = 1  # each path's profiled predicts (and reader + backbone calls) at the end
TRAIN_PROFILE_STEPS = 1  # each train path's profiled steps
TRAIN_STEPS = 5
CLI_SAMPLES = 8  # train and val samples of the CLIs' nuScenes tree
DDP_BF16_STEPS = 3
DDP_TIMEOUT_S = 300  # each rank's process group and each multi-process phase
SWEEPS = 10
SWEEP_POINTS = 30_000
WAYMO_FRAMES = 8  # train and val frames of the CLIs' Waymo tree
NLZ_WEDGE_RAD = 0.2  # azimuth wedge of a Waymo frame flagged as a no-label zone
NLZ_INTENSITY = -1.0  # the flagged points' intensity: no unflagged point has it (tanh of 0..255 / 128)
POINTS_PER_SURFACE = 40  # the CLIs' scenes: ~55k occupied pillars a 300k-point frame
# the flagship's backbone stage modes (models/resnet.py), one override of
# its YAML each: served, and trained
SERVING_MODES = {
    "serving_tile": "+model.backbone.sparse_stages_eval=tile",
    "serving_leading_down": "+model.backbone.sparse_stages_eval=leading+down",
    "serving_all": "+model.backbone.sparse_stages_eval=all",
    "serving_packed": "+model.backbone.packed_downsample=true",
    "serving_dense_first": "+model.backbone.sparse_eval=false",
    "serving_unmasked": "model.backbone.masked_eval=false",
    "serving_dense_image": "model.backbone.ds_layer_strides=[2,2,2,1]",
}
# exact on the active set: their f32 backbone output is held against leading's
EXACT_MODES = ("serving_tile", "serving_leading_down", "serving_all", "serving_packed", "serving_dense_first")
TRAIN_MODES = {
    "train_tile_stride1": "+model.backbone.tile_stride1=true",
    "train_tile": "+model.backbone.sparse_stages_train=tile",
    "train_leading": "+model.backbone.sparse_stages_train=leading",
    "train_leading_down": "+model.backbone.sparse_stages_train=leading+down",
    "train_force_dense": "+model.backbone.force_dense_train=true",
    "train_dense_image": "model.backbone.ds_layer_strides=[2,2,2,1]",
}
MODE_TRAIN_STEPS = 3  # the first step, then 2 timed
# the flagship with one option of its head, reader or post-processing each,
# served beside the default path (which runs the fused eval head)
OPTION_PATHS = {
    "serving_head_unfused": "+model.head.fuse_eval=false",
    "serving_merge_branches": "+model.head.merge_branches=true",
    "serving_merge_tasks": "+model.head.merge_tasks=true",
    "serving_pfn_unfused": "+model.reader.fuse_eval=false",
    "serving_pfn3": "model.reader.num_filters=[64,64,64]",
    "serving_circle_nms": "model.post_processing.nms_type=circle",
    "serving_approx_topk": "model.post_processing.approx_topk=true",
}
# these compute the default path's function: their f32 detections are held against its
SAME_FUNCTION = ("serving_head_unfused", "serving_merge_branches", "serving_merge_tasks",
                 "serving_pfn_unfused", "serving_approx_topk")
MIN_MATCHED = 0.99  # of the f32 detections, against the default path's
OPTION_TRAIN = {
    "train_merge_tasks": "+model.head.merge_tasks=true",
    "train_merge_branches": "+model.head.merge_branches=true",
    # JAX's other remat policy: each sparse block keeps only its input
    "train_no_save_conv_out": "+model.backbone.remat_save_conv_out=false",
}
LARGE_BATCH = 8  # train_waymo_voxel18_b8: what the recompute's memory buys
OVERFIT_STEPS = 300  # overfit_flagship: JAX's default (tools/overfit_sanity.py)
# the port's f32 detections against its copy of the reference mirror at the
# configs' grids (pillarnext_tpu_torch/tools/*_parity.py); what each prints
PARITY_PHASES = ("parity_flagship", "parity_flagship_trained", "parity_voxel18_trained", "parity_mvf_trained")
PARITY_FIELDS = ("detections", "matched", "same_label", "max_box_delta", "max_score_delta", "mirror_seconds",
                 "port_seconds", "overfit_seconds", "launches")
LAUNCHER = REPO / "pillarnext_tpu_torch/tools/dist_train_waymo.sh"
BREAKDOWN_REPS = 20  # eval_breakdown: synchronised calls a prefix (JAX's tool)
BREAKDOWN_STEPS = 5  # train_breakdown: timed steps a row after a warm-up (JAX's tool)
LOADER_WORKERS = (0, 2, 4, 8)  # loader_bench
LOADER_TRIPS = 4  # loader_bench: timed batches from each worker (a tree of 160 samples at 8 workers)
PROBE_RUNS = 3  # baseline_probe: runs a side
PARITY_STEPS = 300  # voxel18's and MVF's overfits (the BN statistics need ~300, tools/voxel_parity.py:22-27)
PARITY_PROCESSES = ("parity_voxel18_trained", "parity_mvf_trained")  # each beside the flagship's overfits
PARITY_TIMEOUT_S = 900  # each parity process
# voxel18 with the dense (B, D, H, W, C) volume and the dense 3-D backbone:
# served at the config's 40 x 1344 x 1344 grid, trained on a 40 x 672 x 672 one
VOXEL_DENSE = "+model.reader.output=dense"
VOXEL_DENSE_FRAMES = 3
VOXEL_DENSE_TRAIN = [VOXEL_DENSE, "model.reader.pc_range=[-25.2,-25.2,-5.0,25.2,25.2,3.0]"]
VOXEL_DENSE_TRAIN_STEPS = 3
VOXEL_DENSE_TRAIN_BATCH = 2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 non-tensor


STARTED = time.perf_counter()
PHASE_SECONDS: dict = {}  # each phase's seconds, summed over its records (the ``phase_seconds`` line)
RECORDS: dict = {}  # the last record of each phase
_LAST_RECORD = [STARTED]


def phase_key(record: dict) -> str:
    """A phase record's name: a main path's path, else its phase (and path)."""
    if record["phase"] == "main_path":
        return record["path"]
    return record["phase"] + (f"/{record['path']}" if "path" in record else "")


def emit(record: dict) -> None:
    """One JSON line; a phase record also carries ``seconds``, the wall
    time since the phase record before it (the phase's own), and
    ``script_seconds``, the script's wall time when it was written."""
    if "phase" in record:
        now = time.perf_counter()
        key = phase_key(record)
        record = {**record, "seconds": now - _LAST_RECORD[0], "script_seconds": now - STARTED}
        _LAST_RECORD[0] = now
        PHASE_SECONDS[key] = PHASE_SECONDS.get(key, 0.0) + record["seconds"]
        RECORDS[key] = record
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


def device_profile(fn, calls: int = PROFILED_CALLS, launches: int | None = None) -> dict:
    """``utils/profiling.device_profile``: the device time of one call
    over the whole calls of a window of ``calls``."""
    from pillarnext_tpu_torch.utils import profiling

    return profiling.device_profile(fn, calls, launches)


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
        # the point gathers read the (cap + 1)-row table, its dump row too
        ("pfn_back_gather", random_table(cap + 1, 32, torch.bfloat16), slot),
        ("cluster_mean_gather", random_table(cap + 1, 3, torch.float32), slot),
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


def layer_breakdown(model, points, mask, capacity, max_bucket=None):
    """CUDA-synchronised host time of each layer of one predict (ms) at the
    bucket ``capacity`` (the largest bucket ``max_bucket``); an MVF reader
    also split into its views (each view's dense tower apart) and its
    point-wise MLPs."""
    from pillarnext_tpu_torch.core import nms
    from pillarnext_tpu_torch.serving import tile_kwargs

    nms_ms = []
    real_nms = {name: getattr(nms, name) for name in ("rotated_nms", "circle_nms")}

    def timed(name):
        def timed_nms(*args):
            out, ms = synced_ms(lambda: real_nms[name](*args))
            nms_ms.append(ms)
            return out
        return timed_nms

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
            tiles = tile_kwargs(model, capacity, capacity if max_bucket is None else max_bucket)
            x, backbone_ms = synced_ms(lambda: model.backbone(x, **tiles))
        x, neck_ms = synced_ms(lambda: model.neck(x))
        for name in real_nms:
            setattr(nms, name, timed(name))
        try:
            _, head_ms = synced_ms(lambda: head(x))
        finally:
            for name, fn in real_nms.items():
                setattr(nms, name, fn)
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


def profile_train_steps(model, optimizer, batches, device, steps: int = TRAIN_PROFILE_STEPS, ops: bool = True) -> dict:
    """``profile_device`` of ``steps`` train steps."""
    from pillarnext_tpu_torch.train.train_state import train_step
    from pillarnext_tpu_torch.train.trainer import batch_to_device

    it = iter(batches[:steps])
    return profile_device(lambda: train_step(model, optimizer, batch_to_device(next(it), device)), steps, ops)


def profile_device(run, steps: int, ops: bool = True) -> dict:
    """Device time of ``steps`` calls of ``run`` (a train step, a frame)
    under torch.profiler: the card's busy share of the wall time, kernel
    launches, and the kernels and the PyTorch ops whose kernels took the
    most device time.  Without ``ops`` only the card's activity is traced
    (most of a profile's processing is its host ops): no top ops (null),
    and the host runs untraced, so the wall time and idle share are those
    of the calls alone."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if ops else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
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
    top_ops = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:10] if ops else None
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "launches_per_step": len(kernels) / steps,
            "top_kernels_ms_per_step": [
                {"name": k[:90], "ms": t / steps, "launches": n / steps} for k, (t, n) in top
            ],
            "top_ops_ms_per_step": None if top_ops is None else [
                {"op": e.key[:60], "ms": e.self_device_time_total / 1e3 / steps, "calls": e.count / steps}
                for e in top_ops if e.self_device_time_total > 0
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
    from pillarnext_tpu_torch.utils.profiling import kernel_wrappers

    return kernel_wrappers()


def table_report(model, tel: dict, bucket: int, batch: int = 1, tiles: int | None = None) -> dict:
    """Each compact table of a predict or a train step: its active count
    beside its rows.  Pillar reader: the pillar table, each strided stage's
    sites where the mode has their table, and each tile map's active tiles
    beside its slots (``tiles``: the tile capacity the call ran at, the
    backbone's own by default); MVF: the pillar and the cylinder tables;
    voxel18: the reader's voxels and each strided stage's sites."""
    reader = model.reader
    kind = type(reader).__name__
    if kind == "VoxelFeatureNet" and reader.output == "dense":
        # one slot a point: the dense reader's table cannot overflow
        return {"voxel": {"active": int(tel["voxel_active"]), "capacity": "one slot a point",
                          "overflow": int(tel["voxel_overflow"])}}
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
        bb, spatial = model.backbone, (reader.grid.size_y, reader.grid.size_x)
        caps.update({name: c for name, c in bb.table_capacities(caps["pillar"], batch, spatial).items()
                     if f"{name}_active" in tel})
        for key in tel:
            if "_tiles" in key and key.endswith("_active"):  # models/resnet.py _tile_map_for
                name = key[:-len("_active")]
                tag, h = name.split("_tiles")
                frac = 1.0 if tag == "prefix" else float(bb.stage_capacity_frac[int(tag[len("stage"):])])
                grid = (int(h), int(h) * spatial[1] // spatial[0])
                caps[name] = bb.tile_slots(bb.tile_capacity if tiles is None else tiles, batch, grid, frac)
    return {name: {"active": int(tel[f"{name}_active"]), "capacity": c,
                   "overflow": int(tel[f"{name}_overflow"])} for name, c in caps.items()}


def serving_path(path: str, model_cfg, model, device, required: tuple, latency_frames: int = LATENCY_FRAMES):
    """A serving main path, bf16, batch 1, through AdaptivePredictor at the
    config's full grid: per frame the valid count, the bucket it ran at,
    whether it was repaired and each table's active count beside its rows;
    the latency median of ``latency_frames`` frames, a breakdown, peak
    memory and the launches; fails unless every kernel in ``required``
    launched."""
    from pillarnext_tpu_torch.serving import AdaptivePredictor, tile_kwargs

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
        tel, tiles = {}, tile_kwargs(model, bucket, engine.buckets[-1])
        with torch.inference_mode():
            model.predict(p, m, capacity=bucket, telemetry=tel, **tiles)
        per_frame.append({"seed": seed, "points": int(m.sum()), "valid": int(out["valid"].sum()),
                          "bucket": bucket, "repaired": engine.repaired > repaired,
                          "tables": table_report(model, tel, bucket, tiles=tiles.get("tile_capacity"))})
    latencies = []
    for _ in range(latency_frames):
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
          "breakdown_ms": layer_breakdown(model, *frames[0], engine._operating_bucket(), engine.buckets[-1]),
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


def train_path(cfg, batches, device, work_dir, path: str, required: tuple, ops: bool = True):
    """A training main path, bf16, B = 4, through the port's Trainer: its
    record carries the step times, losses, the last step's tables (each
    active count beside its rows), peak memory, a breakdown and a 1-step
    device profile (its host ops too with ``ops``); it fails unless every
    kernel in ``required`` launched and every loss is finite (the Trainer
    raises on an overflowed table)."""
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
    rec["profile"] = profile_train_steps(model, opt, batches, device, ops=ops)
    emit(rec)
    if len(losses) < len(batches) or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{path} path losses: {losses}")
    for name in required:
        if launches[name] == 0:
            raise AssertionError(f"the {path} path never launched {name}")
    return model, launches


def f32_train_kernels_vs_plain(cfg, batch, device, phase: str, check_bev: bool = False):
    """One f32 train step with the kernels and one with their plain
    versions, same weights and batch, PyTorch's deterministic algorithms
    on.  Kernel 3's max and kernel 2's gathers are exact and the segment
    sums run the same way on both routes, so the losses agree to 1e-6
    relative; the gradients differ by kernel 3's ``sum`` order in the
    flagship PFN's backward: each tensor within 1e-3 of its largest
    magnitude.  For voxel18 (and with ``check_bev``) the backbone's output
    in train mode must also be bit-identical on both routes."""
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
            if (check_bev or isinstance(model.reader, VoxelFeatureNet)) and not plain:
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


@contextlib.contextmanager
def launches_through(module, name: str, kernel):
    """Inside the block, the yielded list's one entry counts the launches
    of ``kernel`` (a wrapper with a ``launches`` counter) made by calls
    through ``module.name``: the tile gathers' share of kernel 2."""
    real, count = getattr(module, name), [0]

    def counting(*args):
        before = kernel.launches
        out = real(*args)
        count[0] += kernel.launches - before
        return out

    setattr(module, name, counting)
    try:
        yield count
    finally:
        setattr(module, name, real)


def f32_agreement(bev: torch.Tensor, ref: torch.Tensor) -> dict:
    """How far an f32 backbone output lies from the leading path's at the
    same weights: within ``atol = rtol = 1e-3`` elementwise or not."""
    diff = (bev - ref).abs()
    excess = diff - 1e-3 * ref.abs()
    return {"f32_bev_max_abs_diff": float(diff.max()), "f32_bev_max_excess_over_rtol": float(excess.max()),
            "f32_bev_within_1e3": bool((excess <= 1e-3).all()),
            "tolerance": "f32 backbone output vs leading: atol = rtol = 1e-3"}


def backbone_bev(model, points, mask, plain: bool = False) -> torch.Tensor:
    """The backbone's output of one eval frame (the reader's table or image
    through the backbone), under the model's precision."""
    with torch.inference_mode(), model.precision():
        return model.backbone(model.reader(points, mask, plain=plain), plain=plain)


def serving_modes(device) -> dict:
    """The flagship as its YAML gives it with one backbone override each
    (``SERVING_MODES``), served bf16 at batch 1 through AdaptivePredictor
    (``serving_path``: frames, buckets, tables and tiles, the median,
    breakdown, launches), each path failing unless kernels 1-3 launched
    and, on the tile paths, unless the tile gathers launched kernel 2.
    Then, against the default ``leading`` path at the same weights: the
    bf16 detections' matched fraction, and for the modes exact on the
    active set (``EXACT_MODES``) the f32 backbone output within ``atol =
    rtol = 1e-3``; the other two modes' f32 BEV must be bit-identical
    between the kernels and their plain versions.  Returns each path's
    model (profiled in the last phase) and launches."""
    from pillarnext_tpu_torch.ops import gather, tile_subm
    from pillarnext_tpu_torch.serving import tile_kwargs
    from pillarnext_tpu_torch.utils.builders import build_model
    from pillarnext_tpu_torch.utils.config import load_experiment

    base = load_experiment(FLAGSHIP)["model"]
    points, mask = frame(base["reader"]["pc_range"], 0, device)
    lead16 = build_model(base, device=device, generator=torch.Generator().manual_seed(0))
    lead32 = build_model(dict(base, dtype="float32"), device=device, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        lead_dets = lead16.predict(points, mask)
    lead_bev = backbone_bev(lead32, points, mask)
    del lead16, lead32
    out = {}
    for path, override in SERVING_MODES.items():
        mcfg = load_experiment(FLAGSHIP, [override])["model"]
        model = build_model(mcfg, device=device, generator=torch.Generator().manual_seed(0))
        with launches_through(tile_subm, "monotone_row_gather", gather.monotone_row_gather) as tile_launches:
            _, launches = serving_path(path, mcfg, model, device, KERNELS, MODE_LATENCY_FRAMES)
        rec = {"phase": f"{path}_vs_leading", "override": override, "tile_gather_launches": tile_launches[0]}
        with torch.inference_mode():
            dets = model.predict(points, mask, **tile_kwargs(model, model.reader.capacity, model.reader.capacity))
        rec["bf16_valid"] = [int(dets["valid"][0].sum()), int(lead_dets["valid"][0].sum())]
        rec["bf16_matched_fraction_vs_leading"] = matched_fraction(dets, lead_dets)
        if path in EXACT_MODES:
            m32 = build_model(dict(mcfg, dtype="float32"), device=device, generator=torch.Generator().manual_seed(0))
            rec.update(f32_agreement(backbone_bev(m32, points, mask), lead_bev))
            del m32
        emit(rec)
        if path in EXACT_MODES and not rec["f32_bev_within_1e3"]:
            raise AssertionError(f"{path}: the f32 backbone output differs from the leading path's: {rec}")
        if "tile" in path and tile_launches[0] == 0:
            raise AssertionError(f"the {path} path never launched kernel 2 through the tile gathers")
        if path not in EXACT_MODES:
            f32_bev_kernels_vs_plain(f"{path}_f32_kernels_vs_plain", mcfg, points, mask, device)
        out[path] = {"model": model, "launches": launches}
        torch.cuda.empty_cache()
    return out


def train_modes(batches, device) -> dict:
    """The flagship as its YAML gives it with one backbone override each
    (``TRAIN_MODES``), trained bf16 at B = 4 through the Trainer for
    ``MODE_TRAIN_STEPS`` steps (``train_path``: step times, peak memory,
    each table's and tile map's active count beside its rows, a breakdown
    and a 1-step device profile), each path failing unless kernels 2 and 3
    launched (and the tile gathers, on the tile paths) and no table
    overflowed; then one f32 ``tile_stride1`` step whose train-mode BEV
    must be bit-identical between the kernels and their plain versions.
    Returns each path's launches."""
    from pillarnext_tpu_torch.ops import gather, tile_subm
    from pillarnext_tpu_torch.utils.config import load_experiment

    out = {}
    for path, override in TRAIN_MODES.items():
        mcfg = load_experiment(FLAGSHIP, [override])
        with (tempfile.TemporaryDirectory(dir=REPO) as work_dir,
              launches_through(tile_subm, "monotone_row_gather", gather.monotone_row_gather) as tile_launches):
            model, out[path] = train_path(mcfg, batches[:MODE_TRAIN_STEPS], device, work_dir, path, KERNELS[1:],
                                          ops=False)
        emit({"phase": f"{path}_tile_gathers", "override": override, "tile_gather_launches": tile_launches[0]})
        if "tile" in path and tile_launches[0] == 0:
            raise AssertionError(f"the {path} path never launched kernel 2 through the tile gathers")
        del model
        torch.cuda.empty_cache()
        if path == "train_tile_stride1":
            f32_train_kernels_vs_plain(mcfg, batches[0], device, "tile_stride1_f32_train_kernels_vs_plain",
                                       check_bev=True)
            torch.cuda.empty_cache()
    return out


def first_block_call(model_cfg, batch, device, forward) -> tuple:
    """(block, arguments) of the first ``forward`` block of a bf16 training
    forward (reader and backbone) of ``model_cfg`` on ``batch``: a block's
    tables as one train step builds them."""
    from pillarnext_tpu_torch.models import resnet
    from pillarnext_tpu_torch.train.trainer import batch_to_device
    from pillarnext_tpu_torch.utils.builders import build_model

    model = build_model(model_cfg, device=device, generator=torch.Generator().manual_seed(0), train=True)
    real, calls = resnet.run_block, []

    def spy(fwd, block, *args, remat=None):
        if fwd is forward and not calls:
            calls.append((block, tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args)))
        return real(fwd, block, *args, remat=remat)

    resnet.run_block = spy
    try:
        ex = batch_to_device(batch, device)
        with torch.no_grad():
            model.backbone(model.reader(ex["points"], ex["points_mask"]))
    finally:
        resnet.run_block = real
    if not calls:
        raise AssertionError(f"a training forward ran no {forward.__name__}")
    return calls[0]


def recompute_block_check(name: str, model_cfg, batch, device) -> None:
    """One SubM residual block at full width, on the tables of one training
    forward of ``model_cfg``, run bare and recomputed (``run_block`` with
    the ``remat_save_conv_out`` policy on and off), forward and backward of
    one seeded cotangent: prints whether the output, the input gradient and
    every parameter gradient are bitwise equal to the bare block's, and
    the largest difference of each.  Raises if an output differs or a
    gradient is not finite."""
    import copy

    from pillarnext_tpu_torch.models import resnet

    block, args = first_block_call(model_cfg, batch, device, resnet.sparse_residual_block)
    x0, rest = args[0], args[1:]
    results = {}
    for remat in (None, True, False):
        b = copy.deepcopy(block).train()
        x = x0.clone().requires_grad_()
        y = resnet.run_block(resnet.sparse_residual_block, b, x, *rest, remat=remat)
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)).to(device, y.dtype)
        y.backward(g)
        results[remat] = {"output": y.detach(), "input_grad": x.grad,
                          **{f"{k}.grad": p.grad for k, p in b.named_parameters()}}
        del b, x, y, g
    rec = {"phase": "recompute_block_check", "block": name, "rows": int(x0.shape[0]),
           "channels": int(x0.shape[1]), "dtype": str(x0.dtype).removeprefix("torch."),
           "active_rows": int(rest[0].sum())}
    failures = []
    bare = results[None]
    for remat, key in ((True, "save_conv_out"), (False, "no_save_conv_out")):
        got = results[remat]
        rec[key] = {"bitwise_equal": {k: torch.equal(got[k], bare[k]) for k in bare},
                    "max_abs_diff": {k: float((got[k].float() - bare[k].float()).abs().max()) for k in bare}}
        if not torch.equal(got["output"], bare["output"]):
            failures.append(f"{key}: the output differs from the bare block's")
        failures += [f"{key}: {k} not finite" for k in got if not torch.isfinite(got[k]).all()]
    emit(rec)
    if failures:
        raise AssertionError(f"recompute_block_check {name}: {failures}")


def reference_checkpoint(common: list, tmp: Path, overrides: list, counters, trained, device) -> dict:
    """A checkpoint in the reference's layout (under ``state_dict``, keys
    prefixed ``module.``, the sparse backbone's kernels in spconv's (O, kH,
    kW, I), a ``num_batches_tracked`` beside each BatchNorm) of
    ``cli.train``'s weights (seed 0, two steps), sent through
    ``cli.import_checkpoint``: the imported tensors must be the source's
    bits, ``cli.test`` of the imported checkpoint must give the bits of
    ``cli.train``'s detections, and one frame served from it the bits of
    the source model's frame.  Returns the ``cli.test`` run's launches."""
    from pillarnext_tpu_torch.cli import import_checkpoint
    from pillarnext_tpu_torch.serving import AdaptivePredictor
    from pillarnext_tpu_torch.train import checkpoint as ckpt_lib
    from pillarnext_tpu_torch.utils.builders import build_model
    from pillarnext_tpu_torch.utils.config import load_experiment
    from pillarnext_tpu_torch.utils.torch_import import state_dict_to_reference

    source = ckpt_lib.load_checkpoint(tmp / "work/checkpoints/epoch_1.pt")["model"]
    sd = state_dict_to_reference(source, checkpoint=True)
    torch.save({"state_dict": sd, "epoch": 1}, tmp / "reference.pth")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        path = import_checkpoint.main([*common[:2], "--torch-checkpoint", str(tmp / "reference.pth"),
                                       "--out", str(tmp / "imported"), *common[2:], *overrides])
    import_s = time.perf_counter() - t0
    imported = ckpt_lib.load_checkpoint(path)["model"]
    same_tensors = imported.keys() == source.keys() and all(torch.equal(imported[k], source[k]) for k in source)
    launches = cli_test_run("reference_checkpoint_cli_test", common, tmp, overrides, counters, trained,
                            "scorer_seconds", checkpoint=path)
    cfg = load_experiment(FLAGSHIP, overrides)
    frame_out = []
    for weights in (source, imported):
        model = build_model(cfg["model"], device=device)
        model.load_state_dict(weights, strict=True)
        with torch.inference_mode():
            frame_out.append(AdaptivePredictor(model).predict(*frame(cfg["model"]["reader"]["pc_range"], 0, device)))
        del model
    same_frame = same_prediction(*frame_out)
    emit({"phase": "reference_checkpoint", "tensors": len(sd), "import_seconds": import_s,
          "imported_tensors_bit_identical": same_tensors, "frame_detections": int(frame_out[0]["valid"][0].sum()),
          "frame_bit_identical": same_frame})
    if not (same_tensors and same_frame):
        raise AssertionError(f"reference_checkpoint: tensors identical {same_tensors}, frame identical {same_frame}")
    return launches


def overfit_flagship(device) -> dict:
    """The port's ``tools.overfit_sanity`` on the flagship as its YAML gives
    it (1344^2, bf16): ``OVERFIT_STEPS`` Trainer steps on JAX's planted
    scene, then JAX's bar (the loss halves, 8 of 10 objects within 2 m),
    which raises if it is not met.  Returns the run's launches."""
    from pillarnext_tpu_torch.tools import overfit_sanity

    counters = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    for k in counters:
        k.launches = 0
    with contextlib.redirect_stdout(sys.stderr):
        result = overfit_sanity.run("flagship", OVERFIT_STEPS, device, log=lambda s: print(s, file=sys.stderr))
    launches = {k.__name__: k.launches for k in counters}
    emit({"phase": "main_path", "path": "overfit_flagship", **result,
          "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2**20, "launches": launches})
    overfit_sanity.check(result)
    for name in KERNELS[1:]:
        if not launches[name]:
            raise AssertionError(f"overfit_flagship never launched {name}")
    return launches


def parity_record(phase: str, rec: dict, launches: dict) -> dict:
    """A parity phase's JSON line: a tool's record without its detection
    sets, the counts of both sides as ``detections`` [mirror, port], the
    overfit's seconds (null with random weights) and the launches."""
    from pillarnext_tpu_torch.tools.parity import printable

    return {"phase": phase, **printable(rec), "detections": [rec["ref"], rec["ours"]],
            "overfit_seconds": rec.get("overfit_seconds"), "launches": launches}


def counted_run(run) -> tuple:
    """(``run(log=...)``, each kernel's launches in it): the launch
    counters set to 0 just before and read just after; the run's text goes
    to stderr."""
    counters = kernel_counters()
    for k in counters:
        k.launches = 0
    with contextlib.redirect_stdout(sys.stderr):
        rec = run(log=lambda s: print(s, file=sys.stderr, flush=True))
    return rec, {k.__name__: k.launches for k in counters}


def emit_counted(phase: str, line: dict, required: tuple) -> dict:
    """Prints a counted phase's line; fails unless every kernel in
    ``required`` launched.  Returns the launches."""
    emit(line)
    missing = [name for name in required if not line["launches"][name]]
    if missing:
        raise AssertionError(f"{phase} never launched {missing}")
    return line["launches"]


def counted_phase(phase: str, run, required: tuple, record) -> dict:
    """One phase of a tool: ``run(log=...)`` (the tool's ``run``) under
    ``counted_run``; prints ``record(phase, the tool's record, launches)``
    and fails unless every kernel in ``required`` launched.  Returns the
    launches."""
    rec, launches = counted_run(run)
    return emit_counted(phase, record(phase, rec, launches), required)


def parity_phase(phase: str, run, required: tuple) -> dict:
    """One parity phase (``counted_phase``): ``run`` is a parity tool's
    ``run``, which raises on a miss against its bar; prints
    ``parity_record``."""
    return counted_phase(phase, run, required, parity_record)


def tool_record(phase: str, rec: dict, launches: dict) -> dict:
    return {"phase": "main_path", "path": phase, **rec, "launches": launches}


def tool_paths(device, step_ms: float) -> dict:
    """The measurement tools at full width, each a ``counted_phase``:
    ``eval_breakdown`` (the flagship's eight eval prefixes, masked, B = 1,
    ``BREAKDOWN_REPS`` calls each; kernels 1-3), ``train_breakdown`` (the
    truncated flagships and the ``remat_save_conv_out=false`` row, B = 4,
    ``BREAKDOWN_STEPS`` steps each; kernels 2 and 3), ``baseline_probe``
    (the reference mirror against the port's f32 predict on the card,
    checked at the random-weight bar first, ``PROBE_RUNS`` runs a side;
    kernels 1-3) and ``loader_bench`` (host only: ``LOADER_TRIPS``
    trips of each worker at ``LOADER_WORKERS`` workers, against the
    ``step_ms`` of the train path).  Returns the device tools' launches."""
    from pillarnext_tpu_torch.tools import baseline_probe, eval_breakdown, loader_bench, train_breakdown

    runs = {
        "eval_breakdown": (lambda log: eval_breakdown.run(1, True, N_POINTS, BREAKDOWN_REPS, device=device, log=log),
                           KERNELS),
        "train_breakdown": (lambda log: train_breakdown.run(4, N_POINTS, BREAKDOWN_STEPS, device=device, log=log),
                            KERNELS[1:]),
        "baseline_probe": (lambda log: baseline_probe.run(PROBE_RUNS, N_POINTS, device=device, log=log), KERNELS),
    }
    launches = {}
    for phase, (run, required) in runs.items():
        launches[phase] = counted_phase(phase, run, required, tool_record)
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        counted_phase("loader_bench", lambda log: loader_bench.run(workers=LOADER_WORKERS, step_ms=step_ms, root=tmp,
                                                                   trips=LOADER_TRIPS, log=log), (), tool_record)
    return launches


def parity_run(phase: str, device) -> tuple:
    """(the run of a parity phase, the kernels it must launch): the
    flagship with random weights (JAX's bar: 85% matched, box 0.5, score
    2e-3); the flagship, voxel18 and MVF each overfitted ``PARITY_STEPS``
    steps on a planted scene of 24 objects (exact set equality, more than 0
    detections; box 1e-2 and score 1e-3 for the flagship, 5e-2 and 5e-3
    for the 3-D families)."""
    from pillarnext_tpu_torch.tools import flagship_parity, mvf_parity, voxel_parity

    tool, steps, required = {
        "parity_flagship": (flagship_parity, 0, KERNELS),
        "parity_flagship_trained": (flagship_parity, PARITY_STEPS, KERNELS),
        "parity_voxel18_trained": (voxel_parity, PARITY_STEPS, KERNELS[1:]),
        "parity_mvf_trained": (mvf_parity, PARITY_STEPS, KERNELS[1:]),
    }[phase]
    return (lambda log: tool.run(N_POINTS, overfit=steps, device=device, log=log)), required


def start_parity_processes(out_dir: Path) -> dict:
    """``PARITY_PROCESSES``, each a ``parity-worker`` process of its own on
    the card, started now: phase -> (process, its record file, its log).
    Their overfits are host-bound, so they run beside the flagship's."""
    procs = {}
    for phase in PARITY_PROCESSES:
        out, log = out_dir / f"{phase}.json", out_dir / f"{phase}.log"
        with open(log, "w") as f:
            proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "parity-worker", phase, str(out)],
                                    stdout=f, stderr=subprocess.STDOUT)
        procs[phase] = (proc, out, log)
    return procs


def parity_worker(phase: str, out: str) -> None:
    """One parity phase in a process of its own (run as ``chip_smoke.py
    parity-worker PHASE FILE``): its ``parity_record``, and the process's
    seconds from its start, to FILE; a miss raises (a non-zero exit)."""
    sys.path.insert(0, str(REPO))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run, _ = parity_run(phase, device)
    rec, launches = counted_run(run)
    line = {**parity_record(phase, rec, launches), "process_seconds": time.perf_counter() - STARTED}
    Path(out).write_text(json.dumps(line))


def parity_paths(device, processes: dict) -> dict:
    """The port's f32 detections held against its copy of the reference
    mirror (``tools/*_parity.py``, the mirror in full f32 on the card) at
    the configs' grids, 200k points, each phase's bar as ``parity_run``
    gives it: the phases not in ``processes`` here, then each of
    ``processes`` (``start_parity_processes``) awaited, its line printed
    and its launches checked.  Returns each phase's launches."""
    launches = {}
    for phase in PARITY_PHASES:
        if phase not in processes:
            launches[phase] = parity_phase(phase, *parity_run(phase, device))
            torch.cuda.empty_cache()
    for phase, (proc, out, log) in processes.items():
        wait_ranks([proc], [log], PARITY_TIMEOUT_S, phase)
        launches[phase] = emit_counted(phase, json.loads(out.read_text()), parity_run(phase, device)[1])
    return launches


def f32_predict(model_cfg, points, mask, device) -> dict:
    """One f32 predict of ``model_cfg`` with random weights from seed 0."""
    from pillarnext_tpu_torch.utils.builders import build_model

    model = build_model(dict(model_cfg, dtype="float32"), device=device, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        return model.predict(points, mask)


def serving_options(device) -> dict:
    """The flagship as its YAML gives it with one option each
    (``OPTION_PATHS``: the unfused and the merged heads, the unfused and
    the 3-layer PFN stacks, circle NMS, approx_topk), served bf16 at batch
    1 through AdaptivePredictor (``serving_path``), each failing unless
    the kernels of its path launched (kernel 1 serves only the fused
    2-layer PFN).  Then one f32 frame against the default path's at the
    same weights: the paths that compute its function (``SAME_FUNCTION``)
    must give as many detections, ``MIN_MATCHED`` of them matched; the
    3-layer PFN's f32 BEV must be bit-identical between the kernels and
    their plain versions.  Returns each path's model (profiled in the last
    phase) and launches."""
    from pillarnext_tpu_torch.utils.builders import build_model
    from pillarnext_tpu_torch.utils.config import load_experiment

    base = load_experiment(FLAGSHIP)["model"]
    points, mask = frame(base["reader"]["pc_range"], 0, device)
    ref = f32_predict(base, points, mask, device)
    out = {}
    for path, override in OPTION_PATHS.items():
        mcfg = load_experiment(FLAGSHIP, [override])["model"]
        model = build_model(mcfg, device=device, generator=torch.Generator().manual_seed(0))
        required = KERNELS if model.reader.kernel_eval else KERNELS[1:]
        _, launches = serving_path(path, mcfg, model, device, required, MODE_LATENCY_FRAMES)
        dets = f32_predict(mcfg, points, mask, device)
        rec = {"phase": f"{path}_vs_serving", "override": override,
               "f32_valid": [int(dets["valid"][0].sum()), int(ref["valid"][0].sum())],
               "f32_matched_fraction": matched_fraction(dets, ref), "f32_bit_identical": same_prediction(dets, ref),
               "tolerance": f"as many f32 detections as the default path, >= {MIN_MATCHED} matched"
               if path in SAME_FUNCTION else "reported only: another function"}
        emit(rec)
        if path in SAME_FUNCTION and (rec["f32_valid"][0] != rec["f32_valid"][1]
                                      or rec["f32_matched_fraction"] < MIN_MATCHED):
            raise AssertionError(f"{path}: the f32 detections differ from the default path's: {rec}")
        if path == "serving_pfn3":
            f32_bev_kernels_vs_plain("pfn3_f32_kernels_vs_plain", mcfg, points, mask, device)
        del dets
        out[path] = {"model": model, "launches": launches}
        torch.cuda.empty_cache()
    return out


def voxel_dense_path(device) -> dict:
    """voxel18 at full widths with the dense volume (``VOXEL_DENSE``) at the
    config's 40 x 1344 x 1344 grid, served as every path is
    (``serving_path``, ``VOXEL_DENSE_FRAMES`` latency frames; kernels 2 and
    3 must launch: the reader's sums and its densify); then, outside the
    counted run, the volume's shape and occupied voxels, and the f32 BEV
    bit-identical between the kernels and their plain versions.  Returns
    the model, a frame and the launches."""
    from pillarnext_tpu_torch.utils.builders import build_model
    from pillarnext_tpu_torch.utils.config import load_experiment

    vcfg = load_experiment(VOXEL18, [VOXEL_DENSE])["model"]
    model = build_model(vcfg, device=device, generator=torch.Generator().manual_seed(0))
    frames, launches = serving_path("voxel_dense", vcfg, model, device, KERNELS[1:],
                                    latency_frames=VOXEL_DENSE_FRAMES)
    with torch.inference_mode():
        volume = model.reader(*frames[0])
        emit({"phase": "voxel_dense_volume", "override": VOXEL_DENSE, "volume_shape": list(volume.shape),
              "occupied_voxels": int(volume.any(-1).sum())})
        del volume
    torch.cuda.empty_cache()
    f32_bev_kernels_vs_plain("voxel_dense_f32_kernels_vs_plain", vcfg, *frames[0], device)
    torch.cuda.empty_cache()
    return {"model": model, "frame": frames[0], "launches": launches}


def write_nuscenes_tree(root: Path, pc_range, class_names: list, seed: int) -> dict:
    """A nuScenes-format tree (the converter's infos pickles under the names
    the flagship YAML reads, ``infos_{train,val}_10sweeps_withvelo_filterZero.pkl``,
    and .bin sweeps) of ``CLI_SAMPLES`` train and as many val samples; its
    GT database is built by the port's ``create_groundtruth_database``
    (``cli_paths``).

    Each sample is one synthetic scene of ``SWEEPS x SWEEP_POINTS`` points
    (``utils/synth.synth_detection_scene``: 20-40 GT boxes at class-typical
    sizes over beam-structured ``lidar_like_points`` surfaces of
    ``POINTS_PER_SURFACE`` points, so that the sweeps see the same surfaces
    and a frame occupies ~55k pillars, as real 10-sweep frames occupy
    40-65k of the 1344^2), dealt into a keyframe and ``SWEEPS - 1``
    sweeps; sweep k is written in the frame of an ego ``0.5 k`` m behind
    (and 0.002 k rad turned), with the transform back to the keyframe and
    ``time_lag`` 0.05 k in its info, as a 10-sweep nuScenes frame has
    them."""
    import pickle

    import numpy as np

    from pillarnext_tpu_torch.utils.synth import synth_detection_scene

    rng = np.random.default_rng(seed)
    (root / "samples").mkdir(parents=True)

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
        with open(root / nuscenes_infos(split_name), "wb") as f:
            pickle.dump(infos, f)
        return infos

    train, val = split("train"), split("val")
    points = [sum(np.fromfile(root / p, np.float32).size // 5 for p in
                  [info["lidar_path"], *(s["lidar_path"] for s in info["sweeps"])]) for info in train + val]
    return {"samples": {"train": len(train), "val": len(val)}, "points_per_sample": [min(points), max(points)],
            "gt_boxes_per_sample": [min(len(i["gt_names"]) for i in train + val),
                                    max(len(i["gt_names"]) for i in train + val)]}


def nuscenes_infos(split_name: str) -> str:
    """The nuScenes converter's infos file name for ``SWEEPS`` sweeps."""
    return f"infos_{split_name}_{SWEEPS}sweeps_withvelo_filterZero.pkl"


def gt_database(dataset: str, root: Path, info_path: str, nsweeps: int, class_names: list) -> dict:
    """The port's ``create_groundtruth_database`` on the tree at ``root``
    (its default crop directory and dbinfos name, the ones the YAMLs read):
    host seconds, crops per class (a class with none stays so: the
    sampler then pastes none of it) and the least and most points in a
    crop."""
    from pillarnext_tpu_torch.cli.create_gt_database import create_groundtruth_database

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        db = create_groundtruth_database(dataset, str(root), info_path=info_path, nsweeps=nsweeps)
    seconds = time.perf_counter() - t0
    counts = [e["num_points_in_gt"] for entries in db.values() for e in entries]
    return {"host_seconds": seconds, "crops_per_class": {n: len(db.get(n, [])) for n in class_names},
            "classes_without_crops": [n for n in class_names if not db.get(n)],
            "points_per_crop": [min(counts), max(counts)] if counts else None}


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
    its result into ``out["val"]``; the first host batch of training and of
    validation are kept in ``out["first_batch"]`` under "train" and "val"."""
    from pillarnext_tpu_torch.train import trainer as trainer_module
    from pillarnext_tpu_torch.train.trainer import Trainer

    out = {"step_ms": [], "val": [], "first_batch": {}}
    train_step, val_epoch, to_device = Trainer.train_step, Trainer.val_epoch, trainer_module.batch_to_device

    def kept_val_batch(batch, device):
        out["first_batch"].setdefault("val", batch)
        return to_device(batch, device)

    def timed_step(self, batch):
        out["first_batch"].setdefault("train", batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = train_step(self, batch)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        return result

    def counted_val(self):
        before = {k.__name__: k.launches for k in counters}
        trainer_module.batch_to_device = kept_val_batch
        try:
            result = val_epoch(self)
        finally:
            trainer_module.batch_to_device = to_device
        out["val"].append({"before": before, "after": {k.__name__: k.launches for k in counters},
                           "result": result})
        return result

    Trainer.train_step, Trainer.val_epoch = timed_step, counted_val
    try:
        yield out
    finally:
        Trainer.train_step, Trainer.val_epoch = train_step, val_epoch


def cli_ddp_worker(out_dir: str, argv: list) -> None:
    """One rank of ``cli_train_ddp`` (run by torchrun as ``chip_smoke.py
    cli-ddp-worker DIR ARGV...``): ``cli.train.main(argv)`` with the
    kernels' launches counted from the start; writes its ``rank_record``
    (``rank{r}.json``) with its steps, the tokens of its val detections
    (rank 0: the union it scored), whether its val epoch returned a
    result and its step and val times."""
    sys.path.insert(0, str(REPO))
    from pillarnext_tpu_torch import parallel
    from pillarnext_tpu_torch.cli import train as cli_train

    counters = kernel_counters()
    for k in counters:
        k.launches = 0
    with cli_instruments(counters) as inst, contextlib.redirect_stdout(sys.stderr):
        trained = cli_train.main(argv)
    val, = inst["val"]
    write_rank_record(out_dir, {
        "world_size": parallel.world_size(), "device": str(trained.device), "step": trained.step,
        "epoch": trained.epoch, "steps_per_epoch": len(trained.train_dataloader), "step_ms": inst["step_ms"],
        "losses": [float(v) for v in trained.epoch_losses], "val_tokens": sorted(trained.last_detections),
        "scored": val["result"] is not None, "val_ms_per_batch": [b * 1e3 for b in trained.val_timing["batch_s"]],
        "scorer_seconds": trained.val_timing["scorer_s"],
        "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2**20})
    parallel.shutdown()


def cli_train_run(common: list, work: Path, overrides: list, counters) -> tuple:
    """``cli.train.main`` in this process, its launches counted from 0,
    its steps timed and its ``val_epoch`` recorded (``cli_instruments``):
    (the Trainer, the record's common fields, the failures common to the
    CLI paths: losses not finite, kernels 2 and 3 not launched in training
    or 1 and 2 not in ``val_epoch``, detections not finite (D, 9) boxes;
    the scorer's result, the first train and val host batches)."""
    import numpy as np

    from pillarnext_tpu_torch.cli import train as cli_train

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    # the CLIs' progress bars go to stderr: stdout holds the JSON lines
    with cli_instruments(counters) as inst, contextlib.redirect_stdout(sys.stderr):
        trained = cli_train.main([*common, "--work-dir", str(work), *overrides])
    train_s = time.perf_counter() - t0
    val, = inst["val"]
    in_training, in_val = val["before"], {k: val["after"][k] - val["before"][k] for k in val["after"]}
    losses = [float(v) for v in trained.epoch_losses]
    timing = trained.val_timing
    rec = {"steps": len(inst["step_ms"]), "step_ms": inst["step_ms"],
           "loader_wait_ms": [w * 1e3 for w in trained.loader_wait_s],
           "loader_start_ms": trained.train_dataloader.start_s * 1e3,
           "loader_batch_ms_in_worker": [t * 1e3 for t in trained.train_dataloader.load_s], "losses": losses,
           "val_batches": len(timing["batch_s"]), "val_ms_per_batch": [b * 1e3 for b in timing["batch_s"]],
           "val_loader_wait_ms": [w * 1e3 for w in timing["loader_wait_s"]],
           "val_loader_start_ms": trained.val_dataloader.start_s * 1e3,
           "val_loader_batch_ms_in_worker": [t * 1e3 for t in trained.val_dataloader.load_s],
           "eval_repairs": trained.eval_repairs, "cli_seconds": train_s,
           "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2**20,
           "launches": {k.__name__: k.launches for k in counters}, "launches_in_training": in_training,
           "launches_in_val_epoch": in_val}
    failures = []
    if len(losses) != 2 or not all(math.isfinite(v) for v in losses):
        failures.append(f"losses {losses}")
    failures += [f"{name} never launched in training" for name in KERNELS[1:] if not in_training[name]]
    failures += [f"{name} never launched in val_epoch" for name in KERNELS[:2] if not in_val[name]]
    if not all(np.isfinite(d[k]).all() and d["box3d_lidar"].shape == (len(d["scores"]), 9)
               for d in trained.last_detections.values() for k in ("box3d_lidar", "scores")):
        failures.append("detections not finite or not (D, 9) boxes")
    return trained, rec, failures, val["result"], inst["first_batch"]


def cli_test_run(path: str, common: list, tmp: Path, overrides: list, counters, trained, scorer_key: str,
                 checkpoint=None) -> dict:
    """``cli.test.main`` on ``checkpoint`` (``cli_train_run``'s under
    ``tmp/work`` by default): emits ``path``'s record and raises unless
    kernels 1 and 2 launched and its detections are the bits of
    ``trained``'s; returns its launches."""
    import numpy as np

    from pillarnext_tpu_torch.cli import test as cli_test

    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        tested = cli_test.main([*common, "--checkpoint", str(checkpoint or tmp / "work/checkpoints/epoch_1.pt"),
                                "--work-dir", str(tmp / f"{path}_work"), *overrides])
    test_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in counters}
    ref, got = trained.last_detections, tested.last_detections
    differing = sorted(t for t in ref if t not in got or any(
        not np.array_equal(ref[t][k], got[t][k]) for k in ref[t]))
    timing = tested.val_timing
    emit({"phase": "main_path", "path": path, "cli_seconds": test_s,
          "val_batches": len(timing["batch_s"]), "val_ms_per_batch": [b * 1e3 for b in timing["batch_s"]],
          "val_loader_wait_ms": [w * 1e3 for w in timing["loader_wait_s"]],
          "val_loader_start_ms": tested.val_dataloader.start_s * 1e3,
          "val_loader_batch_ms_in_worker": [t * 1e3 for t in tested.val_dataloader.load_s],
          "eval_repairs": tested.eval_repairs, scorer_key: timing["scorer_s"],
          "detections": sum(len(d["scores"]) for d in got.values()),
          "detections_bit_identical_to_cli_train": not differing and got.keys() == ref.keys(),
          "differing_tokens": differing, "launches": launches})
    failures = [f"{name} never launched" for name in KERNELS[:2] if not launches[name]]
    if differing or got.keys() != ref.keys():
        failures.append(f"detections differ from cli_train's for {differing or 'the token set'}")
    if failures:
        raise AssertionError(f"{path}: {failures}")
    return launches


def cli_paths(device) -> tuple[dict, dict, dict, dict]:
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
    ``cli.train``'s.  Then ``cli_train_ddp``: torchrun starts
    ``cli.train`` on 2 ranks over gloo on the one card
    (``cli_ddp_worker``), one epoch and its evaluation on the same tree;
    each rank must take half of ``cli.train``'s steps, one checkpoint must
    be written, and rank 0 must score every val token exactly once.
    Between them ``reference_checkpoint`` imports ``cli.train``'s weights
    written in the reference's layout and scores them with ``cli.test``.
    Returns the launches of each CLI run (``cli_train_ddp``: summed over
    its ranks)."""
    import os

    from pillarnext_tpu_torch.utils.config import load_experiment

    cfg = load_experiment(FLAGSHIP)
    class_names = [n for task in cfg["data"]["train_dataset"]["class_names"] for n in task]
    counters = kernel_counters()
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        root, tmp = Path(tmp) / "nuscenes", Path(tmp)
        t0 = time.perf_counter()
        tree = write_nuscenes_tree(root, cfg["model"]["reader"]["pc_range"], class_names, seed=0)
        tree["host_seconds"] = time.perf_counter() - t0
        tree["gt_database"] = gt_database("nuscenes", root, nuscenes_infos("train"), SWEEPS, class_names)
        workers = min(16, os.cpu_count() or 1)
        overrides = [f"data.train_dataset.root_path={root}", "trainer.max_epochs=1",
                     "data.train_dataset.resampling=false", f"dataloader.train.num_workers={workers}",
                     f"dataloader.val.num_workers={workers}"]
        run_cfg = load_experiment(FLAGSHIP, overrides)
        dl = run_cfg["dataloader"]
        host = pipeline_host_ms(run_cfg["data"]["train_dataset"], int(dl["max_points"]),
                                int(dl["train"]["batch_size"]))
        common = ["--config", str(FLAGSHIP), "--device", str(device)]
        trained, rec, failures, val_result, _ = cli_train_run(common, tmp / "work", overrides, counters)
        results = json.loads((tmp / "work/results/epoch_1/results_nusc.json").read_text())["results"]
        rec = {"phase": "main_path", "path": "cli_train", "dtype": run_cfg["model"].get("dtype", "bfloat16"),
               "data": tree, "num_workers": workers, "batch_size": int(dl["train"]["batch_size"]),
               "max_points": int(dl["max_points"]), **rec, "host_pipeline": host,
               "scorer_seconds": trained.val_timing["scorer_s"], "results_nusc_entries": len(results),
               "mean_ap": val_result["mean_ap"], "nd_score": val_result["nd_score"]}
        emit(rec)
        if len(results) != CLI_SAMPLES:
            failures.append(f"results_nusc.json holds {len(results)} entries, expected {CLI_SAMPLES}")
        if not (math.isfinite(rec["mean_ap"]) and math.isfinite(rec["nd_score"])):
            failures.append("mean_ap / nd_score not finite")
        if failures:
            raise AssertionError(f"cli_train: {failures}")
        launches = rec["launches"]
        test_launches = cli_test_run("cli_test", common, tmp, overrides, counters, trained, "scorer_seconds")
        ref_launches = reference_checkpoint(common, tmp, overrides, counters, trained, device)
        ddp_launches = cli_train_ddp(tmp, common, overrides, trained, rec["cli_seconds"])
        del trained
    torch.cuda.empty_cache()
    return launches, test_launches, ref_launches, ddp_launches


def write_waymo_tree(root: Path, pc_range, class_names: list, seed: int) -> dict:
    """A Waymo tree in the converter's output schema: ``WAYMO_FRAMES`` train
    and as many val frames, each one ``synth_detection_scene`` of
    ``N_POINTS`` points with 20-40 boxes of ``class_names``, written as
    ``lidar_point/<token>.bin`` (N, 6) f32 [x y z tanh(intensity)
    elongation nlz], where the points of one azimuth wedge of
    ``NLZ_WEDGE_RAD`` (~3% of a frame) carry the no-label-zone flag 1 and
    the intensity ``NLZ_INTENSITY``, which marks them through any
    augmentation, and the rest -1; ``waymo_infos_{train,val}.pkl`` with each frame's pose (an
    ego 0.5 m further along x a frame), timestamp, up to 4 prior frames of
    its split as sweeps (nearest first) and ``objects`` of ``{id, label,
    box[9], num_points}`` (points inside the box, flagged or not).
    Returns each split's tokens and the points per frame before and after
    the loader's NLZ filter."""
    import pickle

    import numpy as np

    from pillarnext_tpu_torch.core import box_ops
    from pillarnext_tpu_torch.utils.synth import synth_detection_scene

    rng = np.random.default_rng(seed)
    (root / "lidar_point").mkdir(parents=True)
    tokens, before, after = {}, [], []
    for split_name in ("train", "val"):
        infos = []
        for i in range(WAYMO_FRAMES):
            token = f"segment_{split_name}-{1_000_000 + 100_000 * i}"
            pts, boxes, names = synth_detection_scene(rng, N_POINTS, pc_range, int(rng.integers(20, 41)),
                                                      class_names, points_per_surface=POINTS_PER_SURFACE)
            # the wedge is centred on a random point's azimuth, so it flags some
            azimuth = np.arctan2(pts[:, 1], pts[:, 0])
            start = azimuth[rng.integers(len(pts))] - NLZ_WEDGE_RAD / 2
            nlz = np.where(np.mod(azimuth - start, 2 * math.pi) < NLZ_WEDGE_RAD, 1.0, -1.0)
            intensity = np.where(nlz[:, None] == 1, NLZ_INTENSITY, np.tanh(pts[:, 3:4] / 128.0))
            cols = [pts[:, :3], intensity, rng.uniform(0, 0.5, (len(pts), 1)), nlz[:, None]]
            np.concatenate(cols, axis=1).astype(np.float32).tofile(root / "lidar_point" / f"{token}.bin")
            before.append(len(pts))
            after.append(int((nlz == -1).sum()))
            inside = box_ops.points_in_rbbox(pts[:, :3], boxes.astype(np.float64)).sum(axis=0)
            pose = np.eye(4)
            pose[0, 3] = 0.5 * i
            info = {"token": token, "pose": pose, "timestamp": (1_000_000 + 100_000 * i) * 1e-6, "sweeps": [],
                    "objects": [{"id": f"{token}_{j}", "label": str(names[j]), "box": boxes[j].astype(np.float32),
                                 "num_points": int(inside[j])} for j in range(len(boxes))]}
            for prev in infos[-4:][::-1]:
                info["sweeps"].append({"token": prev["token"], "pose": prev["pose"],
                                       "timestamp": info["timestamp"] - prev["timestamp"]})
            infos.append(info)
        with open(root / f"waymo_infos_{split_name}.pkl", "wb") as f:
            pickle.dump(infos, f)
        tokens[split_name] = [info["token"] for info in infos]
    return {"frames": {k: len(v) for k, v in tokens.items()}, "tokens": tokens,
            "points_per_frame_before_nlz": [min(before), max(before)],
            "points_per_frame_after_nlz": [min(after), max(after)],
            "nlz_fraction": [min(1 - a / b for a, b in zip(after, before)),
                             max(1 - a / b for a, b in zip(after, before))]}


def nlz_filtered(batches: dict, root: Path, nsweeps: int) -> dict:
    """``cli.train``'s first train and val host batches
    (``cli_instruments``): no loaded point of either carries
    ``NLZ_INTENSITY`` (the flagged points' mark, kept through GT paste and
    the augmentations), and each val sample holds exactly the unflagged
    points of its frame and of the sweeps it reads (at most the batch's
    width).  Raises otherwise."""
    import pickle

    import numpy as np

    def frame_points(token):
        return np.fromfile(root / "lidar_point" / f"{token}.bin", np.float32).reshape(-1, 6)

    tagged = {name: int((b["points"][..., 3][b["points_mask"]] == NLZ_INTENSITY).sum())
              for name, b in batches.items()}
    with open(root / "waymo_infos_val.pkl", "rb") as f:
        infos = {info["token"]: info for info in pickle.load(f)}
    val, counts = batches["val"], []
    for b, token in enumerate(val["token"]):
        frames = [token, *(s["token"] for s in infos[token]["sweeps"][: nsweeps - 1])]
        kept = sum(int((frame_points(t)[:, 5] == -1).sum()) for t in frames)
        counts.append([int(val["points_mask"][b].sum()), min(kept, val["points_mask"].shape[1])])
    if any(tagged.values()) or any(got != want for got, want in counts):
        raise AssertionError(f"cli_waymo: NLZ-flagged points loaded {tagged}, "
                             f"val points loaded vs unflagged {counts}")
    return {"flagged_points_loaded": tagged,
            "loaded_points": {name: int(b["points_mask"].sum()) for name, b in batches.items()},
            "val_points_loaded_vs_unflagged": counts}


def cli_waymo(device) -> tuple[dict, dict, dict]:
    """The port's CLIs on a Waymo tree written here (``write_waymo_tree``),
    its GT database built by the port's ``create_groundtruth_database``
    (``dbinfos_train_1sweeps_withvelo.pkl``, the name the YAML reads):
    ``cli.train`` on waymo_det_pp18_aspp_iou_car_sp as its YAML gives it
    (2048^2, B = 4, 3 sweeps, bf16, GT paste and augmentations) for one
    epoch of 2 steps with the epoch's ``val_epoch`` and the Waymo export,
    then ``cli.test`` of the checkpoint.  The overrides only point the
    config at the tree, train one epoch and set the workers to
    ``min(16, cores)``.  Fails unless the CLI's loaded batches hold no NLZ
    point (``nlz_filtered``), kernels 2 and 3 launched in training, 1 and 2 in
    ``val_epoch`` and in ``cli.test``, every loss is finite, the export
    holds one entry per val frame and ``cli.test``'s detections are the
    bits of ``cli.train``'s.  Then the multi-host launcher on the same
    tree (``dist_train_waymo``).  Returns the launches of the three runs."""
    import os

    import numpy as np

    from pillarnext_tpu_torch.utils.config import load_experiment

    cfg = load_experiment(WAYMO_PP18)
    class_names = [n for task in cfg["data"]["train_dataset"]["class_names"] for n in task]
    counters = kernel_counters()
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        root, tmp = Path(tmp) / "waymo", Path(tmp)
        t0 = time.perf_counter()
        tree = write_waymo_tree(root, cfg["model"]["reader"]["pc_range"], class_names, seed=1)
        tree["host_seconds"] = time.perf_counter() - t0
        val_tokens = tree.pop("tokens")["val"]
        tree["gt_database"] = gt_database("waymo", root, "waymo_infos_train.pkl", 1, class_names)
        workers = min(16, os.cpu_count() or 1)
        overrides = [f"data.train_dataset.root_path={root}", "trainer.max_epochs=1",
                     f"dataloader.train.num_workers={workers}", f"dataloader.val.num_workers={workers}"]
        run_cfg = load_experiment(WAYMO_PP18, overrides)
        dl = run_cfg["dataloader"]
        common = ["--config", str(WAYMO_PP18), "--device", str(device)]
        trained, rec, failures, val_result, batches = cli_train_run(common, tmp / "work", overrides, counters)
        nlz = nlz_filtered(batches, root, int(run_cfg["data"]["val_dataset"]["nsweeps"]))
        del batches
        export = np.load(tmp / "work/results/epoch_1/waymo_preds.npz", allow_pickle=True)
        exported = sorted(str(t) for t in export["tokens"])
        emit({"phase": "main_path", "path": "cli_waymo", "config": WAYMO_PP18.stem,
              "dtype": run_cfg["model"].get("dtype", "bfloat16"), "data": tree, "nlz": nlz,
              "num_workers": workers, "batch_size": int(dl["train"]["batch_size"]),
              "max_points": int(dl["max_points"]), **rec, "export_seconds": trained.val_timing["scorer_s"],
              "export": val_result, "exported_frames": len(exported)})
        if exported != sorted(val_tokens):
            failures.append(f"the export holds {len(exported)} frames, expected the {len(val_tokens)} val frames")
        if failures:
            raise AssertionError(f"cli_waymo: {failures}")
        test_launches = cli_test_run("cli_waymo_test", common, tmp, overrides, counters, trained, "export_seconds")
        launches = rec["launches"]
        del trained
        torch.cuda.empty_cache()
        launcher_launches = dist_train_waymo(tmp, overrides, val_tokens)
    torch.cuda.empty_cache()
    return launches, test_launches, launcher_launches


def cli_train_ddp(tmp: Path, common: list, overrides: list, trained, train_s: float) -> dict:
    """``cli_train_ddp`` of ``cli_paths``: the summed launches of its
    ranks."""
    out_dir, work = tmp / "ddp_ranks", tmp / "work_ddp"
    out_dir.mkdir()
    argv = [*common[:2], "--device", "cuda:0", "--dist-backend", "gloo", "--work-dir", str(work), *overrides]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           str(Path(__file__).resolve()), "cli-ddp-worker", str(out_dir), *argv]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with open(out_dir / "torchrun.log", "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    wait_ranks([proc], [out_dir / "torchrun.log"], DDP_TIMEOUT_S, "cli_train_ddp")
    wall_s = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(2)]
    summed = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    val_tokens = sorted(trained.last_detections)
    checkpoints = sorted(str(p.relative_to(work)) for p in work.rglob("*.pt"))
    results = json.loads((work / "results/epoch_1/results_nusc.json").read_text())["results"]
    emit({"phase": "main_path", "path": "cli_train_ddp", "ranks": 2, "backend": "gloo",
          "cards": torch.cuda.device_count(), "cli_seconds": wall_s, "cli_train_seconds": train_s,
          "per_rank": ranks, "checkpoints": checkpoints, "results_nusc_entries": len(results),
          "launches": summed})
    failures = []
    if any(r["step"] * 2 != trained.step for r in ranks):
        failures.append(f"steps per rank {[r['step'] for r in ranks]}, one process took {trained.step}")
    if checkpoints != ["checkpoints/epoch_1.pt"]:
        failures.append(f"checkpoints written: {checkpoints}")
    if ranks[0]["val_tokens"] != val_tokens or sorted(results) != val_tokens or not ranks[0]["scored"]:
        failures.append(f"rank 0 scored {len(ranks[0]['val_tokens'])} tokens ({len(results)} in its file), "
                        f"expected the {len(val_tokens)} val tokens")
    if ranks[1]["scored"] or len(ranks[1]["val_tokens"]) != len(val_tokens) // 2 \
            or not set(ranks[1]["val_tokens"]) <= set(val_tokens):
        failures.append(f"rank 1 scored, or its val shard is not half the val tokens: {ranks[1]['val_tokens']}")
    failures += [f"{k} never launched" for k in KERNELS if not summed[k]]
    if not all(math.isfinite(v) for r in ranks for v in r["losses"]):
        failures.append("losses not finite")
    if failures:
        raise AssertionError(f"cli_train_ddp: {failures}")
    return summed


CHILD_SITE = """# Written by chip_smoke.py (child_probe): a process started with RANK in
# its environment writes chip_smoke.rank_record() to rank<RANK>.json at
# its exit.  The interpreter's own sitecustomize, which this one shadows,
# still runs.
import atexit
import importlib.machinery
import importlib.util
import os
import sys

if "RANK" in os.environ:
    sys.path.insert(0, {repo!r})
    import chip_smoke

    atexit.register(chip_smoke.write_rank_record, {out_dir!r})
for _path in sys.path:
    if os.path.abspath(_path or os.curdir) == os.path.dirname(os.path.abspath(__file__)):
        continue
    _spec = importlib.machinery.PathFinder.find_spec("sitecustomize", [_path])
    if _spec is not None:
        _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
        break
"""


def child_probe(out_dir: Path) -> Path:
    """A directory to put first on a child's PYTHONPATH: its
    ``sitecustomize.py`` (``CHILD_SITE``) makes every process started with
    ``RANK`` in its environment write its ``rank_record`` to
    ``out_dir/rank{RANK}.json`` at its exit.  It then runs the
    interpreter's own ``sitecustomize``, which it shadows (the H100
    machine's Python has one)."""
    site = out_dir / "site"
    site.mkdir(parents=True)
    (site / "sitecustomize.py").write_text(CHILD_SITE.format(repo=str(REPO), out_dir=str(out_dir)))
    return site


def foreign_modules() -> list:
    """The modules of JAX, flax or the JAX package this process loaded."""
    return sorted(n for n in sys.modules
                  if n.split(".")[0].startswith(("jax", "flax")) or n.split(".")[0] == "pillarnext_tpu")


def rank_record() -> dict:
    """This rank's ``RANK``, its ``sys.argv``, each kernel's launches (its
    wrappers' counts) and its ``foreign_modules``."""
    import os

    return {"rank": int(os.environ["RANK"]), "argv": sys.argv,
            "launches": {k.__name__: k.launches for k in kernel_counters()}, "foreign_modules": foreign_modules()}


def write_rank_record(out_dir, extra: dict | None = None) -> None:
    """``rank_record`` and ``extra`` to ``out_dir/rank{RANK}.json``."""
    rec = {**rank_record(), **(extra or {})}
    (Path(out_dir) / f"rank{rec['rank']}.json").write_text(json.dumps(rec))


def run_launcher(out_dir: Path, args: list, nproc_per_node: int = 1, timeout_s: float = DDP_TIMEOUT_S) -> list:
    """``bash dist_train_waymo.sh ARGS`` on one node of one group at a free
    local port, with ``child_probe`` first on the ranks' PYTHONPATH and
    this interpreter as theirs, killed at ``timeout_s``; raises unless it
    exits 0.  Returns each rank's ``child_probe`` record."""
    import os

    env = dict(os.environ, COORDINATOR=f"127.0.0.1:{free_port()}", PROCESS_ID="0", NUM_PROCESSES="1",
               NPROC_PER_NODE=str(nproc_per_node), PYTHON=sys.executable)
    env["PYTHONPATH"] = os.pathsep.join([str(child_probe(out_dir)), *filter(None, [os.environ.get("PYTHONPATH")])])
    with open(out_dir / "launcher.log", "w") as log:
        proc = subprocess.Popen(["bash", str(LAUNCHER), *args], env=env, stdout=log, stderr=subprocess.STDOUT)
    wait_ranks([proc], [out_dir / "launcher.log"], timeout_s, "dist_train_waymo")
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(nproc_per_node)]


def dist_train_waymo(tmp: Path, overrides: list, val_tokens: list) -> dict:
    """The multi-host Waymo launcher (``LAUNCHER``) on one node with one
    process: torchrun starts ``cli.train`` of waymo_det_pp18_aspp_iou_car_sp
    with the launcher's overrides (3 samples a card, max_lr 0.006, 36
    epochs) and then ``overrides`` (``cli_waymo``'s tree, one epoch, its
    workers), NCCL on cuda:0: one epoch and its ``val_epoch`` with the
    Waymo export.  Fails unless the rank exits 0, kernels 1-3 launched, the
    epoch's checkpoint holds its steps, the export one entry per val frame
    and the rank loaded no JAX.  Returns the launches."""
    import numpy as np

    out_dir, work = tmp / "launcher", tmp / "work_launcher"
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    rank, = run_launcher(out_dir, ["--work-dir", str(work), *overrides])
    seconds = time.perf_counter() - t0
    checkpoints = sorted(str(p.relative_to(work)) for p in work.rglob("*.pt"))
    meta = torch.load(work / "checkpoints/epoch_1.pt", map_location="cpu", weights_only=True)["meta"]
    exported = sorted(str(t) for t in np.load(work / "results/epoch_1/waymo_preds.npz", allow_pickle=True)["tokens"])
    emit({"phase": "main_path", "path": "dist_train_waymo", "launcher": str(LAUNCHER.relative_to(REPO)),
          "nnodes": 1, "nproc_per_node": 1, "backend": "nccl", "launcher_overrides": ["dataloader.train.batch_size=3",
          "scheduler.max_lr=0.006", "trainer.max_epochs=36"], "overrides": overrides, "launch_seconds": seconds,
          "checkpoints": checkpoints, "checkpoint_meta": meta, "exported_frames": len(exported),
          "foreign_modules": rank["foreign_modules"], "launches": rank["launches"]})
    failures = [f"{k} never launched" for k in KERNELS if not rank["launches"][k]]
    if checkpoints != ["checkpoints/epoch_1.pt"] or meta["epoch"] != 1 or meta["step"] < 1:
        failures.append(f"checkpoints {checkpoints}, meta {meta}")
    if exported != sorted(val_tokens):
        failures.append(f"the export holds {len(exported)} frames, expected the {len(val_tokens)} val frames")
    if rank["foreign_modules"]:
        failures.append(f"the rank loaded {rank['foreign_modules'][:5]}")
    if failures:
        raise AssertionError(f"dist_train_waymo: {failures}")
    return rank["launches"]


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_ranks(mode: str, spec_dir: Path, world: int) -> list:
    """``world`` processes of this script in ``mode`` on ``spec_dir``, with
    the environment torchrun would give them (one free local port)."""
    import os

    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        with open(spec_dir / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), mode, str(spec_dir)],
                                          env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def wait_ranks(procs: list, logs: list, timeout_s: float, what: str) -> None:
    """Wait for every process; once one fails, or at ``timeout_s`` (a hung
    collective), kill the rest.  Raise with the logs' tails unless each
    exited 0."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        codes = [p.poll() for p in procs]
        if None not in codes or any(c not in (None, 0) for c in codes):
            break
        time.sleep(0.2)
    hung = [p.pid for p in procs if p.poll() is None]
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    if hung or any(p.returncode for p in procs):
        tails = "\n".join(Path(f).read_text()[-4000:] for f in logs if Path(f).exists())
        raise AssertionError(f"{what}: {'hung and killed' if hung else 'failed'}, exit codes "
                             f"{[p.returncode for p in procs]}\n{tails}")


def ddp_worker(spec_dir: str) -> None:
    """One rank of ``ddp_paths`` (run as ``chip_smoke.py ddp-worker DIR``):
    joins the group of its environment, then, with the spec's
    ``f32_reference``, one f32 step of the seed-0 flagship on its share of
    the first batch, and ``bf16_steps`` timed bf16 steps on its shares of
    the next batches, every step through ``train_state.train_step``;
    writes ``rank{r}.pt``: the f32 step's loss, gradient norm and state,
    the step times, each gradient all-reduce's bytes and ms (CUDA
    synchronised), every all-reduce of a step (the gradients', each synced
    BatchNorm's forward and backward, the loss normalisers) with the host
    time spent in them, peak memory and the kernels' launches."""
    sys.path.insert(0, str(REPO))
    from pillarnext_tpu_torch import parallel
    from pillarnext_tpu_torch.train.train_state import split_batch, train_step
    from pillarnext_tpu_torch.train.trainer import batch_to_device
    from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer

    spec_dir = Path(spec_dir)
    spec = torch.load(spec_dir / "spec.pt", weights_only=False)
    device = parallel.init_from_env(spec["backend"], spec["device"], timeout_s=DDP_TIMEOUT_S)
    rank, world = parallel.rank(), parallel.world_size()
    cfg, batches = spec["cfg"], spec["batches"]
    grad_reduces, reduces = [], {"calls": 0, "host_ms": 0.0}
    flat_reduce, all_reduce = parallel.all_reduce_, torch.distributed.all_reduce

    def timed_flat(tensors, op=torch.distributed.ReduceOp.SUM):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flat_reduce(tensors, op)
        torch.cuda.synchronize()
        grad_reduces.append({"bytes": 4 * sum(t.numel() for t in tensors),
                             "ms": (time.perf_counter() - t0) * 1e3})

    def counted(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return all_reduce(*args, **kwargs)
        finally:
            reduces["calls"] += 1
            reduces["host_ms"] += (time.perf_counter() - t0) * 1e3

    parallel.all_reduce_, torch.distributed.all_reduce = timed_flat, counted
    counters = kernel_counters()
    for k in counters:
        k.launches = 0
    out = {"rank": rank, "world_size": world, "backend": spec["backend"], "device": str(device)}

    def step(model, opt, batch):
        local = batch_to_device(split_batch(batch, world)[rank], device)
        parallel.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scalars, _ = train_step(model, opt, local)
        torch.cuda.synchronize()
        return scalars, (time.perf_counter() - t0) * 1e3

    if spec["f32_reference"]:
        model = build_model(dict(cfg["model"], dtype="float32"), device=device,
                            generator=torch.Generator().manual_seed(0), train=True)
        opt, _ = build_optimizer(cfg, 10, list(model.parameters()))
        scalars, _ = step(model, opt, batches[0])
        out["f32"] = {"loss": float(scalars["loss"]), "grad_norm": float(scalars["grad_norm"]),
                      "state": {k: v.cpu() for k, v in model.state_dict().items()}}
        del model, opt, scalars
        torch.cuda.empty_cache()
    model = build_model(cfg["model"], device=device, generator=torch.Generator().manual_seed(0), train=True)
    opt, _ = build_optimizer(cfg, 10, list(model.parameters()))
    torch.cuda.reset_peak_memory_stats()
    bf16 = []
    for b in batches[1:1 + spec["bf16_steps"]]:
        before = dict(reduces)
        bf16.append((*step(model, opt, b), {k: reduces[k] - before[k] for k in reduces}))
    out.update(
        step_ms=[ms for _, ms, _ in bf16], losses=[float(sc["loss"]) for sc, _, _ in bf16],
        grad_all_reduces=grad_reduces, all_reduces_by_step=[r for _, _, r in bf16],
        local_batch=int(batches[0]["points"].shape[0]) // world,
        max_memory_allocated_mb=torch.cuda.max_memory_allocated() / 2**20,
        launches={k.__name__: k.launches for k in counters})
    torch.save(out, spec_dir / f"rank{rank}.pt")
    parallel.barrier()
    parallel.shutdown()


def ddp_paths(cfg, batches, device) -> tuple[dict, dict]:
    """Data-parallel training of the flagship at full width through the
    port's ``parallel`` layer, in processes of their own:

    - ``ddp_train``: two ranks on the one card over gloo (gloo all-reduces
      CUDA tensors and lets ranks share a card; NCCL refuses two ranks on
      one card), B = 2 a rank.  The f32 step on the 4 samples of the first
      batch, split between the ranks, is held against this process's
      1-process B = 4 step from the same seed-0 weights with JAX's own
      multi-device bars (tests/test_training.py): loss 1e-5 relative,
      gradient norm 1e-2, BN running statistics 1e-4, parameters after
      AdamW within 2.5 lr0, the two ranks' states the same bits.  Then
      ``DDP_BF16_STEPS`` timed bf16 steps a rank.  Two ranks on one card
      share it: their step time is not a scaling figure;
    - ``ddp_nccl``: one rank over NCCL, three bf16 steps at B = 4 through
      the same code, so that NCCL's collectives run on the card.

    Each fails unless every rank exits 0 within ``DDP_TIMEOUT_S`` and
    kernels 2 and 3 launched; returns each path's launches, summed over
    its ranks."""
    from pillarnext_tpu_torch.train.train_state import train_step
    from pillarnext_tpu_torch.train.trainer import batch_to_device
    from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer

    model = build_model(dict(cfg["model"], dtype="float32"), device=device,
                        generator=torch.Generator().manual_seed(0), train=True)
    opt, _ = build_optimizer(cfg, 10, list(model.parameters()))
    scalars, _ = train_step(model, opt, batch_to_device(batches[0], device))
    ref = {"loss": float(scalars["loss"]), "grad_norm": float(scalars["grad_norm"]),
           "state": {k: v.cpu() for k, v in model.state_dict().items()}, "lr0": opt.schedule(0)}
    n_params = sum(p.numel() for p in model.parameters())
    del model, opt, scalars
    torch.cuda.empty_cache()

    launches = []
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        for path, backend, rank_device, world, f32, steps in (
            ("ddp_train", "gloo", "cuda:0", 2, True, DDP_BF16_STEPS),
            ("ddp_nccl", "nccl", None, 1, False, 3),
        ):
            spec_dir = Path(tmp) / path
            spec_dir.mkdir()
            torch.save({"cfg": cfg, "batches": batches[:1 + steps], "backend": backend, "device": rank_device,
                        "f32_reference": f32, "bf16_steps": steps}, spec_dir / "spec.pt")
            t0 = time.perf_counter()
            procs = spawn_ranks("ddp-worker", spec_dir, world)
            wait_ranks(procs, [spec_dir / f"rank{r}.log" for r in range(world)], DDP_TIMEOUT_S, path)
            wall_s = time.perf_counter() - t0
            ranks = [torch.load(spec_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]
            summed = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
            rec = {"phase": "main_path", "path": path, "backend": backend, "ranks": world,
                   "cards": torch.cuda.device_count(), "wall_seconds": wall_s, "parameters": n_params,
                   "per_rank": [{k: r[k] for k in ("device", "local_batch", "step_ms", "losses",
                                                   "grad_all_reduces", "all_reduces_by_step",
                                                   "max_memory_allocated_mb", "launches")} for r in ranks],
                   "step_ms_median": [statistics.median(r["step_ms"]) for r in ranks],
                   "step_ms_median_after_first": [statistics.median(r["step_ms"][1:]) for r in ranks],
                   "grad_all_reduce_ms_median_after_first": [
                       statistics.median(c["ms"] for c in r["grad_all_reduces"][-(steps - 1):]) for r in ranks],
                   "grad_all_reduce_bytes": ranks[0]["grad_all_reduces"][-1]["bytes"], "launches": summed}
            failures = [f"{k} never launched" for k in KERNELS[1:] if not summed[k]]
            failures += [f"rank {r['rank']} losses {r['losses']}" for r in ranks
                         if not all(math.isfinite(v) for v in r["losses"])]
            if f32:
                got = [r["f32"] for r in ranks]
                lr0 = ref["lr0"]
                stats = [k for k in ref["state"] if k.endswith(("running_mean", "running_var"))]
                params = [k for k in ref["state"] if k not in stats]
                bn_err = max(float(((got[0]["state"][k] - ref["state"][k]).abs()
                                    - 1e-4 * ref["state"][k].abs()).max()) for k in stats)
                param_err = max(float((got[0]["state"][k] - ref["state"][k]).abs().max()) for k in params)
                rec["f32_vs_one_process"] = {
                    "loss": [g["loss"] for g in got], "loss_one_process": ref["loss"],
                    "loss_rel": abs(got[0]["loss"] - ref["loss"]) / abs(ref["loss"]),
                    "grad_norm": [g["grad_norm"] for g in got], "grad_norm_one_process": ref["grad_norm"],
                    "grad_norm_rel": abs(got[0]["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
                    "bn_statistics_excess_over_1e-4": bn_err, "param_max_abs_diff": param_err,
                    "param_bar": 2.5 * lr0,
                    "ranks_same_bits": all(torch.equal(got[0]["state"][k], got[1]["state"][k])
                                           for k in ref["state"]),
                    "bars": "loss 1e-5 rel, grad norm 1e-2 rel, BN statistics 1e-4 (rel + abs), "
                            "parameters 2.5 lr0 abs (JAX's multi-device bars)"}
                cmp = rec["f32_vs_one_process"]
                if cmp["loss_rel"] > 1e-5 or cmp["grad_norm_rel"] > 1e-2 or bn_err > 1e-4 \
                        or param_err > 2.5 * lr0 or not cmp["ranks_same_bits"]:
                    failures.append(f"2-rank f32 step against 1 process: {cmp}")
                del got
            emit(rec)
            if failures:
                raise AssertionError(f"{path}: {failures}")
            launches.append(summed)
            del ranks
    return tuple(launches)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; a CUDA GPU is required")
    sys.path.insert(0, str(REPO))
    from pillarnext_tpu_torch.data.synthetic import synthetic_batches
    from pillarnext_tpu_torch.ops import kernels, tile_subm
    from pillarnext_tpu_torch.serving import tile_kwargs
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

    # phase 5c: the flagship's other backbone stage modes, served bf16 at
    # batch 1, each against the leading path (f32 backbone output, bf16
    # detections) or its own plain kernels (f32 BEV)
    modes = serving_modes(device)

    # phase 5d: the flagship's head, reader and post-processing options,
    # served bf16 at batch 1 beside the default path (the fused head), each
    # held against its f32 detections where it computes the same function
    options = serving_options(device)

    # phase 5e: voxel18 with the dense volume and the dense 3-D backbone at
    # the config's 40 x 1344 x 1344 grid, bf16, batch 1
    dense = voxel_dense_path(device)

    # phase 6: the training main path, bf16, B = 4, through the Trainer
    # (its checkpoint goes to a directory of the checkout that is removed)
    with tempfile.TemporaryDirectory(dir=REPO) as work_dir:
        train_model, train_launches = train_path(cfg, batches, device, work_dir, "train",
                                                 KERNELS[1:])
    del train_model
    torch.cuda.empty_cache()

    # phase 7: f32 train step, kernels vs plain versions; one full-width
    # SubM residual block on a train step's tables, bare against recomputed
    f32_train_kernels_vs_plain(cfg, batches[0], device, "f32_train_kernels_vs_plain")
    recompute_block_check("flagship_stage0_residual", cfg["model"], batches[0], device)
    torch.cuda.empty_cache()

    # phase 7b: the flagship's other backbone stage modes in training, bf16,
    # B = 4, through the Trainer; an f32 tile_stride1 step, kernels vs plain
    train_mode_launches = train_modes(batches, device)

    # phase 7c: the merged heads and the recompute without the
    # save-conv-out policy in training, bf16, B = 4, through the Trainer
    for path, override in OPTION_TRAIN.items():
        with tempfile.TemporaryDirectory(dir=REPO) as work_dir:
            train_model, train_mode_launches[path] = train_path(
                load_experiment(FLAGSHIP, [override]), batches[:MODE_TRAIN_STEPS], device, work_dir, path,
                KERNELS[1:], ops=False)
        del train_model
        torch.cuda.empty_cache()

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
    recompute_block_check("voxel18_stage0_residual", vcfg["model"], vbatches[0], device)
    torch.cuda.empty_cache()

    # phase 8a: voxel18 with the dense volume in training, bf16, B = 2 on a
    # 40 x 672 x 672 grid, through the Trainer
    dcfg = load_experiment(VOXEL18, VOXEL_DENSE_TRAIN)
    dbatches = synthetic_batches(dcfg, VOXEL_DENSE_TRAIN_STEPS, VOXEL_DENSE_TRAIN_BATCH, N_POINTS, seed=0)
    with tempfile.TemporaryDirectory(dir=REPO) as work_dir:
        train_model, dense_train_launches = train_path(dcfg, dbatches, device, work_dir, "train_voxel_dense",
                                                       KERNELS[1:])
    del train_model, dbatches
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
    # Waymo voxel18 at B = 8: what the recompute's memory buys
    wcfg = waymo["serving_waymo_voxel18"]["cfg"]
    t0 = time.perf_counter()
    wbatches = synthetic_batches(wcfg, MODE_TRAIN_STEPS, LARGE_BATCH, N_POINTS, seed=0)
    emit({"phase": "train_data", "config": "train_waymo_voxel18_b8", "batches": len(wbatches),
          "batch_size": LARGE_BATCH, "points_per_scene": N_POINTS, "max_points": int(wcfg["dataloader"]["max_points"]),
          "host_seconds": time.perf_counter() - t0})
    with tempfile.TemporaryDirectory(dir=REPO) as work_dir:
        train_model, train_mode_launches["train_waymo_voxel18_b8"] = train_path(
            wcfg, wbatches, device, work_dir, "train_waymo_voxel18_b8", KERNELS[1:])
    del train_model, wbatches
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
    # cli.test, on a nuScenes-format tree of 300k-point 10-sweep frames;
    # then cli.train under torchrun on 2 ranks
    cli_train_launches, cli_test_launches, ref_launches, cli_ddp_launches = cli_paths(device)

    # phase 8c': the CLIs on a Waymo tree (GT database by the port's tool,
    # NLZ-flagged points): cli.train on Waymo pp18 (2 steps, val_epoch,
    # the export) then cli.test
    cli_waymo_launches, cli_waymo_test_launches, launcher_launches = cli_waymo(device)

    # phase 8d: data-parallel training, 2 ranks over gloo on the card (an
    # f32 step against 1 process, then timed bf16 steps), 1 rank over NCCL
    ddp_launches, nccl_launches = ddp_paths(cfg, batches, device)

    # phases 8e-8f, with voxel18's and MVF's trained parity in processes of
    # their own beside them (their overfits are host-bound): the learning
    # check, the flagship overfits one planted scene and finds its objects
    # (JAX's bar); full-scale parity, the port's f32 detections against its
    # copy of the reference mirror (f32 on the card), random and trained
    # weights, the flagship, voxel18 and MVF at their configs' grids
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        processes = start_parity_processes(Path(tmp))
        try:
            overfit_launches = overfit_flagship(device)
            parity_launches = parity_paths(device, processes)
        finally:
            for proc, _, _ in processes.values():
                if proc.poll() is None:
                    proc.kill()
                proc.wait()

    # phase 8g: the measurement tools at full width: the eval and train
    # breakdowns by stage, the reference mirror against the port, and the
    # host loader against the train path's step
    tool_launches = tool_paths(device, RECORDS["train"]["step_ms_median_after_first"])

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
    # kernel 2's tile gathers in a serving_tile predict at the largest
    # bucket (the full tile grid): the pack, the first halo, the stack-to-dense
    tile_model = modes["serving_tile"]["model"]
    with torch.inference_mode(), captured(tile_subm, "monotone_row_gather") as calls:
        tile_model.predict(points, mask, **tile_kwargs(tile_model, tile_model.reader.capacity,
                                                       tile_model.reader.capacity))
    train_cases += [(name, *calls[i]) for name, i in
                    (("tile_pack", 0), ("tile_halo", 1), ("tile_stack_to_dense", -1))]
    del calls, tile_model
    train_cases += waymo_gathers
    sum_cases += waymo_segs
    del waymo_gathers, waymo_segs
    # kernel 2's densify of the dense voxel volume (B * 40 * 1344^2 rows)
    # and kernel 3's voxel mean in one voxel_dense predict
    dense_gathers, dense_sums = predict_kernel_inputs(dense["model"], *dense["frame"], (), ("voxel_dense_densify",),
                                                      ("voxel_dense_voxel_mean",))
    train_cases += dense_gathers
    sum_cases += dense_sums
    del dense_gathers, dense_sums
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
    # serving path at the reader's largest bucket (profiled last, as above;
    # the stage-mode and option paths trace the card alone)
    profiled = [("serving", model, (points, mask)), ("serving_voxel18", vmodel, (vpoints, vmask))]
    profiled += [(path, serving_model(w["cfg"]["model"], device), frame(w["cfg"]["model"]["reader"]["pc_range"], 0, device))
                 for path, w in waymo.items()]
    profiled += [(path, w.pop("model"), (points, mask)) for path, w in modes.items()]
    profiled += [(path, w.pop("model"), (points, mask)) for path, w in options.items()]
    profiled.append(("voxel_dense", dense.pop("model"), dense.pop("frame")))
    with torch.inference_mode():
        for path, mdl, (p, m) in profiled:
            # a tile backbone at the largest bucket runs the full tile grid, as serving does
            tiles = tile_kwargs(mdl, mdl.reader.capacity, mdl.reader.capacity)
            mdl.predict(p, m, **tiles)

            def reader_and_backbone(mdl=mdl, p=p, m=m, tiles=tiles):
                x = mdl.reader(p, m)
                return x if mdl.backbone is None else mdl.backbone(x, **tiles)

            ops = path not in modes and path not in options
            emit({"phase": "frame_profile", "path": path,
                  "predict": profile_device(lambda: mdl.predict(p, m, **tiles), FRAME_PROFILE_CALLS, ops),
                  "reader_and_backbone": profile_device(reader_and_backbone, FRAME_PROFILE_CALLS, ops)})
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
             "cli_train": cli_train_launches, "cli_test": cli_test_launches,
             "reference_checkpoint": ref_launches, "overfit_flagship": overfit_launches, **parity_launches,
             **tool_launches, "dist_train_waymo": launcher_launches,
             "cli_train_ddp": cli_ddp_launches, "cli_waymo": cli_waymo_launches,
             "cli_waymo_test": cli_waymo_test_launches, "ddp_train": ddp_launches, "ddp_nccl": nccl_launches,
             **{path: w["launches"] for path, w in modes.items()}, **train_mode_launches,
             **{path: w["launches"] for path, w in options.items()}, "voxel_dense": dense["launches"],
             "train_voxel_dense": dense_train_launches}
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
             launches_per_train_step={**{p: by_path["sorted_segment_bcast"][p] / TRAIN_STEPS
                                         for p in ("train", "train_voxel18", *wtrain)},
                                      **{p: n["sorted_segment_bcast"] / MODE_TRAIN_STEPS
                                         for p, n in train_mode_launches.items()},
                                      "train_voxel_dense": dense_train_launches["sorted_segment_bcast"]
                                      / VOXEL_DENSE_TRAIN_STEPS},
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
    emit({"phase_seconds": PHASE_SECONDS, "script_seconds": time.perf_counter() - STARTED})
    print(smi, flush=True)
    emit({"kernels": kernels_line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["ddp-worker"]:
        ddp_worker(sys.argv[2])
    elif sys.argv[1:2] == ["cli-ddp-worker"]:
        cli_ddp_worker(sys.argv[2], sys.argv[3:])
    elif sys.argv[1:2] == ["parity-worker"]:
        parity_worker(sys.argv[2], sys.argv[3])
    else:
        main()
