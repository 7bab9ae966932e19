#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pillarnext_tpu_torch/csrc``, holds
each against its plain PyTorch version at the flagship shapes, then serves
frames of the flagship PillarNeXt-B config (nusc_det_pp18_aspp_iou_sp, full
width, random weights from a seed) through the port's AdaptivePredictor and
checks that the main path launched both kernels.  Every phase prints one
JSON line; the last line is ``{"ok": true, "device": {...}}``.  Any
mismatch raises and the script exits non-zero; without a CUDA device it
exits non-zero before doing anything.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
FLAGSHIP = REPO / "pillarnext_tpu/configs/experiments/nusc_det_pp18_aspp_iou_sp.yaml"
N_POINTS = 200_000
TIMED_RUNS = 25
LATENCY_FRAMES = 10


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


def frame(pc_range, seed: int, device):
    from pillarnext_tpu.utils.synth import lidar_like_points

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


def check_pfn(reader, points, mask, gen, device, records):
    """Kernel 1 vs its plain version on the flagship's decorated points."""
    from pillarnext_tpu_torch.ops.pfn import pfn_two_layer, pfn_two_layer_plain

    df, c0, c1 = reader.num_input_features + 5, reader.num_filters[0] // 2, reader.num_filters[1]
    w0 = torch.randn(df, c0, generator=gen) / df**0.5
    w1 = torch.randn(2 * c0, c1, generator=gen) / (2 * c0) ** 0.5
    bn0 = torch.stack([torch.rand(c0, generator=gen) + 0.5, 0.2 * torch.randn(c0, generator=gen)])
    bn1 = torch.stack([torch.rand(c1, generator=gen) + 0.5, 0.2 * torch.randn(c1, generator=gen)])
    w0, w1, bn0, bn1 = (t.to(device) for t in (w0, w1, bn0, bn1))
    feats16, slot, _, n_pillars, cap = reader.decorate(points, mask)  # bf16 model
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        feats = feats16.to(dtype)
        args = (feats, slot, w0, bn0, w1, bn1, cap)
        got, want = pfn_two_layer(*args), pfn_two_layer_plain(*args)
        torch.cuda.synchronize()
        zero_rows_equal = torch.equal((got == 0).all(1), (want == 0).all(1))
        err = (got.float() - want.float()).abs()
        rec = {
            "phase": "kernel_vs_plain", "kernel": "pfn_two_layer", "dtype": str(dtype),
            "shape": {"points": feats.shape[0], "df": df, "c0": c0, "c1": c1, "cap": cap},
            "occupied_pillars": int(n_pillars),
            "max_points_per_pillar": int(torch.bincount(slot[slot < cap].long()).max()),
            "max_abs_err": float(err.max()), "zero_rows_equal": zero_rows_equal,
            "ms": median_ms(lambda: pfn_two_layer(*args)),
            "plain_ms": median_ms(lambda: pfn_two_layer_plain(*args)),
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
        emit(rec)
        if not (ok and zero_rows_equal):
            raise AssertionError(f"pfn_two_layer disagrees with its plain version: {rec}")
        out[str(dtype)] = rec
    records["pfn_two_layer"] = out["torch.bfloat16"]
    return slot, cap


def check_gather(reader, points, mask, slot, cap, gen, device, records):
    """Kernel 2 vs its plain version, bit-exact, at the main path's shapes."""
    from pillarnext_tpu_torch.ops.compact import invert_slot_map
    from pillarnext_tpu_torch.ops.gather import monotone_row_gather, monotone_row_gather_plain

    _, _, slot_id, _, _ = reader.decorate(points, mask)
    slot_of_dense, _ = invert_slot_map(slot_id, reader.grid.num_pillars)
    cases = [
        ("densify", torch.bfloat16, cap, 64, slot_of_dense),
        ("pfn_back_gather", torch.bfloat16, cap, 32, slot),
        ("cluster_mean_gather", torch.float32, cap, 3, slot),
    ]
    for name, dtype, rows, c, idx in cases:
        table = torch.randn(rows, c, generator=gen).to(device=device, dtype=dtype)
        got = monotone_row_gather(table, idx)
        want = monotone_row_gather_plain(table, idx)
        torch.cuda.synchronize()
        rec = {
            "phase": "kernel_vs_plain", "kernel": "monotone_row_gather", "case": name,
            "dtype": str(dtype), "shape": {"rows": idx.shape[0], "table_rows": rows, "c": c},
            "bit_exact": torch.equal(got, want),
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "ms": median_ms(lambda: monotone_row_gather(table, idx)),
            "plain_ms": median_ms(lambda: monotone_row_gather_plain(table, idx)),
        }
        emit(rec)
        if not rec["bit_exact"]:
            raise AssertionError(f"monotone_row_gather is not bit-exact: {rec}")
        if name == "densify":
            records["monotone_row_gather"] = rec


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

    tel = {}
    with torch.inference_mode():
        sb, reader_ms = timed(lambda: model.reader(points, mask, capacity=capacity, telemetry=tel))
        x, backbone_ms = timed(lambda: model.backbone(sb))
        x, neck_ms = timed(lambda: model.neck(x))
        nms.rotated_nms = timed_nms
        try:
            _, head_ms = timed(lambda: model.head(x, test_cfg=model.post_processing))
        finally:
            nms.rotated_nms = rotated_nms
    return {
        "reader": reader_ms, "backbone": backbone_ms, "neck": neck_ms,
        "head_decode_nms": head_ms, "of_which_nms": sum(nms_ms),
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; a CUDA GPU is required")
    sys.path.insert(0, str(REPO))
    from pillarnext_tpu.utils.config import load_experiment
    from pillarnext_tpu_torch.ops import kernels
    from pillarnext_tpu_torch.ops.gather import monotone_row_gather
    from pillarnext_tpu_torch.ops.pfn import pfn_two_layer
    from pillarnext_tpu_torch.serving import AdaptivePredictor
    from pillarnext_tpu_torch.utils.builders import build_model

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)})

    # phase 2: build both kernels from the checkout's sources
    t0 = time.perf_counter()
    _, build = kernels.library()
    ptxas = [ln.strip() for ln in build["ptxas"].splitlines() if "registers" in ln or "Compiling" in ln]
    emit({"phase": "build", "nvcc_seconds": build["seconds"],
          "wall_seconds": time.perf_counter() - t0, "ptxas": ptxas})

    # phase 3: each kernel vs its plain version at the flagship shapes
    cfg = load_experiment(FLAGSHIP)["model"]
    pc_range = cfg["reader"]["pc_range"]
    gen = torch.Generator().manual_seed(0)
    model = build_model(cfg, device=device, generator=gen)
    points, mask = frame(pc_range, 0, device)
    records: dict = {}
    with torch.inference_mode():
        slot, cap = check_pfn(model.reader, points, mask, gen, device, records)
        check_gather(model.reader, points, mask, slot, cap, gen, device, records)

    # phase 4: the main path, bf16, through the serving entry point
    engine = AdaptivePredictor(model)
    frames = [frame(pc_range, seed, device) for seed in (0, 1, 2)]
    pfn_two_layer.launches = 0
    monotone_row_gather.launches = 0
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
    launches = {"pfn_two_layer": pfn_two_layer.launches,
                "monotone_row_gather": monotone_row_gather.launches}
    emit({"phase": "main_path", "dtype": "bfloat16", "frames": per_frame,
          "buckets": list(engine.buckets), "operating_bucket": engine._operating_bucket(),
          "peak_required": engine.peak_required, "repaired": engine.repaired,
          "latency_ms_median": statistics.median(latencies), "latency_ms": latencies,
          "launches": launches,
          "breakdown_ms": layer_breakdown(model, *frames[0], engine._operating_bucket()),
          "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2**20})
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the main path never launched {name}")

    # phase 5: f32, kernels vs plain versions on the same frame (report only)
    cfg32 = dict(cfg, dtype="float32")
    model32 = build_model(cfg32, device=device, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        a = model32.predict(*frames[0])
        b = model32.predict(*frames[0], plain=True)
    va, vb = a["valid"][0], b["valid"][0]
    ka = torch.cat([a["label_preds"][0][va, None].float(), a["box3d_lidar"][0][va, :3]], 1)
    kb = torch.cat([b["label_preds"][0][vb, None].float(), b["box3d_lidar"][0][vb, :3]], 1)
    if len(ka) and len(kb):
        dist = torch.cdist(ka, kb)  # same label and centre within 1 cm
        matched = int((dist.min(1).values < 1e-2).sum())
    else:
        matched = 0
    emit({"phase": "f32_kernels_vs_plain", "valid_kernels": int(va.sum()),
          "valid_plain": int(vb.sum()),
          "matched_fraction": matched / max(int(va.sum()), int(vb.sum()), 1)})

    kernels_line = [
        {"name": "pfn_two_layer", "route": "cuda",
         "source": "pillarnext_tpu_torch/csrc/pfn.cu",
         "replaces": "pillarnext_tpu/ops/pallas_pfn.py:93",
         "launches": launches["pfn_two_layer"],
         "max_abs_err": records["pfn_two_layer"]["max_abs_err"],
         "ms": records["pfn_two_layer"]["ms"], "plain_ms": records["pfn_two_layer"]["plain_ms"]},
        {"name": "monotone_row_gather", "route": "cuda",
         "source": "pillarnext_tpu_torch/csrc/gather.cu",
         "replaces": "pillarnext_tpu/ops/pallas_gather.py:60",
         "launches": launches["monotone_row_gather"],
         "max_abs_err": records["monotone_row_gather"]["max_abs_err"],
         "ms": records["monotone_row_gather"]["ms"],
         "plain_ms": records["monotone_row_gather"]["plain_ms"]},
    ]
    jax_modules = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    if jax_modules:
        raise AssertionError(f"the port imported JAX: {jax_modules[:5]}")
    emit({"kernels": kernels_line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
