#!/usr/bin/env python
"""Per-stage train (forward + backward) timing of the flagship by
truncated models.

Counterpart of tools/train_breakdown.py:42-110.  Each row builds the
flagship (nusc_det_pp18_aspp_iou_sp, bf16 as its YAML gives it, random
weights from the seed) in train mode with its backbone cut to k stages
(``layer_nums``, ``ds_layer_strides`` and ``ds_num_filters``) and without
its neck until the last row (``truncated_config``): the reader alone, then
+ stage 0 ... + stage 3, + the neck.  A row's loss is ``sum(out.float() **
2)`` of ``model.reader`` (the first row: its compact table) or
``model.extract_feat`` (the all-sparse train path, each sparse block
recomputed in the backward as JAX remats it), and its step the loss's
backward into every parameter.  On B scenes of ``lidar_like_points``: one
warm-up step, then ``--steps`` steps, each forward and backward timed
apart between synchronisations (the medians, cumulative, and the deltas
to the previous row), the device ms of one forward and of one whole step
(``profiling.device_profile`` over ``DEVICE_CALLS`` calls each; the
backward's is their difference), peak memory, and each ported kernel's launches in
one step.  A last row runs the full model with
``remat_save_conv_out=false`` (each replay recomputes its sparse convs):
beside the ``+neck`` row it bounds what keeping the convs' outputs saves
in the replay.  The replay itself cannot be switched off (JAX has no
switch), so each backward delta includes the replay of its stage.

    python -m pillarnext_tpu_torch.tools.train_breakdown [--batch 4] \\
        [--points 200000] [--steps 5] [--seed 0] [--device cuda:N|cpu] \\
        [key.path=value ...]

It prints one line a row and a JSON record; on the CPU the device figures
are null (not measured).
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from pillarnext_tpu_torch.tools.flagship_parity import CONFIG
from pillarnext_tpu_torch.utils import profiling
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.config import load_experiment
from pillarnext_tpu_torch.utils.synth import lidar_like_points

DEVICE_CALLS = 3  # profiled forwards and steps a row
# (name, stages kept, with the neck, the reader alone, overrides of the row)
ROWS = (
    ("reader", 1, False, True, ()),
    ("+stage0", 1, False, False, ()),
    ("+stage1", 2, False, False, ()),
    ("+stage2", 3, False, False, ()),
    ("+stage3", 4, False, False, ()),
    ("+neck", 4, True, False, ()),
    ("+neck, remat_save_conv_out=false", 4, True, False, ("+model.backbone.remat_save_conv_out=false",)),
)


def truncated_config(model_cfg: dict, stages: int, with_neck: bool) -> dict:
    """The model config with its backbone cut to its first ``stages``
    stages and its neck dropped unless ``with_neck`` (the head stays, and
    no row runs it)."""
    cfg = {**model_cfg, "backbone": dict(model_cfg["backbone"])}
    for key in ("layer_nums", "ds_layer_strides", "ds_num_filters"):
        cfg["backbone"][key] = list(model_cfg["backbone"][key])[:stages]
    if not with_neck:
        cfg.pop("neck", None)
    return cfg


def forward_loss(model, points, mask, reader_only: bool) -> torch.Tensor:
    """``sum(out.float() ** 2)`` of the reader's compact table or of
    ``extract_feat``'s features, under the model's precision."""
    with model.precision():
        if reader_only:
            out = model.reader(points, mask).table
        else:
            out = model.extract_feat(points, mask)
        return (out.float() ** 2).sum()


def grad_abs_sum(model) -> float:
    """The sum of |gradient| over every parameter (none: zero)."""
    return float(sum(p.grad.double().abs().sum() for p in model.parameters() if p.grad is not None))


def step(model, points, mask, reader_only: bool, device) -> dict:
    """One timed forward and backward: the loss, the forward's and the
    backward's fenced ms."""
    for p in model.parameters():
        p.grad = None
    loss, fwd = profiling.synced_ms(lambda: forward_loss(model, points, mask, reader_only), device)
    with model.precision():
        _, bwd = profiling.synced_ms(loss.backward, device)
    return {"loss": float(loss.detach()), "forward_ms": fwd, "backward_ms": bwd}


def device_split(model, points, mask, reader_only: bool, device, calls: int) -> tuple:
    """The device ms of one step's forward and of its backward: the
    forward's and the whole step's ``profiling.device_ms`` over ``calls``
    calls each, the backward the difference; (None, None) on the CPU."""
    fwd = profiling.device_ms(lambda: forward_loss(model, points, mask, reader_only), device, calls)
    if fwd is None:
        return None, None
    return fwd, profiling.device_ms(lambda: step(model, points, mask, reader_only, device), device, calls) - fwd


def run(batch: int = 4, points: int = 200_000, steps: int = 5, seed: int = 0, device="cuda:0", overrides=(),
        log=print) -> dict:
    """The breakdown's record: its settings, the card, and one record a
    row (medians of forward, backward and step ms, cumulative, their
    deltas to the row before, device ms of each, peak MB, launches in
    one step, the last loss and sum of |gradients|)."""
    device = torch.device(device)
    base = load_experiment(CONFIG, list(overrides))["model"]
    pts, pmask = lidar_like_points(batch, points, base["reader"]["pc_range"], seed=seed)
    pts, pmask = torch.from_numpy(pts).to(device), torch.from_numpy(pmask).to(device)
    rec = {"config": CONFIG.name, "dtype": base.get("dtype", "bfloat16"), "batch": batch, "points": points,
           "steps": steps, "device": str(device), "card": profiling.card(device), "rows": []}
    prev = {"forward_ms": 0.0, "backward_ms": 0.0, "step_ms": 0.0}
    for name, stages, with_neck, reader_only, row_overrides in ROWS:
        mcfg = load_experiment(CONFIG, [*overrides, *row_overrides])["model"]
        model = build_model(truncated_config(mcfg, stages, with_neck), device=device,
                            generator=torch.Generator().manual_seed(seed), train=True)
        step(model, pts, pmask, reader_only, device)  # warm-up
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        timed = [step(model, pts, pmask, reader_only, device) for _ in range(steps)]
        peak = torch.cuda.max_memory_allocated(device) / 2**20 if device.type == "cuda" else None
        row = {"name": name, "stages": stages, "neck": with_neck, "overrides": list(row_overrides)}
        for key in ("forward_ms", "backward_ms"):
            row[key] = statistics.median(t[key] for t in timed)
        row["step_ms"] = statistics.median(t["forward_ms"] + t["backward_ms"] for t in timed)
        if not row_overrides:
            row.update({f"delta_{k}": row[k] - prev[k] for k in prev})
            prev = {k: row[k] for k in prev}
        row["device_forward_ms"], row["device_backward_ms"] = device_split(model, pts, pmask, reader_only, device,
                                                                            DEVICE_CALLS)
        _, row["launches"] = profiling.launches(lambda: step(model, pts, pmask, reader_only, device))
        row.update({"peak_mb": peak, "loss": timed[-1]["loss"], "grad_abs_sum": grad_abs_sum(model)})
        rec["rows"].append(row)
        log(f"{name:34s} step {row['step_ms']:8.1f} ms (forward {row['forward_ms']:.1f}, backward "
            f"{row['backward_ms']:.1f}; device {row['device_forward_ms']} / {row['device_backward_ms']}), "
            f"peak {peak} MB, launches {row['launches']}")
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Per-stage train timing of the flagship by truncated models.")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--points", type=int, default=200_000)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("overrides", nargs="*", help="config overrides key.path=value (+key.path=value adds)")
    args = ap.parse_args(argv)
    rec = run(args.batch, args.points, args.steps, args.seed, args.device, args.overrides,
              log=lambda s: print(s, flush=True))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
