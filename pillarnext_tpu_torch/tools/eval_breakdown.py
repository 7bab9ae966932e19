#!/usr/bin/env python
"""Cumulative per-stage timing of the flagship's eval pipeline.

Counterpart of tools/eval_breakdown.py:47-131.  The served model's own
``extract_feat`` is cut short at eight points (``step_names``): the
reader, + SubM stage 0, + densify, + stages 1, 2 and 3 (masked-dense, the
mask dilated at each strided stage), + the 1x1 mapping, + the ASPP neck.
``prefix`` stops the call where a step ends: a forward hook on the reader,
on each dense stage's last block and on the backbone, a pre-hook on the
first dense block (the densified map, as it enters), and for a SubM stage
``resnet.sparse_stage`` wrapped for the call (its blocks run as
functions, so no module ends the stage).  Each prefix's output is thus an
intermediate of the model's ``extract_feat``, in whatever mode it runs.
The flagship (nusc_det_pp18_aspp_iou_sp, bf16 as its YAML gives it, random
weights from the seed) runs on ``lidar_like_points`` at the reader's
capacity.  For each prefix: the median of ``--reps`` synchronised calls
after one warm-up (cumulative ms) and the delta to the previous prefix,
the device ms of one call (``profiling.device_profile`` over
``DEVICE_CALLS`` calls; host times drift on the card while busy time
holds), and the launches of each ported kernel in one call.

    python -m pillarnext_tpu_torch.tools.eval_breakdown [--batch 1] \\
        [--unmasked] [--points 200000] [--reps 20] [--seed 0] \\
        [--device cuda:N|cpu] [key.path=value ...]

``--unmasked`` runs the dense tail without the mask
(``model.backbone.masked_eval=false``).  It prints one line a prefix and
a JSON record; on the CPU the device figures are null (not measured).
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch

from pillarnext_tpu_torch.models import resnet
from pillarnext_tpu_torch.tools.flagship_parity import CONFIG
from pillarnext_tpu_torch.utils import profiling
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.config import load_experiment
from pillarnext_tpu_torch.utils.synth import lidar_like_points

DEVICE_CALLS = 5  # profiled calls a prefix


def step_names(model) -> list[str]:
    """The prefixes' names: the reader, each stride-1 SubM stage, the
    densify, each dense stage, the 1x1 mapping and the neck."""
    bb = model.backbone
    return ["reader", *(f"+stage{i}" for i in range(bb.n_sparse)), "+densify",
            *(f"+stage{i}" for i in range(bb.n_sparse, len(bb.layer_nums))), "+1x1", "+neck"]


class _Cut(Exception):
    """Raised where the prefix ends; its one argument is that step's
    output."""


def _raise_output(_module, _args, out):
    raise _Cut(out)


def _raise_input(_module, args):
    raise _Cut(args[0])


@contextlib.contextmanager
def _cut_after(model, upto: int):
    """Inside the block, ``model.extract_feat`` raises ``_Cut`` with the
    output of step ``upto`` of ``step_names`` (the last step, the neck,
    needs no cut)."""
    bb = model.backbone
    n, last = bb.n_sparse, len(bb.layer_nums) + 2
    handles, real_stage = [], resnet.sparse_stage
    if upto == 0:
        handles.append(model.reader.register_forward_hook(_raise_output))
    elif upto <= n:
        done = []

        def stage(*args, **kwargs):
            out = real_stage(*args, **kwargs)
            done.append(1)
            if len(done) == upto:
                raise _Cut(out)
            return out

        resnet.sparse_stage = stage
    elif upto == n + 1:
        handles.append(bb.blocks[n][0].register_forward_pre_hook(_raise_input))
    elif upto < last:
        handles.append(bb.blocks[upto - 2][-1].register_forward_hook(_raise_output))
    elif upto == last:
        handles.append(bb.register_forward_hook(_raise_output))
    try:
        yield
    finally:
        resnet.sparse_stage = real_stage
        for h in handles:
            h.remove()


def prefix(model, upto: int, points, mask):
    """The output of the first ``upto + 1`` steps of ``step_names`` on
    (B, N, D) points, from the model's own ``extract_feat`` cut short: the
    reader's SparseBEV; each SubM stage's table rows; the densified (B, C,
    H, W) map; each dense stage's (B, C, H, W) map; the backbone's and the
    neck's (B, H, W, C) output.  Raises unless the model's forward reaches
    the cut (a mode that runs no such step)."""
    if model.training:
        raise ValueError("eval_breakdown cuts an eval model")
    with _cut_after(model, upto):
        try:
            out = model.extract_feat(points, mask)
        except _Cut as cut:
            return cut.args[0]
    if upto != len(step_names(model)) - 1:
        raise ValueError(f"the model's forward never reached step {step_names(model)[upto]!r}")
    return out


def run(batch: int = 1, masked: bool = True, points: int = 200_000, reps: int = 20, seed: int = 0,
        device="cuda:0", overrides=(), log=print) -> dict:
    """The breakdown's record: its settings, the card, and one row a
    prefix (``ms`` cumulative, ``delta_ms``, ``first_ms`` of the warm-up
    call, ``device_ms``, ``launches``)."""
    device = torch.device(device)
    cfg = load_experiment(CONFIG, [*overrides, f"model.backbone.masked_eval={str(masked).lower()}"])["model"]
    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(seed))
    pts, pmask = lidar_like_points(batch, points, cfg["reader"]["pc_range"], seed=seed)
    pts, pmask = torch.from_numpy(pts).to(device), torch.from_numpy(pmask).to(device)
    rec = {"config": CONFIG.name, "dtype": cfg.get("dtype", "bfloat16"), "batch": batch, "masked": masked,
           "points": points, "reps": reps, "device": str(device), "card": profiling.card(device), "rows": []}
    prev = 0.0
    with torch.inference_mode(), model.precision():
        for upto, name in enumerate(step_names(model)):
            def call(upto=upto):
                return prefix(model, upto, pts, pmask)

            _, first = profiling.synced_ms(call, device)
            ms, _ = profiling.median_ms(call, device, reps)
            _, launches = profiling.launches(call)
            row = {"name": name, "ms": ms, "delta_ms": ms - prev, "first_ms": first,
                   "device_ms": profiling.device_ms(call, device, DEVICE_CALLS), "launches": launches}
            rec["rows"].append(row)
            log(f"{name:9s} cum {ms:8.2f} ms (delta {ms - prev:+8.2f}, first {first:.0f} ms, device "
                f"{row['device_ms']} ms) launches {launches}")
            prev = ms
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Cumulative per-stage timing of the flagship's eval pipeline.")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--unmasked", action="store_true", help="the dense tail without the active-set mask")
    ap.add_argument("--points", type=int, default=200_000)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("overrides", nargs="*", help="config overrides key.path=value (+key.path=value adds)")
    args = ap.parse_args(argv)
    rec = run(args.batch, not args.unmasked, args.points, args.reps, args.seed, args.device, args.overrides,
              log=lambda s: print(s, flush=True))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
