#!/usr/bin/env python
"""The reference pipeline's mirror against the port, on one device.

Counterpart of tools/baseline_probe.py:41-146: the same workload through
both pipelines on the same hardware, which gives an implementation ratio
that rests on no outside figure.  The flagship (nusc_det_pp18_aspp_iou_sp
at its 1344^2 grid, 6 task groups) in f32 on one 200k-point frame of
``lidar_like_points``, batch 1, end to end:

  mirror: the port's copy of the reference mirror (``reference_mirror``:
      torch.unique voxelization, PFN, SubM-masked dense backbone, ASPP,
      CenterHead, the reference decode and the C++ oracle's rotated NMS),
      built and weighted as ``flagship_parity`` builds it (seeded init, BN
      statistics randomised), in full f32;
  port:   ``AdaptivePredictor.predict`` of the port's f32 eval model with
      the same weights, detections copied to the host.

Before any timing both must compute the same function on the frame:
``parity.compare_detections`` at the random-weight bar (85% matched with
their labels, box delta under 0.5, score delta under 2e-3), which raises
on a miss.  Then the best of ``--runs`` of each (after the check's call),
their ratio, and the card's name and power limit.

    python -m pillarnext_tpu_torch.tools.baseline_probe [--runs 3] \\
        [--points 200000] [--seed 0] [--device cuda:N|cpu] [--out FILE] \\
        [key.path=value ...]

It prints the JSON record and writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from pillarnext_tpu_torch.serving import AdaptivePredictor
from pillarnext_tpu_torch.tools import flagship_parity, parity
from pillarnext_tpu_torch.utils import profiling
from pillarnext_tpu_torch.utils.config import load_experiment


def run(runs: int = 3, points: int = 200_000, seed: int = 0, device="cuda:0", overrides=(), log=print) -> dict:
    """The probe's record: the check's figures (``check``), each side's
    times and best (``mirror_ms``, ``port_ms``), ``mirror_over_port`` and
    the card.  Raises before timing when the detections miss the bar."""
    device = torch.device(device)
    mcfg = load_experiment(flagship_parity.CONFIG, [*overrides, *flagship_parity.EVAL])["model"]
    model, tmodel = flagship_parity.random_pair(mcfg, seed, device)
    tmodel.to(device)
    pts, mask = flagship_parity.random_frame(mcfg, points, seed, device)
    inputs = flagship_parity.mirror_inputs(pts, mask, device)
    engine = AdaptivePredictor(model)

    def mirror():
        return parity.mirror_predict(tmodel, inputs, mcfg, device, log=lambda s: None)[0]

    def port():
        with torch.inference_mode():
            return parity.ragged(engine.predict(pts, mask))

    check = parity.compare_detections(mirror(), port(), parity.decode_cfg(mcfg), overfit=False, log=log)
    mirror_all = [profiling.synced_ms(mirror, device)[1] for _ in range(runs)]
    port_all = [profiling.synced_ms(port, device)[1] for _ in range(runs)]
    rec = {"workload": f"{flagship_parity.CONFIG.stem} f32, {mcfg['reader']['pc_range']} at "
                       f"{mcfg['reader']['voxel_size'][:2]} m, {int(mask.sum())} points, batch 1, end to end",
           "device": str(device), "card": profiling.card(device), "runs": runs, "check": check,
           "mirror_ms": min(mirror_all), "port_ms": min(port_all), "mirror_ms_all": mirror_all,
           "port_ms_all": port_all, "port_repairs": engine.repaired}
    rec["mirror_over_port"] = rec["mirror_ms"] / rec["port_ms"]
    log(f"mirror {rec['mirror_ms']:.1f} ms, port {rec['port_ms']:.1f} ms (best of {runs}): "
        f"mirror / port = {rec['mirror_over_port']:.2f} on {rec['card'] or device}")
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="The reference mirror against the port on one device.")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--points", type=int, default=200_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None, help="also write the JSON record here")
    ap.add_argument("overrides", nargs="*", help="config overrides key.path=value (+key.path=value adds)")
    args = ap.parse_args(argv)
    rec = run(args.runs, args.points, args.seed, args.device, args.overrides, log=lambda s: print(s, flush=True))
    text = json.dumps(rec)
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return rec


if __name__ == "__main__":
    main()
