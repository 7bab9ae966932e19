#!/usr/bin/env python
"""End-to-end mAP / NDS through the port's CLIs, and what the speed
shortcuts cost in accuracy.

Counterpart of tools/metric_delta.py, with its arguments and defaults:
writes a labelled synthetic nuScenes-format set (planted objects over a
beam-structured background, ``utils/synth.write_synthetic_nusc``), trains
the flagship on it with ``python -m pillarnext_tpu_torch.cli.train`` (the
dataloader, assigner, optimizer and checkpoints of the port), then scores
the last checkpoint with ``python -m pillarnext_tpu_torch.cli.test`` under
two inference configurations:

  exact:    masked_eval=true  approx_topk=false  (spconv's active-set
            semantics and the exact candidate top-k, the reference's)
  shortcut: masked_eval=false approx_topk=true

and writes both mAP / NDS and their delta to ``<root>/metric_delta.json``.
The scorer is the self-contained ``detection_cvpr_2019`` protocol
(data/nuscenes_eval.py).

    python -m pillarnext_tpu_torch.tools.metric_delta [--scenes 48] [--epochs 30] \\
        [--root DIR] [--device cuda:N|cpu] [--extent 50.4] [--points 120000] \\
        [--objects 24] [key.path=value ...]

``--root`` defaults to ``pnx_torch_synth_val`` under the temporary
directory; an existing ``infos_synth.pkl`` there is reused.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

from pillarnext_tpu_torch.utils.synth import write_synthetic_nusc

REPO = Path(__file__).resolve().parents[2]
VARIANTS = {
    "exact": ["model.backbone.masked_eval=true", "model.post_processing.approx_topk=false"],
    "shortcut": ["model.backbone.masked_eval=false", "model.post_processing.approx_topk=true"],
}


def run(cmd: list[str], log: Path) -> None:
    print(f"$ {' '.join(cmd)}\n  (log: {log})", flush=True)
    with open(log, "w") as f:
        p = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=REPO)
    if p.returncode != 0:
        print(open(log).read()[-4000:])
        raise SystemExit(f"command failed: {' '.join(cmd)}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="mAP / NDS of a trained flagship, exact against shortcut.")
    ap.add_argument("--scenes", type=int, default=48)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--root", default=str(Path(tempfile.gettempdir()) / "pnx_torch_synth_val"))
    ap.add_argument("--config", default="pillarnext_tpu/configs/experiments/nusc_det_pp18_aspp_iou_sp.yaml")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--skip-train", action="store_true", help="reuse the checkpoint already in --root/work_dir")
    ap.add_argument("--extent", type=float, default=50.4, help="scene half-extent in metres (shrink for CPU runs)")
    ap.add_argument("--points", type=int, default=120_000)
    ap.add_argument("--objects", type=int, default=24, help="planted objects per scene (shrink with --extent)")
    ap.add_argument("overrides", nargs="*", help="extra config overrides appended to both CLIs")
    args = ap.parse_args(argv)

    root = Path(args.root).resolve()
    work = root / "work_dir"
    if not (root / "infos_synth.pkl").exists():
        print(f"writing {args.scenes} synthetic scenes to {root}", flush=True)
        e = args.extent
        write_synthetic_nusc(root, args.scenes, n_points=args.points, pc_range=(-e, -e, -5.0, e, e, 3.0),
                             n_objects=args.objects)

    common = [
        f"data.train_dataset.root_path={root}",
        "data.train_dataset.info_path=infos_synth.pkl",
        "data.val_dataset.info_path=infos_synth.pkl",
        "data.train_dataset.resampling=false",
        "+data.train_dataset.use_gt_sampling=false",
        f"dataloader.train.batch_size={args.batch}",
        f"dataloader.val.batch_size={args.batch}",
        "dataloader.train.num_workers=2",
        "dataloader.val.num_workers=2",
        f"trainer.max_epochs={args.epochs}",
        "trainer.eval_every_nepochs=1000",  # scored separately below
        f"dataloader.max_points={max(args.points, 150_000)}",
        *args.overrides,
    ]
    cli = [sys.executable, "-m"]
    if not args.skip_train:
        run(cli + ["pillarnext_tpu_torch.cli.train", "--config", args.config, "--work-dir", str(work),
                   "--device", args.device, *common], root / "train.log")

    ckpts = sorted((work / "checkpoints").glob("epoch_*.pt"), key=lambda p: int(p.stem.split("_")[1]))
    if not ckpts:
        raise SystemExit(f"no checkpoints under {work}")
    print(f"scoring checkpoint {ckpts[-1]}", flush=True)

    metrics = {}
    for name, overrides in VARIANTS.items():
        vw = root / f"eval_{name}"
        run(cli + ["pillarnext_tpu_torch.cli.test", "--config", args.config, "--checkpoint", str(ckpts[-1]),
                   "--work-dir", str(vw), "--device", args.device, *common, *overrides],
            root / f"eval_{name}.log")
        with open(sorted(vw.glob("results/epoch_*/metrics_summary.json"))[-1]) as f:
            m = json.load(f)
        metrics[name] = {"mAP": m["mean_ap"], "NDS": m["nd_score"]}
        print(f"{name}: mAP {m['mean_ap']:.4f}  NDS {m['nd_score']:.4f}", flush=True)

    out = {"exact": metrics["exact"], "shortcut": metrics["shortcut"],
           "delta": {k: metrics["shortcut"][k] - metrics["exact"][k] for k in ("mAP", "NDS")}}
    print(json.dumps(out, indent=2))
    with open(root / "metric_delta.json", "w") as f:
        json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
