#!/usr/bin/env python
"""Evaluation CLI.

Counterpart of pillarnext_tpu/cli/test.py:15-66 (the reference
tools/test.py:16-70): build the val dataset and the model, load a
checkpoint strictly, run one val epoch and score it into
``<work-dir>/results/epoch_<n>``.

    python -m pillarnext_tpu_torch.cli.test --config <experiment.yaml> \\
        --checkpoint <work_dir>/checkpoints/epoch_<n>.pt \\
        [key.path=value ...] [--work-dir DIR] [--device cuda:N|cpu] \\
        [--dist-backend nccl|gloo]
    (or: pnx-torch-test ...)

Under torchrun every rank scores its shard of the val set
(``dataloader.val.batch_size`` samples a batch, the last one possibly
short: every sample is kept) and rank 0 scores the union of their
detections; devices and backends as cli/train.py.
"""

from __future__ import annotations

from pillarnext_tpu_torch import parallel
from pillarnext_tpu_torch.cli.train import parser, setup_logging
from pillarnext_tpu_torch.data.loader import build_dataloader
from pillarnext_tpu_torch.train.trainer import Trainer
from pillarnext_tpu_torch.utils import builders
from pillarnext_tpu_torch.utils.config import load_experiment


def main(argv=None) -> Trainer:
    p = parser("Score a checkpoint of a PillarNeXt experiment with the PyTorch / CUDA port.")
    p.add_argument("--checkpoint", required=True)
    args = p.parse_args(argv)
    device = parallel.init_from_env(args.dist_backend, args.device)
    log = setup_logging(parallel.rank())
    cfg = load_experiment(args.config, args.overrides)

    val_ds = builders.build_dataset(cfg["data"]["val_dataset"])
    dl_cfg = cfg["dataloader"]
    val_loader = build_dataloader(val_ds, int(dl_cfg["val"]["batch_size"]),
                                  int(dl_cfg.get("max_points", 300000)), shuffle=False,
                                  num_workers=int(dl_cfg["val"]["num_workers"]), drop_last=False)

    model = builders.build_model(cfg["model"], device=device)
    opt, schedule = builders.build_optimizer(cfg, 1, list(model.parameters()))
    trainer = Trainer(
        model,
        optimizer=opt,
        lr_schedule=schedule,
        work_dir=args.work_dir,
        device=device,
        logger_=log,
        val_dataloader=val_loader,
        eval_model_cfg=cfg["model"],
        eval_overflow=str(cfg.get("trainer", {}).get("eval_overflow", "repair")),
    )
    trainer.resume(args.checkpoint)
    trainer.val_epoch()
    return trainer


if __name__ == "__main__":
    main()
    parallel.shutdown()
