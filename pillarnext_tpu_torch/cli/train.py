#!/usr/bin/env python
"""Training CLI.

Counterpart of pillarnext_tpu/cli/train.py:77-165 (capability parity with
the reference tools/train.py:16-83): config-driven model / data /
optimizer assembly, resume or load_from or automatic resume, then
``Trainer.fit()``, which evaluates every ``trainer.eval_every_nepochs``
epochs.  Usage:

    python -m pillarnext_tpu_torch.cli.train \\
        --config pillarnext_tpu/configs/experiments/<exp>.yaml \\
        [key.path=value ...] [--work-dir DIR] [--resume-from CKPT] \\
        [--load-from CKPT] [--profile LOGDIR] [--device cuda:0|cpu]
    (or: pnx-torch-train ...)

The model trains on one card (``--device``, default ``cuda:0``; without a
card that raises: pass ``--device cpu`` to run on the CPU).  The train model
runs the config's ``reader.train_pillar_capacity`` and the eval model the
serving capacity, sharing weights through ``val_epoch``.  Distributed
training is not ported: under ``WORLD_SIZE > 1`` the CLI raises rather
than train one process's shard alone.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from pillarnext_tpu_torch.data.loader import build_dataloader
from pillarnext_tpu_torch.train.trainer import Trainer
from pillarnext_tpu_torch.utils import builders
from pillarnext_tpu_torch.utils.config import load_experiment


def setup_logging() -> logging.Logger:
    """The port's logger at INFO with its own handler."""
    log = logging.getLogger("pillarnext_tpu_torch")
    log.setLevel(logging.INFO)
    if not log.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
        log.addHandler(h)
    log.propagate = False
    return log


def single_process_device(device: str) -> torch.device:
    """``device`` resolved (a CUDA device without a card raises); raises
    under ``WORLD_SIZE > 1``."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("distributed is not ported yet, see ROADMAP")
    return builders.resolve_device(device)


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", required=True)
    p.add_argument("--work-dir", default="work_dir")
    p.add_argument("--device", default="cuda:0",
                   help="the card to run on (default cuda:0); cpu runs on the CPU")
    p.add_argument("overrides", nargs="*", help="config overrides key.path=value (+key.path=value adds)")
    return p


def main(argv=None) -> Trainer:
    p = parser("Train a PillarNeXt experiment with the PyTorch / CUDA port.")
    p.add_argument("--resume-from", default=None)
    p.add_argument("--load-from", default=None)
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="write a torch.profiler trace of a few steady-state train steps")
    args = p.parse_args(argv)
    device = single_process_device(args.device)
    log = setup_logging()
    cfg = load_experiment(args.config, args.overrides)
    log.info("device: %s", device)

    train_ds = builders.build_dataset(cfg["data"]["train_dataset"])
    val_ds = builders.build_dataset(cfg["data"]["val_dataset"])
    dl_cfg = cfg["dataloader"]
    max_points = int(dl_cfg.get("max_points", 300000))
    accum = int(cfg["trainer"].get("accum_steps", 1))
    batch_size = int(dl_cfg["train"]["batch_size"]) * accum
    train_loader = build_dataloader(train_ds, batch_size, max_points, shuffle=True,
                                    num_workers=int(dl_cfg["train"]["num_workers"]))
    val_loader = build_dataloader(val_ds, batch_size, max_points, shuffle=False,
                                  num_workers=int(dl_cfg["val"]["num_workers"]))

    # the train model may run a tighter table capacity than serving
    # (reader.train_pillar_capacity); parameter shapes are the same, so the
    # eval model at the full capacity takes its weights in val_epoch
    model = builders.build_model(cfg["model"], device=device, generator=torch.Generator().manual_seed(0),
                                 train=True)
    eval_model = builders.build_model(cfg["model"], device=device)
    opt, schedule = builders.build_optimizer(cfg, len(train_loader), list(model.parameters()))

    trainer = Trainer(
        model,
        train_loader,
        opt,
        schedule,
        max_epochs=int(cfg["trainer"]["max_epochs"]),
        log_every_niters=int(cfg["trainer"].get("log_every_niters", 50)),
        work_dir=args.work_dir,
        accum_steps=accum,
        device=device,
        logger_=log,
        val_dataloader=val_loader,
        eval_every_nepochs=int(cfg["trainer"].get("eval_every_nepochs", 1)),
        profile_dir=args.profile,
        eval_model=eval_model,
        eval_model_cfg=cfg["model"],
        eval_overflow=str(cfg["trainer"].get("eval_overflow", "repair")),
    )
    if args.resume_from:
        trainer.resume(args.resume_from)
    elif args.load_from:
        trainer.load_weights(args.load_from)
    else:
        trainer.auto_resume()

    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
