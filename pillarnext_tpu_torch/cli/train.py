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
        [--load-from CKPT] [--profile LOGDIR] [--device cuda:N|cpu] \\
        [--dist-backend nccl|gloo]
    (or: pnx-torch-train ...)

    torchrun --nproc_per_node=N -m pillarnext_tpu_torch.cli.train --config ...

One process trains on one card: ``--device``, default ``cuda:{LOCAL_RANK}``
(``cuda:0`` alone); without a card that raises, pass ``--device cpu`` to
run on the CPU.  Started by torchrun (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` / ``MASTER_PORT`` in the environment) the processes form
one group over ``--dist-backend`` (``nccl`` by default, as the reference's
tools/train.py:30-31; ``gloo`` where two ranks share a card, which NCCL
refuses, or run on the CPU) and train data-parallel with JAX's
global-batch semantics (parallel/): each rank loads its shard of
``dataloader.train.batch_size x trainer.accum_steps`` samples a step (JAX's
``global_batch // process_count``), the schedule counts the sharded steps
per epoch, BatchNorm statistics span the global batch where the config
sets ``sync_batchnorm``, and rank 0 logs, writes the checkpoints and scores
the union of every rank's val detections.  ``WORLD_SIZE > 1`` without a
group that forms raises: no rank trains its shard alone.  The train model
runs the config's ``reader.train_pillar_capacity`` and the eval model the
serving capacity, sharing weights through ``val_epoch``; the val loader
keeps every sample (data/loader.py).
"""

from __future__ import annotations

import argparse
import logging

import torch

from pillarnext_tpu_torch import parallel
from pillarnext_tpu_torch.data.loader import build_dataloader
from pillarnext_tpu_torch.train.trainer import Trainer
from pillarnext_tpu_torch.utils import builders
from pillarnext_tpu_torch.utils.config import load_experiment


def setup_logging(rank: int) -> logging.Logger:
    """The port's logger with its own handler: INFO on rank 0, WARNING on
    the other ranks."""
    log = logging.getLogger("pillarnext_tpu_torch")
    log.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    if not log.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
        log.addHandler(h)
    log.propagate = False
    return log


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", required=True)
    p.add_argument("--work-dir", default="work_dir")
    p.add_argument("--device", default=None,
                   help="this process's card (default cuda:{LOCAL_RANK}, cuda:0 alone); cpu runs on the CPU")
    p.add_argument("--dist-backend", choices=parallel.BACKENDS, default="nccl",
                   help="the process group's backend under torchrun (default nccl, one card a rank; "
                        "gloo lets ranks share a card or run on the CPU)")
    p.add_argument("overrides", nargs="*", help="config overrides key.path=value (+key.path=value adds)")
    return p


def main(argv=None) -> Trainer:
    p = parser("Train a PillarNeXt experiment with the PyTorch / CUDA port.")
    p.add_argument("--resume-from", default=None)
    p.add_argument("--load-from", default=None)
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="write a torch.profiler trace of a few steady-state train steps; it holds "
                        "the port's spans (utils/profiling.py): train.step with its forward, "
                        "backward, allreduce and optimizer phases, train.loader_wait, and "
                        "model.reader, .backbone, .neck and .head")
    # overrides may come before and after the options (a launcher's own overrides, then its caller's)
    args = p.parse_intermixed_args(argv)
    device = parallel.init_from_env(args.dist_backend, args.device)
    log = setup_logging(parallel.rank())
    cfg = load_experiment(args.config, args.overrides)
    log.info("device: %s, rank %d of %d", device, parallel.rank(), parallel.world_size())

    train_ds = builders.build_dataset(cfg["data"]["train_dataset"])
    val_ds = builders.build_dataset(cfg["data"]["val_dataset"])
    dl_cfg = cfg["dataloader"]
    max_points = int(dl_cfg.get("max_points", 300000))
    accum = int(cfg["trainer"].get("accum_steps", 1))
    batch_size = int(dl_cfg["train"]["batch_size"]) * accum
    train_loader = build_dataloader(train_ds, batch_size, max_points, shuffle=True,
                                    num_workers=int(dl_cfg["train"]["num_workers"]))
    val_loader = build_dataloader(val_ds, batch_size, max_points, shuffle=False,
                                  num_workers=int(dl_cfg["val"]["num_workers"]), drop_last=False)

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
    parallel.shutdown()
