"""Trainer runtime: epoch loop, overflow check, checkpoints.

Counterpart of pillarnext_tpu/train/trainer.py:56-213, 327-357.  Each
iteration is one ``train_step`` (train_state.py); scalars stay on the card
and are read only at log ticks and at the end of the epoch, where
``_check_overflow`` raises if any capacity counter reported dropped active
sites — an undersized pillar capacity or ``stage_capacity_frac`` fails
loudly instead of silently truncating the scene.  ``val_epoch`` waits for
the port's data pipeline (ROADMAP).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import torch

from pillarnext_tpu_torch.train import checkpoint as ckpt_lib
from pillarnext_tpu_torch.train.train_state import train_step
from pillarnext_tpu_torch.utils.builders import resolve_device

logger = logging.getLogger("pillarnext_tpu_torch")


def batch_to_device(batch: dict, device) -> dict:
    """Numpy / tensor batch (data/collate.py layout) -> tensors on ``device``."""
    out = {}
    for k, v in batch.items():
        if k == "token":
            out[k] = v
        elif isinstance(v, list):
            out[k] = [torch.as_tensor(t).to(device, non_blocking=True) for t in v]
        else:
            out[k] = torch.as_tensor(v).to(device, non_blocking=True)
    return out


class Trainer:
    """Args:
        model: the port's detector on ``device``
            (utils/builders.build_model(train=True)).
        train_dataloader: an iterable of batches with ``len``; ``set_epoch``
            is called when it has one.
        optimizer: ``train_state.AdamW`` over the model's parameters on
            ``device`` (utils/builders.build_optimizer).
        device: ``"cuda:0"`` unless the caller asks for the CPU; without a
            card the default raises.
    """

    def __init__(self, model, train_dataloader=None, optimizer=None, lr_schedule=None,
                 max_epochs: int = 0, log_every_niters: int = 50, work_dir=".",
                 accum_steps: int = 1, device="cuda:0", logger_=None):
        if accum_steps != 1:
            raise NotImplementedError("accum_steps > 1 not ported yet, see ROADMAP")
        self.device = resolve_device(device)
        self.model = model
        params = list(model.parameters())
        if any(p.device != self.device for p in params):
            raise ValueError(f"the model's parameters must be on {self.device} (build_model(device=...))")
        if optimizer is None or len(optimizer.params) != len(params) or any(
            a is not b for a, b in zip(optimizer.params, params)
        ):
            raise ValueError("optimizer must hold the model's parameters (build_optimizer)")
        self.train_dataloader = train_dataloader
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.max_epochs = max_epochs
        self.log_every_niters = log_every_niters
        self.work_dir = Path(work_dir)
        self.logger = logger_ or logger
        self.epoch = 0
        self.last_scalars = None
        self.epoch_losses: list[torch.Tensor] = []  # this epoch's step losses, on the card

    @property
    def step(self) -> int:
        return self.optimizer.count

    def train_step(self, batch: dict):
        """One optimizer step on a host or device batch."""
        return train_step(self.model, self.optimizer, batch_to_device(batch, self.device))

    def train_epoch(self):
        if hasattr(self.train_dataloader, "set_epoch"):
            self.train_dataloader.set_epoch(self.epoch)
        num_iters = len(self.train_dataloader)
        t_start = time.time()
        scalars = None
        self.epoch_losses = []
        for i, batch in enumerate(self.train_dataloader):
            scalars, logs = self.train_step(batch)
            self.epoch_losses.append(scalars["loss"])
            if (i + 1) % self.log_every_niters == 0:
                lr = self.lr_schedule(self.step) if self.lr_schedule else float("nan")
                self.logger.info(
                    "Epoch [%d/%d][%d/%d]\tlr: %.5f, loss: %.4f, %.2f it/s",
                    self.epoch + 1, self.max_epochs, i + 1, num_iters, lr,
                    float(scalars["loss"]), (i + 1) / (time.time() - t_start),
                )
                for log in logs:
                    self.logger.info(", ".join(f"{k}: {v.tolist()}" for k, v in log.items()))
                self._check_overflow(scalars, f"epoch {self.epoch + 1} iter {i + 1}")
        # the epoch's last step is checked too, before the checkpoint
        self._check_overflow(scalars, f"epoch {self.epoch + 1} end")
        self.last_scalars = scalars
        self.epoch += 1
        ckpt_lib.save_checkpoint(self.work_dir / "checkpoints", self.epoch, self.model, self.optimizer)

    def _check_overflow(self, scalars, where: str):
        """Raise when capacity telemetry reports dropped active sites."""
        if scalars is None or int(scalars["overflow"]) == 0:
            return
        tel = scalars["telemetry"]
        detail = {k: int(v) for k, v in tel.items() if k.endswith("_overflow") and int(v) > 0}
        active = {k: int(v) for k, v in tel.items() if k.endswith("_active")}
        raise RuntimeError(
            f"capacity overflow at {where}: {detail} active sites were silently dropped "
            f"(true active counts: {active}). Raise reader pillar capacity or backbone "
            "stage_capacity_frac to cover the data's dilated active sets."
        )

    def val_epoch(self):
        raise NotImplementedError("val_epoch waits for the port's data pipeline, see ROADMAP")

    def fit(self):
        """Train ``max_epochs`` epochs (no evaluation: see ``val_epoch``)."""
        while self.epoch < self.max_epochs:
            self.train_epoch()

    def resume(self, path):
        payload = ckpt_lib.load_checkpoint(path)
        ckpt_lib.restore(self.model, self.optimizer, payload)
        self.epoch = int(payload["meta"]["epoch"])
        self.logger.info("resumed epoch %d, step %d", self.epoch, self.step)

    def auto_resume(self) -> bool:
        latest = ckpt_lib.latest_checkpoint(self.work_dir / "checkpoints")
        if latest is None:
            return False
        self.resume(latest)
        return True
