"""Checkpoint I/O with ``torch.save``.

Counterpart of pillarnext_tpu/train/checkpoint.py: per-epoch checkpoints
carrying {meta{epoch, step}, model (parameters and BN statistics),
opt_state}, a strict restore, and latest-checkpoint discovery for resume.
Under a process group rank 0 writes (every rank holds the same state) and
every rank waits at a barrier until the file is there; every rank reads it
on resume.
"""

from __future__ import annotations

import re
from pathlib import Path

import torch

from pillarnext_tpu_torch import parallel


def save_checkpoint(directory, epoch: int, model, optimizer) -> Path:
    """Write ``epoch_{n}.pt`` under ``directory`` (rank 0; the others wait
    for it)."""
    path = Path(directory) / f"epoch_{epoch}.pt"
    if parallel.rank() == 0:
        _write(path, epoch, model, optimizer)
    parallel.barrier()
    return path


def _write(path: Path, epoch: int, model, optimizer) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "meta": {"epoch": int(epoch), "step": int(optimizer.count)},
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "opt_state": {k: ([t.cpu() for t in v] if isinstance(v, list) else v)
                      for k, v in optimizer.state_dict().items()},
    }
    tmp = path.with_suffix(".tmp")
    torch.save(payload, tmp)
    tmp.replace(path)


def load_checkpoint(path) -> dict:
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def restore(model, optimizer, payload: dict) -> None:
    """Load a checkpoint payload into ``model`` and ``optimizer`` (strict:
    every key present, none left over)."""
    model.load_state_dict(payload["model"], strict=True)
    optimizer.load_state_dict(payload["opt_state"])


def latest_checkpoint(directory) -> Path | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    best, best_epoch = None, -1
    for p in directory.iterdir():
        m = re.fullmatch(r"epoch_(\d+)\.pt", p.name)
        if m and int(m.group(1)) > best_epoch:
            best, best_epoch = p, int(m.group(1))
    return best
