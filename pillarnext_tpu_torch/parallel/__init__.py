"""Data-parallel training and evaluation over ``torch.distributed``.

Counterpart of pillarnext_tpu/parallel/mesh.py.  JAX trains on a 1-D data
mesh under global-view ``jit``, which gives three things without code
(mesh.py:1-17); the port makes each explicit, one process per card:

- the gradient all-reduce: ``train_state.train_step`` sums every gradient
  (and the step's logged scalars) across ranks in one flat
  ``all_reduce_`` after the backward, before the clip and AdamW — JAX's
  psum, then clip;
- BatchNorm statistics over the global batch (SyncBatchNorm's semantics):
  ``models/layers.BatchNorm(sync=True)`` sums its ``(Σx·m, Σx²·m, Σm)``
  with ``all_reduce_sum``, whose backward sums the cotangent, so input
  gradients are those of one BatchNorm over every rank's rows;
- the eval gather: ``gather_to_rank0`` brings each rank's detections to
  rank 0, the reference's ``all_gather_object`` (trainer.py:160-174).

The losses' normalisers are global counts too (models/losses.py), as they
are under JAX's global view.  The group is built from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
``MASTER_PORT``) with an explicit backend: ``nccl`` for one rank per card,
``gloo`` where ranks share a card or run on the CPU.  Without a group
every function here is the identity of one process, so single-process
paths run unchanged.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def is_distributed() -> bool:
    """Whether this process belongs to an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def require_group() -> None:
    """Raise when the environment names several processes and this one
    has no group: it would train its shard alone."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not is_distributed():
        raise RuntimeError(
            f"WORLD_SIZE={os.environ['WORLD_SIZE']} but no torch.distributed process group is "
            "initialised: call parallel.init_from_env (the CLIs do) instead of training one shard alone")


def init_from_env(backend: str = "nccl", device: str | None = None,
                  timeout_s: float | None = None) -> torch.device:
    """Join the process group that torchrun's environment describes and
    return this rank's device: ``device`` when given, else
    ``cuda:{LOCAL_RANK}``.  Without ``RANK`` / ``WORLD_SIZE`` in the
    environment it forms no group (one process).  ``WORLD_SIZE > 1``
    without the rest of the rendezvous raises; NCCL refuses two ranks on
    one card, so ``nccl`` with one explicit ``device`` for several local
    ranks raises before the group forms (``gloo`` may share a card).  An
    already initialised group is kept."""
    from pillarnext_tpu_torch.utils.builders import resolve_device

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    resolved = resolve_device(device if device is not None else f"cuda:{local_rank}")
    if is_distributed():
        return resolved
    world = int(os.environ.get("WORLD_SIZE", "1"))
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        if world > 1:
            raise RuntimeError(f"WORLD_SIZE={world} but {missing} are not set: start the ranks with "
                               "torchrun (python -m torch.distributed.run --nproc_per_node=N ...)")
        return resolved
    if backend == "nccl":
        if resolved.type != "cuda":
            raise RuntimeError(f"the nccl backend needs a CUDA device per rank, got {resolved}: "
                               "use --dist-backend gloo on the CPU")
        if device is not None and int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > 1:
            raise RuntimeError(
                f"--device {device} puts every local rank on one card, which NCCL refuses: leave "
                "--device out (rank r takes cuda:r) or use --dist-backend gloo to share the card")
        torch.cuda.set_device(resolved)
    kwargs = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=int(os.environ["RANK"]), **kwargs)
    return resolved


def shutdown() -> None:
    if is_distributed():
        dist.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    """Σ over ranks; the backward sums the cotangent over ranks, since each
    rank's loss depends on the sum every rank holds."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every rank, differentiable; ``x`` itself without
    a group."""
    return _AllReduceSum.apply(x) if is_distributed() else x


def all_reduce_(tensors: list, op=dist.ReduceOp.SUM) -> None:
    """Reduce ``tensors`` in place over every rank in ONE collective: they
    are packed into a float32 buffer (exact for counts below 2^24), reduced
    and copied back.  Nothing happens without a group."""
    if not is_distributed() or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=op)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def broadcast_from_rank0_(tensors: list) -> None:
    """Overwrite ``tensors`` in place with rank 0's values, one broadcast
    per dtype."""
    if not is_distributed():
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=0)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def gather_to_rank0(obj):
    """Rank 0: the list of every rank's ``obj`` in rank order; other
    ranks: None.  Without a group: ``[obj]``."""
    if not is_distributed():
        return [obj]
    out = [None] * world_size() if rank() == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out


def barrier() -> None:
    if is_distributed():
        dist.barrier()
