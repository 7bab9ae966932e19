"""The optimizer and the training step.

Counterpart of pillarnext_tpu/train/train_state.py:56-170: loss and
gradients (with the BN running statistics updated in the forward), the
global-norm clip, AdamW with the OneCycle schedule, in that order.  The
optimizer reproduces optax's ``chain(clip_by_global_norm(c),
adamw(cosine_onecycle_schedule(...)))`` rather than torch's classes:

- the schedule is optax's ``cosine_onecycle_schedule`` (torch's
  ``OneCycleLR`` puts its phase boundaries elsewhere);
- clipping scales by ``c / norm`` when ``norm >= c`` and leaves the
  gradients alone otherwise (torch's ``clip_grad_norm_`` adds 1e-6);
- AdamW: ``u = m_hat / (sqrt(v_hat) + eps) + wd * p`` and ``p -= lr(t) * u``
  with ``lr`` read at the update count before the increment, weight decay
  on every parameter.

The step returns its scalars as device tensors: nothing in it waits for
the card, except the collectives of several ranks.  With a process group
(parallel/) every gradient and logged scalar is summed across ranks in one
flat all-reduce after the backward, before the clip: the losses'
normalisers are global counts (models/losses.py), so the sum is the
gradient of JAX's global-batch loss.

Spans (utils/profiling.annotate, recorded while a torch.profiler runs):
``train.step`` around the whole step; inside it ``train.forward``
(``model.loss``) and ``train.backward`` (``backward()``) for each
micro-batch, ``train.allreduce`` (the gradient list, its all-reduce and
the accumulation's divide) and ``train.optimizer`` (global norm, clip,
AdamW).  Autograd runs a CUDA backward on its own device thread: that
thread's ``autograd::engine::evaluate_function`` events (a recomputed
block's replay among them) lie inside ``train.backward`` in time, not as
its children.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from pillarnext_tpu_torch import parallel
from pillarnext_tpu_torch.utils import profiling


def cosine_onecycle_schedule(
    transition_steps: int,
    peak_value: float,
    pct_start: float = 0.3,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Callable[[int], float]:
    """optax's one-cycle schedule: cosine from ``peak / div`` up to ``peak``
    over the first ``int(pct_start * steps)`` steps, then down to
    ``peak / (div * final_div)`` at ``steps``, constant after."""
    if transition_steps <= 0:
        raise ValueError("a onecycle schedule needs a positive transition_steps")
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    init = peak_value / div_factor
    values = [init, init * div_factor, init * div_factor / (div_factor * final_div_factor)]

    def schedule(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return values[-1] if count >= bounds[-1] else 0.0

    return schedule


class AdamW:
    """optax ``chain(clip_by_global_norm, adamw)`` over a list of
    parameters; state: update count, first and second moments."""

    def __init__(self, params, schedule: Callable[[int], float], betas=(0.9, 0.99),
                 eps: float = 1e-8, weight_decay: float = 0.01, clip_norm: float = 0.0):
        self.params = [p for p in params]
        self.schedule = schedule
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update from the parameters' ``.grad``; return the
        global norm of the gradients before clipping (a device scalar)."""
        grads = [
            torch.zeros_like(p) if p.grad is None else p.grad.float() for p in self.params
        ]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.clip_norm and self.clip_norm > 0:
            scale = torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        t = self.count + 1
        denom = torch._foreach_div(self.nu, 1 - self.b2**t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, 1 - self.b1**t)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-self.schedule(self.count))
        self.count = t
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": [m.clone() for m in self.mu],
                "nu": [v.clone() for v in self.nu]}

    def load_state_dict(self, state: dict) -> None:
        if len(state["mu"]) != len(self.mu):
            raise ValueError(f"optimizer state holds {len(state['mu'])} tensors, expected {len(self.mu)}")
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)


def make_optimizer(params, max_lr: float, total_steps: int, *, betas=(0.9, 0.99),
                   weight_decay: float = 0.01, div_factor: float = 10.0, pct_start: float = 0.4,
                   final_div_factor: float = 1e4, clip_grad_val: float = 35.0):
    """(AdamW, schedule) as train_state.py:56-82 builds them."""
    schedule = cosine_onecycle_schedule(
        total_steps, max_lr, pct_start=pct_start, div_factor=div_factor,
        final_div_factor=final_div_factor,
    )
    opt = AdamW(params, schedule, betas=betas, weight_decay=weight_decay, clip_norm=clip_grad_val)
    return opt, schedule


def overflow_total(telemetry: dict) -> torch.Tensor:
    """Sum of all ``*_overflow`` counters (0 when the model reports none)."""
    vals = [v for k, v in telemetry.items() if k.endswith("_overflow")]
    return sum(vals) if vals else torch.zeros((), dtype=torch.int32)


def split_batch(batch: dict, parts: int) -> list[dict]:
    """``batch`` (tensors or numpy arrays) cut along its leading (batch)
    dim into ``parts`` equal micro-batches, in order; the per-task target
    lists are cut element-wise, the tokens as a list."""
    b = int(batch["points"].shape[0])
    if b % parts:
        raise ValueError(f"a batch of {b} does not split into {parts} equal parts")
    n = b // parts

    def cut(v, i):
        if isinstance(v, list) and v and hasattr(v[0], "shape"):
            return [t[i * n:(i + 1) * n] for t in v]
        return v[i * n:(i + 1) * n]

    return [{k: cut(v, i) for k, v in batch.items()} for i in range(parts)]


def train_step(model, optimizer: AdamW, batch: dict, plain: bool = False, accum_steps: int = 1):
    """One step: train-mode forward + loss, backward (under
    ``model.precision()``, as the forward), the gradient all-reduce across
    ranks, clip + AdamW.

    ``accum_steps > 1`` (train_state.py:96-170) cuts the batch into that
    many micro-batches, run in order: each normalised by its own (global)
    counts and updating the BN statistics; the gradients, the loss and the
    logs are their means, the telemetry their max, and the step makes one
    optimizer update after one all-reduce.  With several ranks micro-batch
    i is chunk i of every rank's local batch (JAX's multi-process reshape
    groups them otherwise, an artefact of its sharding).

    Returns ({"loss", "grad_norm", "overflow", "telemetry"} as device
    scalars, per-task log dicts detached); the loss and logs are global
    (summed over ranks), the telemetry this rank's."""
    with profiling.annotate("train.step"):
        model.train()
        for p in optimizer.params:
            p.grad = None
        loss = None
        logs: list[dict] = []
        telemetry: dict = {}
        for micro in (split_batch(batch, accum_steps) if accum_steps > 1 else [batch]):
            tel: dict = {}
            with profiling.annotate("train.forward"):
                mloss, mlogs = model.loss(micro, telemetry=tel, plain=plain)
            with profiling.annotate("train.backward"), model.precision():
                mloss.backward()
            mlogs = [{k: v.detach() for k, v in log.items()} for log in mlogs]
            if loss is None:
                loss, logs, telemetry = mloss.detach(), mlogs, tel
            else:
                loss = loss + mloss.detach()
                logs = [{k: a[k] + b[k] for k in a} for a, b in zip(logs, mlogs)]
                telemetry = {k: torch.maximum(telemetry[k], v) for k, v in tel.items()}
        with profiling.annotate("train.allreduce"):
            grads = []
            for p in optimizer.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            summed = grads + [loss] + [v for log in logs for v in log.values()]
            parallel.all_reduce_(summed)
            if accum_steps > 1:
                torch._foreach_div_(summed, float(accum_steps))
        with profiling.annotate("train.optimizer"):
            grad_norm = optimizer.step()
        scalars = {"loss": loss, "grad_norm": grad_norm,
                   "overflow": overflow_total(telemetry), "telemetry": telemetry}
    return scalars, logs
