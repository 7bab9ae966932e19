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
the card.  ``accum_steps > 1`` is not ported (ROADMAP).
"""

from __future__ import annotations

import math
from typing import Callable

import torch


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


def train_step(model, optimizer: AdamW, batch: dict, plain: bool = False):
    """One step: train-mode forward + loss, backward (under
    ``model.precision()``, as the forward), clip + AdamW.

    Returns ({"loss", "grad_norm", "overflow", "telemetry"} as device
    scalars, per-task log dicts detached)."""
    model.train()
    telemetry: dict = {}
    loss, logs = model.loss(batch, telemetry=telemetry, plain=plain)
    for p in optimizer.params:
        p.grad = None
    with model.precision():
        loss.backward()
    grad_norm = optimizer.step()
    scalars = {"loss": loss.detach(), "grad_norm": grad_norm,
               "overflow": overflow_total(telemetry), "telemetry": telemetry}
    return scalars, [{k: v.detach() for k, v in log.items()} for log in logs]
