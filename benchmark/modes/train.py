"""Training cells: the program's ``train_step`` at the cell's batch, back to
back over the pool.

Set-up builds the model and its AdamW state once, loads the weights the
benchmark made, and drives that one object through its first three steps
on three different batches of the pool: they warm up every shape, and
the check compares them with the reference.  The window then runs the
same object on, step after step, cycling through the pool, and ends in a
synchronise.  ``train_frames_per_s`` is B x steps over the window;
``train_peak_gib`` the allocator's peak in the window.  A step fails when
its loss or gradient norm is not finite or a table overflowed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import check, common, counts, trace
from benchmark.launches import Recorder
from benchmark.reference import loss as ref_loss
from benchmark.reference.model import Detector, f32
from benchmark.traffic import pool as make_pool

CHECKED_STEPS = 3


def schedule_args(exp: dict, conf: dict) -> dict:
    sch, opt = exp["scheduler"], exp["optimizer"]
    return {"max_lr": float(sch["max_lr"]), "total_steps": int(conf["schedule_steps"]),
            "div_factor": float(sch["div_factor"]), "pct_start": float(sch["pct_start"]),
            "betas": tuple(opt["betas"]), "weight_decay": float(opt["weight_decay"]),
            "clip": float(exp["trainer"]["clip_grad_val"])}


def run(r: common.Run, program=None) -> None:
    """``program``, when given, wraps ``train_step`` and returns the step
    the run drives: a fault for the tests and ``control.py``."""
    from pillarnext_tpu_torch.train import train_state
    from pillarnext_tpu_torch.utils.builders import build_model

    spec, dev = r.spec, r.device
    exp, traffic = spec.config["experiment"], spec.traffic
    sa = schedule_args(exp, spec.config)
    batches = [common.to_device(b, dev) for b in make_pool(exp, traffic, r.seed)]
    ref = Detector(exp["model"]).to(dev)
    weights = common.make_weights(ref, r.seed, dev, eval_stats=False)
    model = build_model(exp["model"], device=dev, train=True)
    model.load_state_dict(weights, strict=True)
    names = [n for n, _ in model.named_parameters()]
    opt, _ = train_state.make_optimizer(
        list(model.parameters()), sa["max_lr"], sa["total_steps"], betas=sa["betas"],
        weight_decay=sa["weight_decay"], div_factor=sa["div_factor"], pct_start=sa["pct_start"],
        clip_grad_val=sa["clip"])
    step = train_state.train_step if program is None else program(train_state.train_step)

    losses = []
    for i in range(CHECKED_STEPS):
        scalars, _ = step(model, opt, batches[i])
        losses.append(scalars["loss"])
        if i == 0:
            # the gradient as the optimizer got it, before its clip: its
            # first moment over (1 - beta1), times the clip's divisor
            unclip = torch.clamp(scalars["grad_norm"].float() / sa["clip"], min=1.0) if sa["clip"] > 0 else 1.0
            given = {n: m / (1 - opt.b1) * unclip for n, m in zip(names, opt.mu)}
            first_grad = common.leaf_norms(given)
            if r.keep:
                r.kept["program_grad"] = {n: g.detach().clone() for n, g in given.items()}
    params = dict(model.named_parameters())
    update = common.leaf_norms({n: params[n].detach() - weights[n] for n in names})
    if r.keep:  # for control.py's look at single leaves
        r.kept.update(weights=weights, program={n: params[n].detach().clone() for n in names})
    program_losses = [float(v) for v in torch.stack(losses).cpu()]
    common.sync(dev)
    r.metrics["setup_s"] = time.perf_counter() - r.t0
    setup_peak = common.peak(dev)
    common.reset_peak(dev)

    n_pool, b = len(batches), int(traffic["batch"])
    window = []
    if r.trace:
        spans = common.Spans({"backbone": model.backbone})
        n = int(traffic["trace_steps"])
        with Recorder() as rec:
            r.profile = trace.profiled(
                lambda i: window.append(step(model, opt, batches[(CHECKED_STEPS + i) % n_pool])[0]), n, dev)
        spans.remove()
        r.launches = rec
        r.extra["steps"] = n
        r.flops = sum(counts.train_step_flops(ref, batches[(CHECKED_STEPS + i) % n_pool]["points"],
                                              batches[(CHECKED_STEPS + i) % n_pool]["points_mask"]) for i in range(n))
    else:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < r.seconds:
            window.append(step(model, opt, batches[(CHECKED_STEPS + len(window)) % n_pool])[0])
        common.sync(dev)
        elapsed = time.perf_counter() - t0
        r.metrics["train_frames_per_s"] = b * len(window) / elapsed
        r.metrics["train_peak_gib"] = common.peak(dev) / 2**30
    r.memory_peak = max(setup_peak, common.peak(dev))
    r.attempted = len(window)
    if window:
        vals = torch.stack([torch.stack([s["loss"].float(), s["grad_norm"].float(), s["overflow"].float()])
                            for s in window]).cpu().numpy()
        r.failed = int((~np.isfinite(vals[:, 0]) | ~np.isfinite(vals[:, 1]) | (vals[:, 2] > 0)).sum())
    del model, opt, window, step, params
    common.empty_cache(dev)

    t = time.perf_counter()
    reference = reference_steps(ref, weights, batches[:CHECKED_STEPS], exp, sa, names, keep=r.keep)
    if r.keep:
        r.kept.update(reference=reference.pop("params"), reference_grad=reference.pop("grads"))
    r.extra["reference_s"] = time.perf_counter() - t
    r.values = check.train_values(program_losses, first_grad, update, reference)
    r.checks = check.rated(spec.cell["name"], r.values)
    r.extra["losses"] = {"program": program_losses, "reference": reference["losses"]}
    r.extra["leaves"] = {"program_grad": first_grad, "program_update": update,
                         "reference_grad": reference["first_grad"], "reference_update": reference["update"]}


def reference_steps(ref: Detector, weights: dict, batches: list, exp: dict, sa: dict, names: list,
                    prec=None, keep: bool = False) -> dict:
    """The reference's first steps from the same weights on the same
    batches: each loss, the first step's gradients as the optimizer got
    them, before its clip (leaf norms), each leaf's change after the last
    (with ``keep`` also the parameters after the last and the first
    step's gradients, as ``params`` and ``grads``)."""
    ref.load_state_dict(weights)
    ref.train()
    params = dict(ref.named_parameters())
    plist = [params[n] for n in names]
    opt = ref_loss.ClipAdamW(plist, ref_loss.onecycle(sa["total_steps"], sa["max_lr"], sa["pct_start"],
                                                      sa["div_factor"]),
                             betas=sa["betas"], weight_decay=sa["weight_decay"], clip=sa["clip"])
    losses, first = [], None
    for i, batch in enumerate(batches):
        for p in plist:
            p.grad = None
        with f32():
            total, _ = ref_loss.loss(ref(batch["points"], batch["points_mask"], prec), batch, exp["model"]["head"])
            total.backward()
        losses.append(float(total.detach()))
        grads = opt.step()
        if i == 0:
            first = common.leaf_norms(dict(zip(names, grads)))
            first_grads = {n: g.detach().clone() for n, g in zip(names, grads)} if keep else None
    update = common.leaf_norms({n: params[n].detach() - weights[n] for n in names})
    out = {"losses": losses, "first_grad": first, "update": update}
    if keep:
        out["params"] = {n: params[n].detach().clone() for n in names}
        out["grads"] = first_grads
    return out
