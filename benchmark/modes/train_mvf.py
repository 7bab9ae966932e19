"""Training cells of the MVF detector: the program's ``train_step`` at the
cell's batch, back to back over the pool, as ``modes/train.py`` runs the
other detectors.

What differs from ``modes/train.py``: the reference is
``reference.mvf.MVFDetector`` and its loss (the IoU branch's term
included); the scenes are drawn with the configuration's Waymo classes
standing in for the traffic's own (``STAND_INS``), in a copy of the
configuration used only to draw them, so the targets keep the
configuration's task groups; the FLOPs are ``counts_mvf.py``'s; no hook
is opened on a backbone (the detector has none); the peak learning rate
is the configuration's ``max_lr`` (``schedule``); the numbers compared
add ``grad_gap_mean`` (``values``).  The traced stretch
records kernel 2's launches and keeps the bytes and FLOPs of a step's
tower passes (``extra["tower_cost"]``).  ``extra["occupancy"]`` holds the pillar and
cylinder cells a frame of the checked steps.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from benchmark import check, common, counts_mvf, trace, traffic as scenes
from benchmark.launches import Recorder
from benchmark.modes.train import CHECKED_STEPS, schedule_args
from benchmark.reference import mvf
from benchmark.reference.loss import ClipAdamW, onecycle
from benchmark.reference.model import f32

# a Waymo class -> the traffic generator's class of that size
STAND_INS = {"vehicle": "car", "cyclist": "bicycle"}


def values(p_losses, p_grad, p_update, ref: dict) -> dict:
    """``check.train_values`` and ``grad_gap_mean``: the mean over the
    leaves of the first step's gradient gaps.  A coarser rounding than the
    configuration's moves MVF's gradients most in the readers' first
    layers (the PFNs and tower stage 0 over the 2048^2 grid), which the
    median leaf does not see; bfloat16's own gaps are spread over the
    leaves, so their mean varies less over seeds than the median does."""
    out = check.train_values(p_losses, p_grad, p_update, ref)
    out["grad_gap_mean"] = float(np.mean(check.gaps(p_grad, ref["first_grad"], ref["first_grad"])))
    return out


def scene_config(exp: dict) -> dict:
    """``exp`` with each task group's Waymo classes named by their stand-ins."""
    out = copy.deepcopy(exp)
    cm = out["data"]["train_dataset"]["prepare_label"]["centermap"]
    cm["tasks"] = [[STAND_INS.get(n, n) for n in task] for task in cm["tasks"]]
    return out


def schedule(exp: dict, conf: dict) -> dict:
    """``modes/train.schedule_args`` with the configuration's own ``max_lr``
    (the published recipe's, which the experiment's YAML does not hold)."""
    return dict(schedule_args(exp, conf), max_lr=float(conf["max_lr"]))


def make_pool(exp: dict, traffic: dict, seed: int) -> list:
    """The cell's pool of batches with their targets, made from ``seed``."""
    rng = np.random.default_rng(seed % 2**64)
    cfg = scene_config(exp)
    return [scenes.batch(rng, cfg, traffic, int(traffic["batch"]), True) for _ in range(int(traffic["pool_batches"]))]


def run(r: common.Run, program=None) -> None:
    """``program``, when given, wraps ``train_step`` and returns the step
    the run drives: a fault for the tests and ``control_mvf.py``."""
    from pillarnext_tpu_torch.train import train_state
    from pillarnext_tpu_torch.utils.builders import build_model

    spec, dev = r.spec, r.device
    exp, traffic = spec.config["experiment"], spec.traffic
    sa = schedule(exp, spec.config)
    batches = [common.to_device(b, dev) for b in make_pool(exp, traffic, r.seed)]
    ref = mvf.MVFDetector(exp["model"]).to(dev)
    weights = common.make_weights(ref, r.seed, dev, eval_stats=False)
    model = build_model(exp["model"], device=dev, train=True)
    model.load_state_dict(weights, strict=True)
    names = [n for n, _ in model.named_parameters()]
    opt, _ = train_state.make_optimizer(
        list(model.parameters()), sa["max_lr"], sa["total_steps"], betas=sa["betas"],
        weight_decay=sa["weight_decay"], div_factor=sa["div_factor"], pct_start=sa["pct_start"],
        clip_grad_val=sa["clip"])
    step = train_state.train_step if program is None else program(train_state.train_step)

    losses, occupancy = [], []
    for i in range(CHECKED_STEPS):
        scalars, _ = step(model, opt, batches[i])
        losses.append(scalars["loss"])
        tel = scalars["telemetry"]
        occupancy.append(torch.stack([tel["pillar_active"], tel["cylinder_active"]]))
        if i == 0:
            # the gradient as the optimizer got it, before its clip (modes/train.py)
            unclip = torch.clamp(scalars["grad_norm"].float() / sa["clip"], min=1.0) if sa["clip"] > 0 else 1.0
            given = {n: m / (1 - opt.b1) * unclip for n, m in zip(names, opt.mu)}
            first_grad = common.leaf_norms(given)
            if r.keep:
                r.kept["program_grad"] = {n: g.detach().clone() for n, g in given.items()}
    params = dict(model.named_parameters())
    update = common.leaf_norms({n: params[n].detach() - weights[n] for n in names})
    if r.keep:
        r.kept.update(weights=weights, program={n: params[n].detach().clone() for n in names})
    program_losses = [float(v) for v in torch.stack(losses).cpu()]
    b = int(traffic["batch"])
    r.extra["occupancy"] = {"pillar": (torch.stack(occupancy)[:, 0].cpu().numpy() / b).tolist(),
                            "cylinder": (torch.stack(occupancy)[:, 1].cpu().numpy() / b).tolist()}
    common.sync(dev)
    r.metrics["setup_s"] = time.perf_counter() - r.t0
    setup_peak = common.peak(dev)
    common.reset_peak(dev)

    n_pool = len(batches)
    window = []
    if r.trace:
        n = int(traffic["trace_steps"])
        with Recorder() as rec:
            r.profile = trace.profiled(
                lambda i: window.append(step(model, opt, batches[(CHECKED_STEPS + i) % n_pool])[0]), n, dev)
        r.launches = rec
        r.extra["steps"] = n
        # a step's tower passes under ``mvf.tower``: the forward and the recompute
        elem = 2 if exp["model"].get("dtype", "bfloat16") == "bfloat16" else 4
        r.extra["tower_cost"] = (2 * counts_mvf.tower_bytes(ref, b, elem), 2 * counts_mvf.tower_flops(ref, b))
        r.flops = sum(counts_mvf.train_step_flops(ref, batches[(CHECKED_STEPS + i) % n_pool]["points"],
                                                  batches[(CHECKED_STEPS + i) % n_pool]["points_mask"])
                      for i in range(n))
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
    r.values = values(program_losses, first_grad, update, reference)
    r.checks = check.rated(spec.cell["name"], r.values)
    r.extra["losses"] = {"program": program_losses, "reference": reference["losses"]}
    r.extra["leaves"] = {"program_grad": first_grad, "program_update": update,
                         "reference_grad": reference["first_grad"], "reference_update": reference["update"]}


def reference_steps(ref: mvf.MVFDetector, weights: dict, batches: list, exp: dict, sa: dict, names: list,
                    prec=None, keep: bool = False) -> dict:
    """``modes/train.reference_steps`` with the MVF reference's loss: each
    loss, the first step's gradients before the clip (leaf norms), each
    leaf's change after the last (with ``keep`` also the parameters after
    the last and the first step's gradients, as ``params`` and ``grads``)."""
    ref.load_state_dict(weights)
    ref.train()
    params = dict(ref.named_parameters())
    plist = [params[n] for n in names]
    opt = ClipAdamW(plist, onecycle(sa["total_steps"], sa["max_lr"], sa["pct_start"], sa["div_factor"]),
                    betas=sa["betas"], weight_decay=sa["weight_decay"], clip=sa["clip"])
    losses, first, first_grads = [], None, None
    for i, batch in enumerate(batches):
        for p in plist:
            p.grad = None
        with f32():
            total = mvf.loss(ref(batch["points"], batch["points_mask"], prec), batch, exp["model"]["head"])
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
