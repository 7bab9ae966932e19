"""What both modes share: the run's record, the weights made from the
seed, the batches on the card, the card's name and power limit, the
modules that must not be loaded, and the spans the benchmark opens
around the program's layers."""

from __future__ import annotations

import math
import re
import subprocess
import sys

import numpy as np
import torch

from benchmark.reference.model import Detector, fan_in

FORBIDDEN = ("jax", "jaxlib", "flax", "pillarnext_tpu")
HM_BIAS = -2.19  # the heatmap's initial bias (det3d CenterHead's init_bias)


class Run:
    """One run: its arguments, and what the mode and the readers fill in."""

    def __init__(self, spec, seed: int, seconds: float, trace: bool, device, t0: float):
        self.spec, self.seed, self.seconds, self.trace = spec, seed, seconds, trace
        self.device, self.t0 = device, t0
        self.metrics: dict = {}      # name -> value, end-to-end (or per-layer, traced)
        self.attempted = self.failed = 0
        self.values: dict = {}       # every number the check works out
        self.checks: list = []       # (name, value, limit) of those compared
        self.profile = None          # trace.Profile of the traced stretch
        self.launches: list = []     # (kernel, recorded arguments) in the traced stretch
        self.flops = 0.0             # the reference's work in the traced stretch
        self.repairs = 0
        self.memory_peak = 0
        self.extra: dict = {}
        self.keep = False            # a training run keeps its parameters in ``kept``
        self.kept: dict = {}


def make_weights(ref: Detector, seed: int, device, eval_stats: bool, base_seed=None, jitter: float = 0.0) -> dict:
    """Every parameter and buffer of ``ref``'s state dict, drawn on
    ``device`` from ``seed`` in two calls: kernels N(0, 1 / fan_in), biases
    0 (the heatmap's final bias -2.19), BatchNorm at identity; for eval
    the running statistics randomised (mean N(0, 0.3^2), variance
    U(0.5, 2)), as the reference mirror does, so that random weights give
    detections.  With ``base_seed`` the tensors are those of ``base_seed``,
    each scaled by (1 + ``jitter`` x N(0, 1)) elementwise from ``seed``:
    one model, its weights moved a little by the seed."""
    if base_seed is not None:
        out = make_weights(ref, base_seed, device, eval_stats)
        gen = torch.Generator(device=device).manual_seed(seed % 2**63)
        return {k: v * (1 + jitter * torch.randn(v.shape, generator=gen, device=device)) for k, v in out.items()}
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    shapes = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    kernels = [k for k, s in shapes.items() if len(s) >= 2]
    flat = torch.randn(sum(math.prod(shapes[k]) for k in kernels), generator=gen, device=device)
    out, at = {}, 0
    for k in kernels:
        n = math.prod(shapes[k])
        out[k] = flat[at:at + n].reshape(shapes[k]) / math.sqrt(fan_in(k, shapes[k]))
        at += n
    hm_final = {}
    for k in shapes:  # the heatmap branch's last conv, per task
        m = re.match(r"(.*\.hm\.)(\d+)\.bias$", k)
        if m:
            hm_final[m.group(1)] = max(hm_final.get(m.group(1), 0), int(m.group(2)))
    hm_biases = {f"{p}{i}.bias" for p, i in hm_final.items()}
    means = [k for k in shapes if k.endswith("running_mean")]
    stats = torch.rand(2 * sum(shapes[k][0] for k in means), generator=gen, device=device)
    at = 0
    for k in shapes:
        if k in out:
            continue
        if k.endswith("running_mean") or k.endswith("running_var"):
            var = k.endswith("running_var")
            if not eval_stats:
                out[k] = (torch.ones if var else torch.zeros)(shapes[k], device=device)
                continue
            n = shapes[k][0]
            u = stats[at:at + n]
            at += n
            # a normal mean by the inverse CDF of a uniform
            out[k] = 0.5 + 1.5 * u if var else 0.3 * math.sqrt(2) * torch.erfinv(2 * u - 1)
        elif k.endswith(".weight"):  # BatchNorm scales
            out[k] = torch.ones(shapes[k], device=device)
        else:
            out[k] = torch.zeros(shapes[k], device=device)
            if k in hm_biases:
                out[k] += HM_BIAS
    return out


def to_device(batch: dict, device) -> dict:
    out = {}
    for k, v in batch.items():
        if isinstance(v, list):
            out[k] = [torch.as_tensor(t).to(device) for t in v]
        else:
            out[k] = torch.as_tensor(v).to(device)
    return out


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def empty_cache(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def card(device) -> dict:
    """{"kind": torch's name of the card, "power_limit": nvidia-smi's}."""
    out = {"kind": torch.cuda.get_device_name(device), "power_limit": None}
    try:
        lines = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
        out["power_limit"] = lines[torch.device(device).index or 0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark must not load."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class Spans:
    """``record_function`` ranges ``bench.<name>`` around the forward of
    the program's modules, opened and closed by forward pre- and post-hooks."""

    def __init__(self, modules: dict):
        self.handles = []
        for name, module in modules.items():
            if module is None:
                continue
            state = {}

            def pre(mod, args, name=name, state=state):
                state["range"] = torch.profiler.record_function(f"bench.{name}")
                state["range"].__enter__()

            def post(mod, args, out, state=state):
                state.pop("range").__exit__(None, None, None)

            self.handles += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]

    def remove(self):
        for h in self.handles:
            h.remove()


def leaf_norms(tensors: dict) -> dict:
    """name -> float norm, in one transfer."""
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack([tensors[n].float().norm() for n in names]).cpu().numpy()
    return dict(zip(names, norms.astype(np.float64)))
