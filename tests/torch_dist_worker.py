"""One rank of the port's data-parallel cases, for
tests/test_torch_port_distributed.py (and the cuda test of synced
BatchNorm in tests/test_torch_port_cuda.py).

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p PYTHONPATH=. \\
        python tests/torch_dist_worker.py SPEC OUT_DIR

SPEC is a pickle of the cases' inputs (numpy batches and weights, the
resolved configs); the rank joins the gloo group of the environment,
runs every case of SPEC in order and writes ``OUT_DIR/rank{r}.pt`` with
each case's outputs (or the exception it raised).  Imports torch and the
port only, never JAX.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from pillarnext_tpu_torch import parallel
from pillarnext_tpu_torch.models.layers import BN_EPS_SPARSE, BN_MOMENTUM_SPARSE, BatchNorm
from pillarnext_tpu_torch.train.train_state import split_batch, train_step
from pillarnext_tpu_torch.train.trainer import Trainer, batch_to_device
from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer
from pillarnext_tpu_torch.utils.weights import load_jax_variables


REPO = Path(__file__).resolve().parent.parent


def spawn(spec: dict, out_dir: Path, world: int = 2, group: bool = True) -> list:
    """Start ``world`` ranks of this module on ``spec`` (pickled into
    ``out_dir``), each with torch on one thread, over a free local port
    (``group=False``: one process that forms no group); returns the
    processes (``collect`` waits for them)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    spec_path = out_dir / "spec.pkl"
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        rendezvous = dict(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        env = {k: v for k, v in os.environ.items() if k not in rendezvous}
        env.update(rendezvous if group else {}, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
        with open(out_dir / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(spec_path),
                                           str(out_dir)], cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def collect(procs: list, out_dir: Path, timeout_s: float) -> list:
    """Wait for the ranks (killing them all at ``timeout_s``) and load each
    one's outputs; raise with the logs when one failed or hung."""
    deadline = time.monotonic() + timeout_s
    hung = False
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            hung = True
            break
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    logs = "\n".join((out_dir / f"rank{r}.log").read_text()[-3000:] for r in range(len(procs)))
    if hung or any(p.returncode for p in procs):
        raise RuntimeError(f"ranks {'hung' if hung else 'failed'} "
                           f"(exit codes {[p.returncode for p in procs]}):\n{logs}")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


def bn_inputs(seed: int = 0) -> dict:
    """Per-rank rows for each synced-BatchNorm case: masked with 37 and 5
    valid rows, masked with none on rank 0, unmasked NCHW maps."""
    rng = np.random.default_rng(seed)
    c = 8
    cases = {}
    for name, rows, valid_rows in (("masked", (50, 20), (37, 5)), ("masked_empty_rank", (30, 40), (0, 23))):
        x = [(rng.standard_normal((n, c)) * 2 + 0.5).astype(np.float32) for n in rows]
        valid = []
        for n, v in zip(rows, valid_rows):
            m = np.zeros(n, bool)
            m[rng.choice(n, v, replace=False)] = True
            valid.append(m)
        cases[name] = {"x": x, "valid": valid, "channel_dim": -1}
    x = [(rng.standard_normal((1, c, 6, 5)) * 2 - 0.3).astype(np.float32) for _ in range(2)]
    cases["unmasked"] = {"x": x, "valid": None, "channel_dim": 1}
    for case in cases.values():
        case.update(kind="bn", channels=c, eps=BN_EPS_SPARSE, momentum=BN_MOMENTUM_SPARSE,
                    weight=rng.uniform(0.5, 1.5, c).astype(np.float32),
                    bias=rng.normal(0, 0.1, c).astype(np.float32),
                    cotangent=[rng.standard_normal(a.shape).astype(np.float32) for a in case["x"]])
    return cases


def bn_reference(case: dict, device="cpu") -> dict:
    """One process, one BatchNorm over both ranks' rows."""
    bn = BatchNorm(case["channels"], case["eps"], case["momentum"]).to(device)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(case["weight"]))
        bn.bias.copy_(torch.from_numpy(case["bias"]))
    bn.train()
    x = torch.from_numpy(np.concatenate(case["x"])).to(device).requires_grad_(True)
    valid = None if case["valid"] is None else torch.from_numpy(np.concatenate(case["valid"])).to(device)
    y = bn(x, channel_dim=case["channel_dim"], valid=valid)
    (y * torch.from_numpy(np.concatenate(case["cotangent"])).to(device)).sum().backward()
    sizes = [a.shape[0] for a in case["x"]]
    return {"y": torch.split(y.detach(), sizes), "x_grad": torch.split(x.grad, sizes),
            "weight_grad": bn.weight.grad, "bias_grad": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


def step_case(case: dict, rank: int, world: int, device) -> dict:
    """One train step of the case's model (its numpy weights) on this
    rank's share of the case's batch: the global loss and logs, the
    summed gradients, the state after AdamW.  With ``case["relu"]`` also
    every ReLU input of the step (``relu_inputs``, in first-seen order,
    numpy) beside the valid rows of the BatchNorm call that produced it
    (``relu_valid``, None for dense maps); with ``case["pinned"]`` (per
    ReLU call, the whole batch's boolean mask and its count of valid rows,
    ``pinned_to_rank``) each ReLU passes its input where the mask is True
    instead of where the input is positive."""
    cfg = case["cfg"]
    model = build_model(cfg["model"], device=device, train=True)
    load_jax_variables(model, case["variables"])
    opt, _ = build_optimizer(cfg, case["steps_per_epoch"], list(model.parameters()))
    batch = batch_to_device(split_batch(case["batch"], world)[rank], device)
    pin = pinned_to_rank(case["pinned"], rank, world) if case.get("pinned") else None
    with recorded_relus(pin) if case.get("relu") else contextlib.nullcontext() as relus:
        scalars, logs = train_step(model, opt, batch, accum_steps=case.get("accum_steps", 1))
    out = {"loss": scalars["loss"].cpu(), "grad_norm": scalars["grad_norm"].cpu(),
           "logs": [{k: v.cpu() for k, v in log.items()} for log in logs],
           "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
           "state": {k: v.cpu() for k, v in model.state_dict().items()}}
    if relus is not None:
        out["relu_inputs"], out["relu_valid"] = relus
    return out


def rank_share(a: np.ndarray, n_global: int | None, valid, rank: int, world: int) -> np.ndarray:
    """A ReLU input (or mask) ``a`` of the whole batch, cut to rank
    ``rank``'s share in the rank's layout: a dense map (``valid`` None)
    holds the samples along its first dim; a compact table or the sorted
    points hold the batch's ``n_global`` valid rows first, sample by
    sample, and a rank's own valid rows (``valid``) are a prefix of its
    table: rank 0's are the batch's first rows, the last rank's its last
    valid rows (two ranks; rows past the valid ones are zero)."""
    if world > 2:
        raise ValueError("ReLU inputs are cut for at most two ranks")
    if valid is None:
        b = a.shape[0] // world
        return a[rank * b:(rank + 1) * b]
    n = int(valid.sum())
    if not valid[:n].all():
        raise ValueError("the valid rows are not a prefix of the table")
    offset = 0 if rank == 0 else n_global - n
    out = np.zeros(valid.shape + a.shape[1:], a.dtype)
    out[:n] = a[offset:offset + n]
    return out


def pinned_to_rank(pinned: list, rank: int, world: int):
    """``pin(call, valid)`` for ``recorded_relus``: ReLU call ``call``'s
    mask of the whole batch, ``pinned[call] = (mask, valid rows of the
    batch)``, cut to this rank's share (``rank_share``)."""
    return lambda call, valid: rank_share(*pinned[call], valid, rank, world)


@contextlib.contextmanager
def recorded_relus(pin=None):
    """Inside the block, ``torch.relu`` records each input the first time
    it sees it, with the ``valid`` rows of the last ``BatchNorm`` call when
    they match its rows (a compact table's or the sorted points'), and
    with ``pin`` passes the input where ``pin(call, valid)`` is True.
    Yields ([inputs], [valid rows or None]) as numpy arrays, filled as
    the block runs."""
    relu, bn_forward = torch.relu, BatchNorm.forward
    inputs, valids, index, last_valid = [], [], {}, [None]

    def bn(self, x, channel_dim=1, valid=None):
        last_valid[0] = valid
        return bn_forward(self, x, channel_dim=channel_dim, valid=valid)

    def hooked(x):
        key = (tuple(x.shape), x.detach().cpu().numpy().tobytes())
        if key not in index:
            index[key] = len(inputs)
            inputs.append(x.detach().cpu().numpy().copy())
            v = last_valid[0]
            valids.append(None if v is None or v.shape[0] != x.shape[0] else v.cpu().numpy().copy())
        if pin is None:
            return relu(x)
        i = index[key]
        return torch.where(torch.from_numpy(pin(i, valids[i])).to(x.device), x, 0.0)

    torch.relu, BatchNorm.forward = hooked, bn
    try:
        yield inputs, valids
    finally:
        torch.relu, BatchNorm.forward = relu, bn_forward


def bn_case(case: dict, rank: int, device) -> dict:
    """A synced train-mode BatchNorm on this rank's rows: its output, the
    input gradient of ``sum(y * cotangent)`` and its weight and bias
    gradients (this rank's share), the running statistics after."""
    torch.manual_seed(0)
    bn = BatchNorm(case["channels"], case["eps"], case["momentum"]).to(device)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(case["weight"]))
        bn.bias.copy_(torch.from_numpy(case["bias"]))
    bn.sync = True
    bn.train()
    x = torch.from_numpy(case["x"][rank]).to(device).requires_grad_(True)
    valid = None if case["valid"] is None else torch.from_numpy(case["valid"][rank]).to(device)
    y = bn(x, channel_dim=case["channel_dim"], valid=valid)
    (y * torch.from_numpy(case["cotangent"][rank]).to(device)).sum().backward()
    return {"y": y.detach().cpu(), "x_grad": x.grad.cpu(), "weight_grad": bn.weight.grad.cpu(),
            "bias_grad": bn.bias.grad.cpu(), "running_mean": bn.running_mean.cpu(),
            "running_var": bn.running_var.cpu()}


def overflow_case(case: dict, rank: int, world: int, device) -> dict:
    """One epoch of one step through the Trainer, rank r with
    ``case["cfgs"][r]``: what it raised."""
    cfg = case["cfgs"][rank]
    model = build_model(cfg["model"], device=device, generator=torch.Generator().manual_seed(0), train=True)
    batches = [split_batch(case["batch"], world)[rank]]
    opt, sched = build_optimizer(cfg, 1, list(model.parameters()))
    with tempfile.TemporaryDirectory() as work_dir:
        trainer = Trainer(model, batches, opt, sched, max_epochs=1, log_every_niters=2, work_dir=work_dir,
                          device=device)
        try:
            trainer.train_epoch()
        except RuntimeError as e:
            return {"raised": str(e), "checkpoints": sorted(p.name for p in Path(work_dir).rglob("*.pt"))}
    return {"raised": None}


def moderate_case(case: dict, rank: int, world: int, device) -> dict:
    """One train step of ``utils.moderate``'s detector (weights from seed
    0, synced BatchNorm) on this rank's share of ``beam_batch``: its
    telemetry, overflow, loss and state after the step."""
    from pillarnext_tpu_torch.train.train_state import make_optimizer
    from pillarnext_tpu_torch.utils.moderate import beam_batch, moderate_detector
    from pillarnext_tpu_torch.utils.weights import init_random

    model = moderate_detector(**case["backbone"])
    with torch.no_grad():
        init_random(model, torch.Generator().manual_seed(0))
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.sync = True
    model = model.to(device).train()
    opt, _ = make_optimizer(list(model.parameters()), max_lr=1e-3, total_steps=10)
    batch = split_batch(beam_batch(batch=case["batch"], n_points=case["n_points"]), world)[rank]
    scalars, _ = train_step(model, opt, batch_to_device(batch, device))
    return {"telemetry": {k: int(v) for k, v in scalars["telemetry"].items()},
            "overflow": int(scalars["overflow"]), "loss": float(scalars["loss"]),
            "grad_norm": float(scalars["grad_norm"]),
            "state": {k: v.cpu() for k, v in model.state_dict().items()}}


def cli_case(case: dict) -> dict:
    """``cli.train.main(argv)`` in this rank: its steps, its val
    detections' tokens (rank 0: the union it scored), its val batches and
    what its val epoch returned."""
    from pillarnext_tpu_torch.cli import train as cli_train

    results = []
    val_epoch = Trainer.val_epoch

    def recorded(self):
        results.append(val_epoch(self))
        return results[-1]

    Trainer.val_epoch = recorded
    try:
        trainer = cli_train.main(case["argv"])
    finally:
        Trainer.val_epoch = val_epoch
    return {"step": trainer.step, "epoch": trainer.epoch, "steps_per_epoch": len(trainer.train_dataloader),
            "tokens": sorted(trainer.last_detections), "val_results": results,
            "val_batches": len(trainer.val_timing["batch_s"])}


def main(spec_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    device = parallel.init_from_env("gloo", spec.get("device", "cpu"), timeout_s=spec.get("timeout_s", 60))
    rank, world = parallel.rank(), parallel.world_size()
    out = {"rank": rank, "world_size": world}
    path = Path(out_dir) / f"rank{rank}.pt"
    out["seconds"] = {}
    for name, case in spec["cases"].items():
        kind = case["kind"]
        t0 = time.perf_counter()
        try:
            if kind == "step":
                out[name] = step_case(case, rank, world, device)
            elif kind == "bn":
                out[name] = bn_case(case, rank, device)
            elif kind == "overflow":
                out[name] = overflow_case(case, rank, world, device)
            elif kind == "cli":
                out[name] = cli_case(case)
            elif kind == "moderate":
                out[name] = moderate_case(case, rank, world, device)
            else:
                raise ValueError(f"unknown case kind {kind!r}")
        except Exception:
            out[name] = {"error": traceback.format_exc()}
        out["seconds"][name] = time.perf_counter() - t0
        torch.save(out, path)
    parallel.barrier()
    parallel.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:3])
