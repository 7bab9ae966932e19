"""The readings that the correctness limits are set from.

    python3 benchmark/control.py --workload <cell> --seeds <n> ... [--seconds S] [--out FILE]

For each seed, in one process: the sound program's numbers (a run of the
cell with a short window, as ``run.py`` makes it), the control's (the
reference in float8, put in the program's place and judged against the
float32 reference), the reference in bfloat16 (for comparison), and the
program with a fault planted in its timed path: for a training cell half
the batch left out (the mean loss over the rest), for an eval cell half
the batch's frames left out, and each detection moved 1 m where the
predict produces it.  A state left unchanged reads 1 by ``update_gap``'s
measure and needs no run.  Each reading is judged as a run judges it
(``correct``, by the cell's checks file).  For a training cell the
program's and the bfloat16 reference's readings carry a look at single
leaves (``look``: the leaves of the largest update and gradient gaps).
One JSON line per seed and reading on standard output, and all of them
in ``--out``.  Needs a CUDA card; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LOOK_TOP = 3


def half_batch(step):
    """A train step that leaves out the second half of the batch."""
    def broken(model, opt, batch):
        n = int(batch["points"].shape[0]) // 2
        cut = {k: ([t[:n] for t in v] if isinstance(v, list) else v[:n]) for k, v in batch.items()}
        return step(model, opt, cut)
    return broken


def half_frames(predict):
    """A predict that leaves out the second half of the batch's frames."""
    def broken(points, mask):
        n = (int(points.shape[0]) + 1) // 2
        return predict(points[:n], mask[:n])
    return broken


def moved(predict):
    """Each detection's centre moved 1 m where the predict produces it."""
    def broken(points, mask):
        frames = predict(points, mask)
        for f in frames:
            f["boxes"] = f["boxes"].copy()
            f["boxes"][:, 0] += 1.0
        return frames
    return broken


FAULTS = {"train": {"half_batch": half_batch}, "eval": {"half_batch": half_frames, "moved": moved}}


def leaf_look(low: dict, base: dict, names: list, top: int = LOOK_TOP) -> list:
    """The ``top`` leaves of ``names`` whose norms differ most between
    ``low`` and ``base`` (by ``check.gaps``): [name, elements, gap, share of
    elements of the other sign, share of elements under a third of the
    leaf's largest |base|, share of the sum of |low^2 - base^2| that those
    small elements carry]."""
    from benchmark import check, common

    gap = dict(zip(names, check.gaps(common.leaf_norms({n: low[n] for n in names}),
                                     common.leaf_norms({n: base[n] for n in names}), names)))
    out = []
    for n in sorted(names, key=lambda n: -gap[n])[:top]:
        a, b = low[n].double().flatten(), base[n].double().flatten()
        small = b.abs() < b.abs().max() / 3
        diff = (a * a - b * b).abs()
        out.append([n, int(a.numel()), gap[n], float((a.sign() != b.sign()).double().mean()),
                    float(small.double().mean()), float(diff[small].sum() / diff.sum().clamp_min(1e-300))])
    return out


def train_look(weights: dict, params: dict, grads: dict, ref_params: dict, ref_grads: dict) -> dict:
    """The leaves of the largest update gaps (over the leaves that move,
    ``check.MOVING``) and gradient gaps between a run and the reference."""
    import numpy as np

    from benchmark import check, common

    names = list(ref_grads)
    norms = common.leaf_norms(ref_grads)
    med = float(np.median(list(norms.values())))
    moving = [n for n in names if norms[n] >= check.MOVING * med]
    return {"update": leaf_look({n: params[n] - weights[n] for n in moving},
                                {n: ref_params[n] - weights[n] for n in moving}, moving),
            "grad": leaf_look(grads, ref_grads, names)}


def control_values(spec, seed: int, device, precision: str) -> tuple:
    """The reference at ``precision`` against the float32 reference: (its
    numbers, the (control, reference) detections of an eval cell, the
    readings behind a training cell's numbers)."""
    import torch

    from benchmark import check, common
    from benchmark.modes import eval as em
    from benchmark.modes import train as tm
    from benchmark.reference.model import Detector, Precision
    from benchmark.traffic import pool as make_pool

    exp, traffic = spec.config["experiment"], spec.traffic
    batches = [common.to_device(b, device) for b in make_pool(exp, traffic, seed)]
    ref = Detector(exp["model"]).to(device)
    prec = Precision(precision)
    if traffic["mode"] == "train":
        weights = common.make_weights(ref, seed, device, eval_stats=False)
        names = [n for n, _ in ref.named_parameters()]
        sa = tm.schedule_args(exp, spec.config)
        base = tm.reference_steps(ref, weights, batches[:tm.CHECKED_STEPS], exp, sa, names, keep=True)
        low = tm.reference_steps(ref, weights, batches[:tm.CHECKED_STEPS], exp, sa, names, prec, keep=True)
        values = check.train_values(low["losses"], low["first_grad"], low["update"], base)
        return values, [], {"losses": {"control": low["losses"], "reference": base["losses"]},
                            "leaves": {"control_grad": low["first_grad"], "control_update": low["update"],
                                       "reference_grad": base["first_grad"], "reference_update": base["update"]},
                            "look": train_look(weights, low["params"], low["grads"], base["params"], base["grads"])}
    weights = common.make_weights(ref, seed, device, eval_stats=True, base_seed=traffic.get("weights_seed"),
                                  jitter=float(traffic.get("weights_jitter", 0.0)))
    frames = []
    for b in batches[: int(traffic["check_batches"])]:
        frames += list(zip(em.reference_frames(ref, weights, b, exp, prec), em.reference_frames(ref, weights, b, exp)))
    del batches
    torch.cuda.empty_cache()
    return check.eval_values(frames), frames, {}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--readings", nargs="+", default=["program", "float8", "bfloat16", "half_batch", "moved"])
    p.add_argument("--out")
    p.add_argument("--dump", help="a directory for each reading's compared detections (eval cells)")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import check, common
    from benchmark.spec import Spec

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    spec = Spec(args.workload, ROOT)
    kind = spec.traffic["mode"]
    mode = importlib.import_module(f"benchmark.modes.{kind}")
    records = []
    for seed in args.seeds:
        for reading in args.readings:
            if reading not in ("program", "float8", "bfloat16") and reading not in FAULTS[kind]:
                continue
            t0 = time.perf_counter()
            if reading in ("float8", "bfloat16"):
                values, frames, extra = control_values(spec, seed, device, reading)
            else:
                r = common.Run(spec, seed, args.seconds, False, device, t0)
                r.keep = kind == "train" and reading == "program"
                mode.run(r, program=FAULTS[kind].get(reading))
                values = r.values
                extra = {"metrics": r.metrics, "failed": r.failed, **r.extra}
                if r.keep:
                    k = r.kept
                    extra["look"] = train_look(k["weights"], k["program"], k["program_grad"], k["reference"],
                                               k["reference_grad"])
                    r.kept = {}
                frames = getattr(r, "frames", [])
            if args.dump and frames:
                import numpy as np
                Path(args.dump).mkdir(parents=True, exist_ok=True)
                np.savez_compressed(Path(args.dump) / f"{args.workload}_{seed}_{reading}.npz", **{
                    f"{side}{i}_{k}": f[j][k] for i, f in enumerate(frames) for j, side in enumerate(("p", "r"))
                    for k in ("boxes", "scores", "labels")})
            rec = {"workload": args.workload, "seed": seed, "reading": reading, "values": values,
                   "correct": check.correct(check.rated(args.workload, values)),
                   "seconds": time.perf_counter() - t0, **extra}
            print(json.dumps(rec, default=float), flush=True)
            records.append(rec)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                Path(args.out).write_text(json.dumps(records, default=float, indent=1))
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
