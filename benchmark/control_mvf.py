"""The readings that the MVF training cell's correctness limits are set
from: ``control.py``'s, for a cell of mode ``train_mvf``.

    python3 benchmark/control_mvf.py --workload <cell> --seeds <n> ... [--seconds S] [--out FILE]

For each seed, in one process: the sound program's numbers (a run of the
cell with a short window, with its pillar and cylinder occupancy), the
reference in float8 and in bfloat16 against the float32 reference, and
the program with half the batch left out (``control.half_batch``).  A
state left unchanged reads 1 by ``update_gap``'s measure and needs no
run.  Each reading is judged by the cell's checks file.  One JSON line
per seed and reading on standard output, and all of them in ``--out``.
Needs a CUDA card; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_values(spec, seed: int, device, precision: str) -> tuple:
    """The reference at ``precision`` against the float32 reference: (its
    numbers, the readings behind them)."""
    from benchmark import common
    from benchmark.control import train_look
    from benchmark.modes import train_mvf
    from benchmark.modes.train import CHECKED_STEPS
    from benchmark.reference.model import Precision
    from benchmark.reference.mvf import MVFDetector

    exp = spec.config["experiment"]
    batches = [common.to_device(b, device) for b in train_mvf.make_pool(exp, spec.traffic, seed)][:CHECKED_STEPS]
    ref = MVFDetector(exp["model"]).to(device)
    weights = common.make_weights(ref, seed, device, eval_stats=False)
    names = [n for n, _ in ref.named_parameters()]
    sa = train_mvf.schedule(exp, spec.config)
    base = train_mvf.reference_steps(ref, weights, batches, exp, sa, names, keep=True)
    low = train_mvf.reference_steps(ref, weights, batches, exp, sa, names, Precision(precision), keep=True)
    values = train_mvf.values(low["losses"], low["first_grad"], low["update"], base)
    return values, {"losses": {"control": low["losses"], "reference": base["losses"]},
                    "leaves": {"control_grad": low["first_grad"], "control_update": low["update"],
                               "reference_grad": base["first_grad"], "reference_update": base["update"]},
                    "look": train_look(weights, low["params"], low["grads"], base["params"], base["grads"])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--readings", nargs="+", default=["program", "float8", "bfloat16", "half_batch"])
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import check, common
    from benchmark.control import half_batch, train_look
    from benchmark.modes import train_mvf
    from benchmark.spec import Spec

    if not torch.cuda.is_available():
        print("control_mvf: needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    spec = Spec(args.workload, ROOT)
    records = []
    for seed in args.seeds:
        for reading in args.readings:
            t0 = time.perf_counter()
            if reading in ("float8", "bfloat16"):
                values, extra = control_values(spec, seed, device, reading)
            else:
                r = common.Run(spec, seed, args.seconds, False, device, t0)
                r.keep = reading == "program"
                train_mvf.run(r, program=half_batch if reading == "half_batch" else None)
                values = r.values
                extra = {"metrics": r.metrics, "failed": r.failed, "memory_peak": r.memory_peak, **r.extra}
                if r.keep:
                    k = r.kept
                    extra["look"] = train_look(k["weights"], k["program"], k["program_grad"], k["reference"],
                                               k["reference_grad"])
                    r.kept = {}
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
