"""The benchmark of the PyTorch / CUDA port (``pillarnext_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one cell of ``BENCHMARK.json`` on the card it starts on: set-up
(the kernels' build on a checkout's first run, the pool of batches and the
weights made from the seed, the warm-up), a window of ``--seconds``, the
check against the plain reference, and one JSON line on standard output.
With ``--trace 0`` the line's metrics are the cell's end-to-end metrics;
with ``--trace 1`` a short stretch of the same loop runs under
torch.profiler instead of the window (in eval cells after an untraced
stretch that the host-clock metrics read) and the line carries the
per-layer metrics, the device's busy and window seconds and a breakdown.  The
numbers compared and their limits close standard error and the line.

Exits non-zero, printing no result, without a CUDA card (or fewer than
the cell asks for), when the program cannot be imported, or when JAX or
the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / ".cache"  # fixed, inside the checkout


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seconds <= 0:
        p.error("--seconds must be positive")
    return args


def result(r, correct: bool) -> dict:
    """The run's last line."""
    from benchmark import common

    spec = r.spec
    metrics = spec.per_layer if r.trace else spec.end_to_end
    line = {
        "correct": correct, "attempted": r.attempted, "failed": r.failed,
        "metrics": {m["name"]: {"value": r.metrics[m["name"]], "unit": m["unit"]}
                    for m in metrics if r.metrics.get(m["name"]) is not None},
        "device": {"platform": "gpu", **common.card(r.device), "count": int(spec.cell["chips"]),
                   "memory_peak_bytes": int(r.memory_peak)},
    }
    if r.trace and r.profile is not None:
        line["device"].update(busy_s=r.profile.busy_s, window_s=r.profile.window_s)
        line["breakdown"] = {"device_ops": r.profile.device_ops(), "idle_gaps": r.profile.idle_gaps()}
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in r.checks}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    import torch

    from benchmark import check, common
    from benchmark.spec import Spec

    spec = Spec(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(spec.cell["chips"]):
        print(f"benchmark: the cell needs {spec.cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    r = common.Run(spec, args.seed, args.seconds, bool(args.trace), device, T0)
    importlib.import_module(f"benchmark.modes.{spec.traffic['mode']}").run(r)
    if r.trace:
        for m in spec.per_layer:
            r.metrics[m["name"]] = spec.reader(m["name"])(r)
    found = common.forbidden_modules()
    if found:
        print(f"benchmark: loaded {found}; the benchmark may load none of {common.FORBIDDEN}", file=sys.stderr)
        return 4
    line = result(r, check.correct(r.checks))
    for name, v, lim in r.checks:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
