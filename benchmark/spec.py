"""What a run measures, found by name: the cell in ``BENCHMARK.json``, its
configuration (``benchmark/configs/<config>.json``), its traffic
(``benchmark/traffic/<traffic>.json``) and the reader of each per-layer
metric (``benchmark/metrics/<metric>.py``, a ``read(run)`` that returns a
number or None).  Adding a cell, a configuration, a mix or a metric adds
files and entries; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Spec:
    """One cell's entries: ``cell``, ``config`` (the file's contents),
    ``traffic``, ``end_to_end`` and ``per_layer`` (the metrics it reports)."""

    def __init__(self, workload: str, root: Path = ROOT):
        self.root = Path(root)
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {c["name"]: c for c in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
        self.cell = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = json.loads((self.root / configs[self.cell["config"]]["file"]).read_text())
        self.traffic = json.loads((self.root / "benchmark" / "traffic" / f"{self.cell['traffic']}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"] if reports(m, workload)]
        self.per_layer = [m for m in bench["per_layer"] if reports(m, workload)]

    def reader(self, metric: str):
        """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
        path = self.root / "benchmark" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]
