"""On the card: one short run of each cell through the command the driver
runs, which must print a correct result line.  Skips without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark.spec import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    out = subprocess.run([sys.executable, str(ROOT / "benchmark/run.py"), "--workload", cell, "--seed",
                          "2147483659", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0, line
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
