"""CPU tests of the harness: its arguments, its last line, finding a
cell's files by name, and BENCHMARK.json's names and metrics."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import common, run
from benchmark.spec import NAME, ROOT, UNIT, Spec
from benchmark.trace import merged, union_us

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_arguments():
    a = run.parse(["--workload", "pp18-train-b6", "--seed", str(2**31 + 12345), "--seconds", "30", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("pp18-train-b6", 2**31 + 12345, 30.0, 1)
    assert run.parse(["--workload", "x", "--seed", "1", "--seconds", "1"]).trace == 0
    for bad in (["--workload", "x", "--seed", "1", "--seconds", "0"],
                ["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"],
                ["--seed", "1", "--seconds", "1"]):
        with pytest.raises(SystemExit):
            run.parse(bad)


def test_without_a_card_it_exits_non_zero_and_prints_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "benchmark/run.py"), "--workload", "pp18-train-b6",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}, timeout=300)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_without_the_program_it_exits_non_zero(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "pp18-eval-b4", "--seed", "1",
                          "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "correct" not in out.stdout


class _Profile:
    busy_s, window_s = 0.8, 1.0

    def device_ops(self):
        return [["k", 0.5]]

    def idle_gaps(self):
        return [["bench.head", 0.1]]


def test_last_line_schema(monkeypatch):
    monkeypatch.setattr(common, "card", lambda d: {"kind": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"})
    spec = Spec("pp18-eval-b4")
    r = common.Run(spec, 7, 1.0, False, torch.device("cpu"), 0.0)
    r.metrics = {"setup_s": 12.5, "eval_frames_per_s": 30.0, "eval_batch_ms_p95": 140.0, "eval_mfu": 3.0}
    r.attempted, r.failed, r.memory_peak = 400, 0, 123
    r.checks = [("top_missed", 0.01, 0.1), ("score_gap", 0.02, 0.05)]
    line = json.loads(json.dumps(run.result(r, True)))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["metrics"] == {"eval_frames_per_s": {"value": 30.0, "unit": "frames/s"},
                               "eval_batch_ms_p95": {"value": 140.0, "unit": "ms"},
                               "setup_s": {"value": 12.5, "unit": "s"}}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["device"]["memory_peak_bytes"] == 123
    assert line["checks"]["score_gap"] == {"value": 0.02, "limit": 0.05}
    r.trace, r.profile = True, _Profile()
    r.metrics.update({"idle_pct.eval": 20.0})
    line = run.result(r, True)
    assert list(line)[-1] == "checks" and "breakdown" in line
    assert line["device"]["busy_s"] == 0.8 and line["device"]["window_s"] == 1.0
    assert set(line["metrics"]) == {"eval_mfu", "idle_pct.eval"}


def test_names_and_units():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for e in BENCH["workloads"]:
        assert NAME.match(e["config"]) and NAME.match(e["traffic"])
        assert 0 < len(e["why"]) <= 200 and e["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))


def test_each_per_layer_metric_is_reported_where_its_end_to_end_metric_is():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    for cell in cells:
        assert any("workloads" not in m or cell in m["workloads"] for m in BENCH["per_layer"])
        assert sum(1 for m in BENCH["end_to_end"] if "workloads" not in m or cell in m["workloads"]) >= 2


def test_a_new_cell_is_found_by_name(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and new entries, no other file edited."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / bench["configs"][0]["file"]).read_text())
    (tmp_path / "benchmark/configs/extra_cfg.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark/traffic/extra_mix.json").write_text(json.dumps({"mode": "eval", "batch": 2}))
    (tmp_path / "benchmark/metrics/extra_metric.py").write_text("def read(r):\n    return 42.0\n")
    bench["configs"].append(dict(bench["configs"][0], name="extra_cfg", file="benchmark/configs/extra_cfg.json"))
    bench["workloads"].append({"name": "extra-cell", "config": "extra_cfg", "traffic": "extra_mix", "chips": 1,
                               "why": "a later cell"})
    bench["per_layer"].append({"name": "extra_metric", "unit": "ms", "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "setup_s", "workloads": ["extra-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec("extra-cell", tmp_path)
    assert spec.traffic == {"mode": "eval", "batch": 2}
    assert spec.config == cfg
    assert [m["name"] for m in spec.per_layer] == ["extra_metric"]
    assert spec.reader("extra_metric")(None) == 42.0
    assert {m["name"] for m in spec.end_to_end} == {"setup_s"}


def test_every_cell_has_its_files():
    for w in BENCH["workloads"]:
        spec = Spec(w["name"])
        assert spec.traffic["mode"] in ("train", "eval")
        assert (ROOT / "benchmark" / "modes" / f"{spec.traffic['mode']}.py").exists()
        assert "experiment" in spec.config


def test_busy_time_is_the_union_of_device_intervals():
    assert merged([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]
    assert union_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0


def test_the_benchmark_and_its_reference_load_no_jax():
    """By each module's whole top-level name: the port's own name begins
    with the JAX package's, and must not match it."""
    code = ("import sys; sys.path.insert(0, %r); import benchmark.run, benchmark.control, benchmark.modes.train, "
            "benchmark.modes.eval, benchmark.check, benchmark.counts, benchmark.readers; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))") % str(ROOT)
    tops = json.loads(subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                                     timeout=300).stdout.replace("'", '"'))
    assert not set(tops) & {"jax", "jaxlib", "flax", "pillarnext_tpu"}
    ref = ("import sys; sys.path.insert(0, %r); import benchmark.reference.model, benchmark.reference.loss, "
           "benchmark.reference.postprocess, benchmark.traffic; "
           "print(sorted({m.split('.')[0] for m in sys.modules}))") % str(ROOT)
    tops = json.loads(subprocess.run([sys.executable, "-c", ref], capture_output=True, text=True, check=True,
                                     timeout=300).stdout.replace("'", '"'))
    assert not set(tops) & {"jax", "jaxlib", "flax", "pillarnext_tpu", "pillarnext_tpu_torch"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pillarnext_tpu_torch_fake", object())
    assert "pillarnext_tpu" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in common.forbidden_modules()


def test_metric_files_are_named_from_metric_names():
    for p in (ROOT / "benchmark" / "metrics").glob("*.py"):
        assert re.match(r"^[A-Za-z0-9_][A-Za-z0-9_.-]*\.py$", p.name)
