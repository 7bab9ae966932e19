"""``chip_smoke.py``'s device timing on the CPU, with torch.profiler
replaced by a stand-in that loses records the way the real one at times
does on the card: the marker kernels between calls cut a window into
calls, only whole calls are counted, and a window with none is profiled
again.  Also the detection comparison: one prediction matches itself in
full at 50 m coordinates."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from pillarnext_tpu_torch.utils import profiling
from tests.torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


def _window(calls, lose=()):
    """Device records of a window: a marker, then each call's (name, us)
    records and a marker, in start order but listed shuffled; ``lose``
    holds the indices of records to drop."""
    names = [profiling.MARKER]
    for call in calls:
        names += [*call, profiling.MARKER]
    records = []
    for t, rec in enumerate(names):
        name, us = (rec, 1.0) if rec == profiling.MARKER else rec
        records.append(SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA, name=name,
                                       device_time=us, time_range=SimpleNamespace(start=float(t))))
    kept = [r for i, r in enumerate(records) if i not in set(lose)]
    return kept[1::2] + kept[::2]


@pytest.fixture
def profiler(monkeypatch):
    """Install a torch.profiler.profile whose successive windows hold the
    given records (the last one repeats); returns the windows opened."""
    import torch.profiler

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda *a: None)
    opened = []

    def install(windows):
        class Profile:
            def __init__(self, *args, **kwargs):
                self.records = windows[min(len(opened), len(windows) - 1)]
                opened.append(self)

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def events(self):
                return self.records

        monkeypatch.setattr(torch.profiler, "profile", Profile)
        return opened

    return install


def test_device_profile_profiles_again_until_a_whole_window(profiler):
    calls = 4
    whole = [[("tile", 50.0), ("fill", 10.0)]] * calls
    # every call of the second window lost its fill
    opened = profiler([[], _window(whole, lose=(2, 5, 8, 11)), _window(whole)])
    ran = []
    prof = chip_smoke.device_profile(lambda: ran.append(1), calls, launches=2)
    assert len(opened) == 3
    assert len(ran) == 1 + 3 * calls  # one warm-up call, then each window's calls
    assert prof["device_launches_per_call"] == 2 and prof["device_whole_calls"] == calls
    assert prof["device_ms_by_kernel"] == {"tile": pytest.approx(0.05), "fill": pytest.approx(0.01)}
    assert prof["device_ms"] == pytest.approx(0.06)


def test_device_profile_counts_only_whole_calls(profiler):
    """A lost record drops its call; a lost marker merges two calls, and
    both drop; the rest give the device time of a whole call."""
    calls = 6
    window = _window([[("tile", 50.0 + i), ("fill", 10.0)] for i in range(calls)],
                     lose=(2, 6))  # call 0's fill; the marker after call 1
    opened = profiler([window])
    prof = chip_smoke.device_profile(lambda: None, calls)
    assert len(opened) == 1
    assert prof["device_launches_per_call"] == 2 and prof["device_whole_calls"] == 3
    assert prof["device_ms_by_kernel"] == {"tile": pytest.approx(0.054), "fill": pytest.approx(0.01)}


def test_profile_device_without_ops_traces_the_card_alone(profiler, monkeypatch):
    """A path profile without ``ops`` asks torch.profiler for the card's
    activity alone and reports no top ops; its busy time, launches and
    top kernels come from the device records as with them."""
    import torch.profiler

    opened = profiler([_window([[("tile", 50.0), ("fill", 10.0)]] * 2)])
    kinds = []
    real = torch.profiler.profile
    monkeypatch.setattr(torch.profiler, "profile", lambda *a, **k: kinds.append(k["activities"]) or real(*a, **k))
    prof = chip_smoke.profile_device(lambda: None, 2, ops=False)
    assert len(opened) == 1 and kinds == [[torch.profiler.ProfilerActivity.CUDA]]
    assert prof["top_ops_ms_per_step"] is None and prof["launches_per_step"] == 3.5  # 4 kernels, 3 markers
    assert prof["device_busy_ms_per_step"] == pytest.approx((2 * 60.0 + 3.0) / 1e3 / 2)


def test_device_profile_fails_without_device_records(profiler):
    opened = profiler([[]])
    with pytest.raises(AssertionError, match="no whole call"):
        chip_smoke.device_profile(lambda: None, 3)
    assert len(opened) == profiling.PROFILE_WINDOWS


def test_tools_device_ms_is_device_profile_on_the_card_only(profiler):
    """The measurement tools' ``profiling.device_ms`` is the guarded
    ``device_profile`` (a lost record drops its call) on a CUDA device, and
    None, with nothing profiled, on the CPU."""
    opened = profiler([_window([[("tile", 50.0), ("fill", 10.0)], [("tile", 50.0)], [("tile", 70.0), ("fill", 10.0)]])])
    assert profiling.device_ms(lambda: None, "cpu", 3) is None and opened == []
    assert profiling.device_ms(lambda: None, "cuda:0", 3) == pytest.approx(0.07)
    assert len(opened) == 1


def test_child_probe_reports_the_rank_and_runs_the_shadowed_sitecustomize(tmp_path):
    """A process started with RANK and ``child_probe`` first on its path
    writes its ``rank_record`` at its exit, and the interpreter's own
    ``sitecustomize`` (here a stand-in later on the path; the H100
    machine's Python has one) still runs."""
    import json
    import os
    import subprocess

    interp = tmp_path / "interp"
    interp.mkdir()
    (interp / "sitecustomize.py").write_text(f"open({str(tmp_path / 'ran')!r}, 'w').close()\n")
    out = tmp_path / "ranks"
    out.mkdir()
    env = dict(os.environ, RANK="3", PYTHONPATH=os.pathsep.join([str(chip_smoke.child_probe(out)), str(interp)]))
    subprocess.run([sys.executable, "-c", "pass"], env=env, check=True, timeout=120)
    rec = json.loads((out / "rank3.json").read_text())
    assert (tmp_path / "ran").exists()
    assert rec["rank"] == 3 and rec["foreign_modules"] == []
    assert rec["launches"] == {k.__name__: 0 for k in chip_smoke.kernel_counters()}


def test_matched_fraction_of_one_prediction_at_50_m_is_one():
    """830 boxes with centres up to 50 m out, compared with themselves:
    every box matches (cdist's matrix-product form put 9% of them more
    than 1 cm from themselves), and the prediction is the same bits."""
    g = torch.Generator().manual_seed(0)
    pred = {"box3d_lidar": torch.rand(1, 830, 9, generator=g) * 100 - 50,
            "label_preds": torch.randint(0, 10, (1, 830), generator=g),
            "scores": torch.rand(1, 830, generator=g),
            "valid": torch.ones(1, 830, dtype=torch.bool)}
    assert chip_smoke.matched_fraction(pred, dict(pred)) == 1.0
    assert chip_smoke.same_prediction(pred, {k: v.clone() for k, v in pred.items()})
    moved = dict(pred, box3d_lidar=pred["box3d_lidar"] + torch.tensor([0.02] + [0.0] * 8))
    assert chip_smoke.matched_fraction(pred, moved) == 0.0
    assert not chip_smoke.same_prediction(pred, moved)


def test_backbone_mode_lists_build_their_modes():
    """Each serving and training override of the stage-mode paths resolves
    on the flagship YAML (narrowed here) and builds a backbone in that
    mode; the five modes held against leading are serving paths."""
    from pillarnext_tpu_torch.utils.builders import build_model
    from pillarnext_tpu_torch.utils.config import load_experiment
    from tests.test_torch_port_e2e import FLAGSHIP, OVERRIDES

    assert len(chip_smoke.SERVING_MODES) == 7 and len(chip_smoke.TRAIN_MODES) == 6
    assert set(chip_smoke.EXACT_MODES) < set(chip_smoke.SERVING_MODES) and len(chip_smoke.EXACT_MODES) == 5
    expected = {
        "serving_tile": ("sparse_stages_eval", "tile"), "serving_leading_down": ("sparse_stages_eval", "leading+down"),
        "serving_all": ("sparse_stages_eval", "all"), "serving_packed": ("packed_downsample", True),
        "serving_dense_first": ("sparse_eval", False), "serving_unmasked": ("masked_eval", False),
        "serving_dense_image": ("strides", (2, 2, 2, 1)), "train_tile_stride1": ("tile_stride1", True),
        "train_tile": ("sparse_stages_train", "tile"), "train_leading": ("sparse_stages_train", "leading"),
        "train_leading_down": ("sparse_stages_train", "leading+down"),
        "train_force_dense": ("force_dense_train", True), "train_dense_image": ("strides", (2, 2, 2, 1)),
    }
    for path, override in {**chip_smoke.SERVING_MODES, **chip_smoke.TRAIN_MODES}.items():
        model = build_model(load_experiment(FLAGSHIP, OVERRIDES + [override])["model"], device="cpu")
        attr, value = expected[path]
        assert getattr(model.backbone, attr) == value, (path, attr)
        # the dense-image strides take the reader's dense image
        assert (model.reader.output == "dense") == (attr == "strides"), path
    assert build_model(load_experiment(FLAGSHIP, OVERRIDES)["model"], device="cpu").backbone.sparse_eval


def test_option_lists_build_their_options():
    """Each override of the option paths resolves on the flagship YAML
    (narrowed here) and builds the option; the dense voxel paths' overrides
    build voxel18 with the dense volume, the training one on a 40 x 672 x
    672 grid at the config's voxel size."""
    from pillarnext_tpu_torch.utils.builders import build_model
    from pillarnext_tpu_torch.utils.config import load_experiment
    from tests.test_torch_port_e2e import FLAGSHIP, OVERRIDES

    assert set(chip_smoke.SAME_FUNCTION) < set(chip_smoke.OPTION_PATHS)
    narrow = [o for o in OVERRIDES if "num_filters=[16,16]" not in o]
    checks = {
        "serving_head_unfused": lambda m: not any(t.fuse_eval for t in m.head.tasks),
        "serving_merge_branches": lambda m: all(t.merge_branches for t in m.head.tasks),
        "serving_merge_tasks": lambda m: m.head.merge_tasks,
        "serving_pfn_unfused": lambda m: not m.reader.kernel_eval and len(m.reader.pfn_layers) == 2,
        "serving_pfn3": lambda m: not m.reader.kernel_eval and len(m.reader.pfn_layers) == 3,
        "serving_circle_nms": lambda m: m.post_processing["nms_type"] == "circle",
        "serving_approx_topk": lambda m: m.post_processing["approx_topk"],
        "train_merge_tasks": lambda m: m.head.merge_tasks,
        "train_merge_branches": lambda m: all(t.merge_branches for t in m.head.tasks),
        "train_no_save_conv_out": lambda m: not m.backbone.remat_save_conv_out,
    }
    for path, override in {**chip_smoke.OPTION_PATHS, **chip_smoke.OPTION_TRAIN}.items():
        width = ["model.reader.num_filters=[16,16]"] if path != "serving_pfn3" else []
        model = build_model(load_experiment(FLAGSHIP, narrow + width + [override])["model"], device="cpu")
        assert checks[path](model), path
    default = build_model(load_experiment(FLAGSHIP, OVERRIDES)["model"], device="cpu")
    assert default.reader.kernel_eval and all(t.fuse_eval for t in default.head.tasks)
    for overrides, grid in (([chip_smoke.VOXEL_DENSE], (40, 1344, 1344)), (chip_smoke.VOXEL_DENSE_TRAIN, (40, 672, 672))):
        cfg = load_experiment(chip_smoke.VOXEL18, overrides)["model"]
        model = build_model(cfg, device="cpu")
        assert model.reader.output == "dense"
        assert (model.reader.grid.size_z, model.reader.grid.size_y, model.reader.grid.size_x) == grid


def test_f32_agreement_holds_the_backbone_output_at_1e3():
    g = torch.Generator().manual_seed(0)
    ref = torch.randn(1, 8, 8, 16, generator=g) * 10
    assert chip_smoke.f32_agreement(ref * (1 + 5e-4) + 5e-4, ref)["f32_bev_within_1e3"]
    off = ref.clone()
    off[0, 3, 3, 3] += 1e-3 + 1.1e-3 * off[0, 3, 3, 3].abs()
    rec = chip_smoke.f32_agreement(off, ref)
    assert not rec["f32_bev_within_1e3"] and rec["f32_bev_max_excess_over_rtol"] > 1e-3


def test_cli_tree_reads_back_through_the_port_pipeline(tmp_path, monkeypatch):
    """The nuScenes-format tree of the CLI phases, at 2,000 points a sweep:
    each sample's 10 sweeps come back in the keyframe's frame (the sweeps'
    transforms undo the ego motion they were written under), the val infos
    carry their GT, the port's ``create_groundtruth_database`` cuts a GT
    database from the train split's own boxes under the names the YAML
    reads, and the train pipeline (GT paste, augmentations, targets) runs
    on it with no path override but the root."""
    import numpy as np

    from pillarnext_tpu_torch.utils.builders import build_dataset
    from pillarnext_tpu_torch.utils.config import load_experiment

    monkeypatch.setattr(chip_smoke, "SWEEP_POINTS", 2000)
    cfg = load_experiment(chip_smoke.FLAGSHIP)
    names = [n for task in cfg["data"]["train_dataset"]["class_names"] for n in task]
    tree = chip_smoke.write_nuscenes_tree(tmp_path / "nusc", cfg["model"]["reader"]["pc_range"], names, seed=0)
    assert tree["samples"] == {"train": 8, "val": 8} and tree["points_per_sample"] == [20000, 20000]
    assert 20 <= tree["gt_boxes_per_sample"][0] <= tree["gt_boxes_per_sample"][1] <= 40

    db = chip_smoke.gt_database("nuscenes", tmp_path / "nusc", chip_smoke.nuscenes_infos("train"), 10, names)
    assert sorted(db["crops_per_class"]) == sorted(names) and sum(db["crops_per_class"].values()) > 100
    assert db["classes_without_crops"] == [n for n in names if not db["crops_per_class"][n]]
    assert 0 <= db["points_per_crop"][0] <= db["points_per_crop"][1] and db["host_seconds"] > 0
    assert (tmp_path / "nusc/dbinfos_train_10sweeps_withvelo.pkl").is_file()

    overrides = [f"data.train_dataset.root_path={tmp_path / 'nusc'}", "data.train_dataset.resampling=false"]
    cfg = load_experiment(chip_smoke.FLAGSHIP, overrides)
    val = build_dataset(cfg["data"]["val_dataset"])
    sample = val.get(0, np.random.RandomState(0))
    pts, info = sample["points"], val.infos[0]
    assert 19000 < len(pts) <= 20000
    np.testing.assert_allclose(np.unique(pts[:, 4]), 0.05 * np.arange(10), atol=1e-6)
    # the last sweep (written 4.5 m back) lands on the keyframe's surfaces:
    # its points' median distance to the nearest keyframe point is ~cm
    key, sweep = pts[pts[:, 4] == 0, :2], pts[np.isclose(pts[:, 4], 0.45), :2]
    near = np.sqrt(((sweep[:200, None] - key[None]) ** 2).sum(-1)).min(1)
    assert np.median(near) < 0.25
    assert len(info["gt_boxes"]) == len(info["gt_names"]) >= 20

    host = chip_smoke.pipeline_host_ms(cfg["data"]["train_dataset"], 30000, 4)
    assert host["samples"] == 8 and 0 < host["gt_paste_ms_per_sample"] < host["ms_per_sample"]


def test_waymo_tree_gt_database_and_nlz_filter(tmp_path, monkeypatch):
    """The Waymo tree of ``cli_waymo`` at 4,000 points a frame: the
    converter's schema (6 columns, a few percent flagged as no-label
    zone, up to 4 prior frames as sweeps), a GT database cut by the port's
    tool under the name the YAML reads, the NLZ check on a loaded train and
    val batch (a flagged point that leaks in fails it), and the train pipeline (GT paste from that database, 3 sweeps,
    augmentations, targets) on it."""
    import pickle

    import numpy as np

    from pillarnext_tpu_torch.data.collate import collate
    from pillarnext_tpu_torch.utils.builders import build_dataset
    from pillarnext_tpu_torch.utils.config import load_experiment

    monkeypatch.setattr(chip_smoke, "N_POINTS", 4000)
    cfg = load_experiment(chip_smoke.WAYMO_PP18)
    names = [n for task in cfg["data"]["train_dataset"]["class_names"] for n in task]
    root = tmp_path / "waymo"
    tree = chip_smoke.write_waymo_tree(root, cfg["model"]["reader"]["pc_range"], names, seed=1)
    assert tree["frames"] == {"train": 8, "val": 8} and tree["points_per_frame_before_nlz"] == [4000, 4000]
    assert 0 < tree["nlz_fraction"][0] <= tree["nlz_fraction"][1] < 0.5
    infos = pickle.load(open(root / "waymo_infos_val.pkl", "rb"))
    assert [len(i["sweeps"]) for i in infos] == [0, 1, 2, 3, 4, 4, 4, 4]
    assert infos[5]["sweeps"][0]["token"] == infos[4]["token"]
    assert infos[5]["sweeps"][0]["timestamp"] == pytest.approx(0.1)
    assert {o["label"] for i in infos for o in i["objects"]} == set(names)
    flags = np.fromfile(root / "lidar_point" / f"{infos[0]['token']}.bin", np.float32).reshape(-1, 6)[:, 5]
    assert set(np.unique(flags)) == {-1.0, 1.0}

    db = chip_smoke.gt_database("waymo", root, "waymo_infos_train.pkl", 1, names)
    assert (root / "dbinfos_train_1sweeps_withvelo.pkl").is_file() and sum(db["crops_per_class"].values()) > 10
    overrides = [f"data.train_dataset.root_path={root}"]
    cfg = load_experiment(chip_smoke.WAYMO_PP18, overrides)
    train, val = (build_dataset(cfg["data"][f"{split}_dataset"]) for split in ("train", "val"))
    batches = {name: collate([ds.get(i, np.random.RandomState(i)) for i in range(4)], 12000,
                             np.random.default_rng(0)) for name, ds in (("train", train), ("val", val))}
    nlz = chip_smoke.nlz_filtered(batches, root, 3)
    assert nlz["flagged_points_loaded"] == {"train": 0, "val": 0}
    assert all(got == want for got, want in nlz["val_points_loaded_vs_unflagged"])
    assert nlz["val_points_loaded_vs_unflagged"][3][0] > 2 * tree["points_per_frame_after_nlz"][0]  # 3 sweeps
    leaked = dict(batches["train"], points=batches["train"]["points"].copy())
    leaked["points"][0, 0, 3] = chip_smoke.NLZ_INTENSITY
    with pytest.raises(AssertionError, match="NLZ-flagged points loaded"):
        chip_smoke.nlz_filtered(dict(batches, train=leaked), root, 3)

    sample = train.get(2, np.random.RandomState(0))
    assert sample["points"].shape[1] == 5 and len(sample["hm"]) == 2


def test_parity_phases_print_their_fields_and_fail_on_a_miss(capsys):
    """The four parity phases and the fields of their JSON line, from a
    CPU run of the port's flagship tool at a small grid; a phase whose
    tool misses its bar raises, and so does one whose kernels never
    launched (on the CPU the wrappers take their plain versions)."""
    import json

    from pillarnext_tpu_torch.tools import flagship_parity
    from tests.test_torch_port_parity_tools import FLAGSHIP_OVERRIDES

    assert chip_smoke.PARITY_PHASES == ("parity_flagship", "parity_flagship_trained", "parity_voxel18_trained",
                                        "parity_mvf_trained")
    rec = flagship_parity.run(points=3000, device="cpu", overrides=FLAGSHIP_OVERRIDES, log=lambda s: None)
    launches = {name: 1 for name in chip_smoke.KERNELS}
    line = chip_smoke.parity_record("parity_flagship", rec, launches)
    assert set(chip_smoke.PARITY_FIELDS) <= set(line) and line["overfit_seconds"] is None
    assert line["detections"] == [rec["ref"], rec["ours"]] and line["launches"] == launches
    assert json.loads(json.dumps(line))["phase"] == "parity_flagship"

    def miss(log):
        raise AssertionError("count mismatch: ref 3 vs ours 2")

    with pytest.raises(AssertionError, match="count mismatch"):
        chip_smoke.parity_phase("parity_flagship", miss, chip_smoke.KERNELS)
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.parity_phase("parity_flagship", lambda log: rec, chip_smoke.KERNELS)
    assert '"phase": "parity_flagship"' in capsys.readouterr().out


def test_parity_processes_write_their_lines_and_fail_on_a_miss(tmp_path, monkeypatch, capsys):
    """voxel18's and MVF's trained parity run in processes of their own:
    each is a ``parity-worker`` of this script; a worker writes its
    ``parity_record`` and its process's seconds; the script prints each
    awaited line, and fails when a process failed or a kernel of its phase
    never launched."""
    import json
    import subprocess

    assert chip_smoke.PARITY_PROCESSES == ("parity_voxel18_trained", "parity_mvf_trained")
    assert set(chip_smoke.PARITY_PROCESSES) <= set(chip_smoke.PARITY_PHASES)
    started = []
    monkeypatch.setattr(subprocess, "Popen", lambda cmd, **kw: started.append(cmd) or cmd)
    procs = chip_smoke.start_parity_processes(tmp_path)
    assert [cmd[2:4] for cmd in started] == [["parity-worker", p] for p in chip_smoke.PARITY_PROCESSES]
    assert started[0][1].endswith("chip_smoke.py") and started[0][4] == str(procs["parity_voxel18_trained"][1])
    monkeypatch.undo()

    phase = "parity_mvf_trained"
    rec = {"ref": 3, "ours": 3, "matched": 1.0, "detections": [[1], [1]], "overfit_seconds": 2.0}
    monkeypatch.setattr(chip_smoke, "PARITY_PHASES", (phase,))
    monkeypatch.setattr(torch.cuda, "set_device", lambda *a: None)
    for launched in (1, 0):
        def run(log, launched=launched):
            chip_smoke.kernel_counters()[1].launches += launched
            chip_smoke.kernel_counters()[2].launches += launched
            return rec

        monkeypatch.setattr(chip_smoke, "parity_run", lambda p, device, run=run: (run, chip_smoke.KERNELS[1:]))
        out = tmp_path / f"{launched}.json"
        chip_smoke.parity_worker(phase, str(out))
        line = json.loads(out.read_text())
        assert line["phase"] == phase and line["detections"] == [3, 3] and line["process_seconds"] > 0
        done = subprocess.Popen([sys.executable, "-c", "pass"])
        if launched:
            assert chip_smoke.parity_paths("cpu", {phase: (done, out, tmp_path / "log")})[phase] == line["launches"]
            assert json.loads(capsys.readouterr().out.splitlines()[-1])["process_seconds"] == line["process_seconds"]
        else:
            with pytest.raises(AssertionError, match="never launched"):
                chip_smoke.parity_paths("cpu", {phase: (done, out, tmp_path / "log")})
    failed = subprocess.Popen([sys.executable, "-c", "raise SystemExit(3)"])
    with pytest.raises(AssertionError, match="failed, exit codes \\[3\\]"):
        chip_smoke.parity_paths("cpu", {phase: (failed, out, tmp_path / "log")})


def test_phase_records_carry_their_seconds(capsys, monkeypatch):
    """Every phase line carries its own seconds (since the phase line
    before it); the ``phase_seconds`` figures sum a phase's lines."""
    import json

    monkeypatch.setattr(chip_smoke, "PHASE_SECONDS", {})
    monkeypatch.setattr(chip_smoke, "RECORDS", {})
    for record in ({"phase": "main_path", "path": "serving"}, {"phase": "kernel_vs_plain"},
                   {"phase": "kernel_vs_plain"}, {"phase": "frame_profile", "path": "serving"}, {"kernels": []}):
        chip_smoke.emit(record)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert all(line["seconds"] >= 0 and line["script_seconds"] >= line["seconds"] for line in lines[:4])
    assert "seconds" not in lines[4]
    assert set(chip_smoke.PHASE_SECONDS) == {"serving", "kernel_vs_plain", "frame_profile/serving"}
    assert chip_smoke.PHASE_SECONDS["kernel_vs_plain"] == pytest.approx(lines[1]["seconds"] + lines[2]["seconds"])
    assert chip_smoke.RECORDS["serving"] == lines[0]


@pytest.fixture
def narrowed_tools(monkeypatch):
    """The measurement tools' phases on the CPU at a small grid: each
    tool's config narrowed as tests/test_torch_port_e2e.py narrows the
    flagship (the probe's head keeps the mirror's 64 channels), 3,000
    points, one rep, step and run, a tree of 8 samples at no workers, and
    no kernel required (the CPU launches none)."""
    from pillarnext_tpu_torch.tools import baseline_probe, eval_breakdown, train_breakdown
    from tests.test_torch_port_e2e import OVERRIDES

    probe = [o for o in OVERRIDES if "share_conv_channel" not in o]
    for module, extra in ((eval_breakdown, OVERRIDES), (train_breakdown, OVERRIDES), (baseline_probe, probe)):
        monkeypatch.setattr(module, "load_experiment",
                            lambda path, overrides=(), real=module.load_experiment, extra=extra:
                            real(path, [*extra, *overrides]))
    for name, value in (("N_POINTS", 3000), ("BREAKDOWN_REPS", 1), ("BREAKDOWN_STEPS", 1), ("PROBE_RUNS", 1),
                        ("LOADER_TRIPS", 1), ("LOADER_WORKERS", (0,)), ("KERNELS", ())):
        monkeypatch.setattr(chip_smoke, name, value)


def test_tool_phases_print_their_records(narrowed_tools, capsys):
    """``tool_paths``: the four measurement phases, each a main-path line
    with the tool's record, its seconds and its launches."""
    import json

    launches = chip_smoke.tool_paths(torch.device("cpu"), 400.0)
    lines = {line["path"]: line for line in map(json.loads, capsys.readouterr().out.splitlines())
             if line.get("phase") == "main_path"}
    assert set(lines) == {"eval_breakdown", "train_breakdown", "baseline_probe", "loader_bench"}
    assert set(launches) == {"eval_breakdown", "train_breakdown", "baseline_probe"}
    assert all(line["seconds"] > 0 and set(line["launches"]) == {k.__name__ for k in chip_smoke.kernel_counters()}
               for line in lines.values())
    assert [r["name"] for r in lines["eval_breakdown"]["rows"]][-1] == "+neck" and lines["eval_breakdown"]["masked"]
    assert len(lines["train_breakdown"]["rows"]) == 7 and lines["train_breakdown"]["batch"] == 4
    assert lines["baseline_probe"]["check"]["ref"] == lines["baseline_probe"]["check"]["ours"]
    assert lines["loader_bench"]["step_frames_per_s"] == pytest.approx(10.0)


def test_tool_phase_fails_without_its_launches(capsys):
    with pytest.raises(AssertionError, match="eval_breakdown never launched"):
        chip_smoke.counted_phase("eval_breakdown", lambda log: {"rows": []}, chip_smoke.KERNELS,
                                 chip_smoke.tool_record)
    assert '"path": "eval_breakdown"' in capsys.readouterr().out


def test_dist_train_waymo_phase_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The launcher phase on one gloo rank on the CPU (the CLI's device
    and backend given after the launcher's overrides) on the small Waymo
    tree: 8 frames at 3 a step train 2 steps, the export holds the 8 val
    frames, the rank loads no JAX; a rank that launched no kernel fails
    it."""
    import json
    import shutil

    from tests.test_torch_port_tools import waymo_tree

    overrides, val_tokens = waymo_tree(tmp_path / "waymo", monkeypatch)
    overrides = ["--device", "cpu", "--dist-backend", "gloo", *overrides]
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(chip_smoke, "KERNELS", ())
    chip_smoke.dist_train_waymo(tmp_path, overrides, val_tokens)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["path"] == "dist_train_waymo" and line["checkpoint_meta"] == {"epoch": 1, "step": 2}
    assert line["exported_frames"] == 8 and line["foreign_modules"] == [] and line["seconds"] > 0
    # the same run's files, read back as a rank that launched no kernel
    monkeypatch.undo()
    rank = {**json.loads((tmp_path / "launcher/rank0.json").read_text()),
            "launches": {k: 0 for k in chip_smoke.KERNELS}}
    shutil.rmtree(tmp_path / "launcher")
    monkeypatch.setattr(chip_smoke, "run_launcher", lambda *a, **k: [rank])
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.dist_train_waymo(tmp_path, overrides, val_tokens)
