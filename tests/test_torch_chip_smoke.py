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

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


def _window(calls, lose=()):
    """Device records of a window: a marker, then each call's (name, us)
    records and a marker, in start order but listed shuffled; ``lose``
    holds the indices of records to drop."""
    names = [chip_smoke.MARKER]
    for call in calls:
        names += [*call, chip_smoke.MARKER]
    records = []
    for t, rec in enumerate(names):
        name, us = (rec, 1.0) if rec == chip_smoke.MARKER else rec
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


def test_device_profile_fails_without_device_records(profiler):
    opened = profiler([[]])
    with pytest.raises(AssertionError, match="no whole call"):
        chip_smoke.device_profile(lambda: None, 3)
    assert len(opened) == chip_smoke.PROFILE_WINDOWS


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


def test_cli_tree_reads_back_through_the_port_pipeline(tmp_path, monkeypatch):
    """The nuScenes-format tree of the CLI phases, at 2,000 points a sweep:
    each sample's 10 sweeps come back in the keyframe's frame (the sweeps'
    transforms undo the ego motion they were written under), the val infos
    carry their GT, and the train pipeline (GT paste, augmentations,
    targets) runs on it."""
    import numpy as np

    from pillarnext_tpu_torch.utils.builders import build_dataset
    from pillarnext_tpu_torch.utils.config import load_experiment

    monkeypatch.setattr(chip_smoke, "SWEEP_POINTS", 2000)
    cfg = load_experiment(chip_smoke.FLAGSHIP)
    names = [n for task in cfg["data"]["train_dataset"]["class_names"] for n in task]
    tree = chip_smoke.write_nuscenes_tree(tmp_path / "nusc", cfg["model"]["reader"]["pc_range"], names, seed=0)
    assert tree["samples"] == {"train": 8, "val": 8} and tree["points_per_sample"] == [20000, 20000]
    assert 20 <= tree["gt_boxes_per_sample"][0] <= tree["gt_boxes_per_sample"][1] <= 40

    overrides = [f"data.train_dataset.root_path={tmp_path / 'nusc'}", "data.train_dataset.info_path=infos_train.pkl",
                 "data.val_dataset.info_path=infos_val.pkl", "data.train_dataset.sampler.dbinfo_path=dbinfos.pkl",
                 "data.train_dataset.resampling=false"]
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
