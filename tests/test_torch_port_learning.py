"""The port's synthetic labelled dataset and its two learning checks, on
the CPU at a tiny size.

- ``utils/synth.write_synthetic_nusc`` writes the same ``.bin`` files and
  infos as JAX's for the same seed, bit for bit;
- ``tools.overfit_sanity`` overfits JAX's planted scene (scaled to the
  narrowed flagship's 25.6 m grid) through the port's Trainer step and
  meets JAX's bar: the loss halves and at least 8 of the 10 objects are
  found within 2 m;
- ``tools.metric_delta`` writes a synthetic set, trains through
  ``cli.train`` and scores exact and shortcut through ``cli.test`` (child
  processes on the CPU), and writes ``metric_delta.json``.
"""

from __future__ import annotations

import json
import pickle

import numpy as np
import pytest
import torch

from pillarnext_tpu.utils.synth import write_synthetic_nusc as jax_write_synthetic_nusc
from pillarnext_tpu_torch.tools import metric_delta, overfit_sanity
from pillarnext_tpu_torch.utils.synth import write_synthetic_nusc

# a 64 x 64 grid over +-12.8 m (tests/test_cli_e2e.py's narrowing)
NARROW = [
    "model.reader.voxel_size=[0.4, 0.4, 8]",
    "model.reader.pc_range=[-12.8, -12.8, -5.0, 12.8, 12.8, 3.0]",
    "model.backbone.ds_num_filters=[16, 16, 32, 32]",
    "model.backbone.layer_nums=[1, 1, 1, 1]",
    "model.post_processing.post_center_limit_range=[-15, -15, -10, 15, 15, 10]",
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread here: the suite runs several test processes on
    the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_write_synthetic_nusc_matches_jax(tmp_path):
    kw = dict(n_points=6000, pc_range=(-20.0, -20.0, -5.0, 20.0, 20.0, 3.0), seed=3, n_objects=5)
    got = write_synthetic_nusc(tmp_path / "port", 3, **kw)
    want = jax_write_synthetic_nusc(tmp_path / "jax", 3, **kw)
    assert got.name == want.name == "infos_synth.pkl"
    with open(got, "rb") as f:
        infos = pickle.load(f)
    with open(want, "rb") as f:
        jax_infos = pickle.load(f)
    assert len(infos) == len(jax_infos) == 3
    for a, b in zip(infos, jax_infos):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k
        assert (tmp_path / "port" / a["lidar_path"]).read_bytes() == (tmp_path / "jax" / b["lidar_path"]).read_bytes()


def test_overfit_sanity_meets_jax_bar_at_a_tiny_size():
    overrides = NARROW + [
        "model.reader.num_filters=[16,16]", "model.reader.pillar_capacity=4096",
        "+model.reader.train_pillar_capacity=4096", "model.backbone.num_input_features=16",
        "+model.backbone.out_channels=32", "model.neck.in_channels=32", "model.head.in_channels=32",
        "+model.head.share_conv_channel=32",
    ]
    lines = []
    result = overfit_sanity.run("flagship", 40, "cpu", overrides, extent=12.8, n_points=8000, log=lines.append)
    overfit_sanity.check(result)
    assert result["steps"] == 40 and len(result["losses"]) == 9
    assert result["hits_all"] >= result["hits_top10"] >= 8
    assert lines[0] == "config: nusc_det_pp18_aspp_iou_sp.yaml, steps: 40"
    with pytest.raises(AssertionError, match="did not halve"):
        overfit_sanity.check(dict(result, losses=[1.0, 0.6]))
    with pytest.raises(AssertionError, match="7 of 10"):
        overfit_sanity.check(dict(result, hits_all=7))


def test_overfit_scene_is_jax_scene_at_full_extent():
    pts, gt, names = overfit_sanity.scene()
    rng = np.random.default_rng(0)
    want = rng.uniform(-30, 30, (6, 2))
    np.testing.assert_array_equal(gt[:6, :2], want.astype(np.float32))
    assert pts.shape == (60_000, 5) and list(names) == ["car"] * 6 + ["pedestrian"] * 4


def test_metric_delta_runs_end_to_end(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root = tmp_path / "synth"
    out = metric_delta.main([
        "--scenes", "4", "--epochs", "1", "--batch", "2", "--root", str(root), "--device", "cpu",
        "--extent", "12.8", "--points", "3000", "--objects", "4",
        *NARROW, "dataloader.train.num_workers=0", "dataloader.val.num_workers=0",
        "model.post_processing.nms.nms_pre_max_size=64",
        "model.post_processing.nms.nms_post_max_size=8", "dataloader.max_points=3000",
    ])
    assert json.loads((root / "metric_delta.json").read_text()) == out
    for name in ("exact", "shortcut"):
        assert set(out[name]) == {"mAP", "NDS"}
        assert 0.0 <= out[name]["mAP"] <= 1.0 and 0.0 <= out[name]["NDS"] <= 1.0
    assert out["delta"]["mAP"] == out["shortcut"]["mAP"] - out["exact"]["mAP"]
    assert (root / "work_dir" / "checkpoints" / "epoch_1.pt").exists()
    for name in ("exact", "shortcut"):
        assert list((root / f"eval_{name}").glob("results/epoch_*/metrics_summary.json"))
