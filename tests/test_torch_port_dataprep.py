"""The port's offline data preparation against the JAX package's, on the CPU.

- (a) ``create_groundtruth_database`` for nuScenes (``make_mini_nuscenes``,
  2 sweeps) and Waymo (``make_mini_waymo``, 1 and 2 sweeps) on two copies
  of one tree: the same dbinfos (class order, entry order, keys, arrays
  bit-equal) and the same crop files, byte for byte; Waymo's subsampling
  keeps some vehicles and drops others;
- (b) ``create_nuscenes_infos`` for ``v1.0-mini`` and ``v1.0-test`` on the
  in-memory devkit stand-ins of tests/torch_fake_devkits.py: the same
  files with equal pickles (float tolerance 0, NaN velocities equal), and
  boxes in the lidar frame where the stand-in planted them;
- (c) Waymo ``convert`` on TFRecords written here (two lasers listed out of
  name order, two returns, pixels at range <= 0, NLZ flags in channel 3):
  every column but the last equals JAX's, the last holds the flags in the
  devkit's point order where JAX's holds -1, and the port's
  ``WaymoDataset`` drops exactly the flagged points, which JAX's keeps;
- (d) ``create_data`` through both preps on the stand-ins: the same files
  under the same names as JAX's (Waymo: its points but the NLZ column, and
  the GT database JAX's tool cuts from the port's tree), then the port's
  ``cli.train`` one step on the nuScenes tree it wrote, at the 64 x 64
  grid of tests/test_cli_e2e.
"""

from __future__ import annotations

import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pillarnext_tpu.cli import create_data as jax_create_data
from pillarnext_tpu.cli.create_gt_database import create_groundtruth_database as jax_create_gt
from pillarnext_tpu.data import nusc_converter as jax_nusc
from pillarnext_tpu.data import waymo_converter as jax_waymo
from pillarnext_tpu.data.datasets import WaymoDataset as JaxWaymoDataset
from pillarnext_tpu_torch.cli import create_data, train as cli_train
from pillarnext_tpu_torch.cli.create_gt_database import create_groundtruth_database
from pillarnext_tpu_torch.data import nusc_converter, waymo_converter
from pillarnext_tpu_torch.data.datasets import WaymoDataset
from tests import torch_fake_devkits as fake
from tests.test_cli_e2e import _overrides as cli_overrides
from tests.test_data_pipeline import make_mini_nuscenes
from tests.test_torch_port_e2e import FLAGSHIP
from tests.test_waymo_pipeline import make_mini_waymo

WAYMO_FRAMES = 12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the suite runs several test processes on the
    machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_same(got, want, where: str = "") -> None:
    """Equal structures: dicts with the same keys in the same order, lists
    of the same length, arrays of one dtype and shape with equal values
    (NaN equal to NaN), other leaves ==."""
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want or (got != got and want != want), (where, got, want)


def load(path: Path):
    with open(path, "rb") as f:
        return pickle.load(f)


def files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def crops(root: Path, nsweeps: int) -> dict[str, bytes]:
    return files(root / f"gt_database_{nsweeps}sweeps_withvelo")


# ---------------------------------------------------------------- (a)


@pytest.mark.parametrize("dataset,nsweeps", [("nuscenes", 2), ("waymo", 1), ("waymo", 2)])
def test_gt_database_matches_jax(tmp_path, dataset, nsweeps):
    roots = {}
    for who in ("jax", "port"):
        root = roots[who] = tmp_path / who
        if dataset == "nuscenes":
            make_mini_nuscenes(root, n_samples=6, n_points=800)
            info = "infos.pkl"
        else:
            make_mini_waymo(root, n_frames=WAYMO_FRAMES)
            info = "waymo_infos_train.pkl"
    jax_create_gt(dataset, str(roots["jax"]), info, nsweeps)
    port = create_groundtruth_database(dataset, str(roots["port"]), info, nsweeps)
    name = f"dbinfos_train_{nsweeps}sweeps_withvelo.pkl"
    want = load(roots["jax"] / name)
    assert_same(load(roots["port"] / name), want)
    assert_same(port, want)
    assert crops(roots["port"], nsweeps) == crops(roots["jax"], nsweeps)
    assert sum(len(v) for v in want.values()) == len(crops(roots["jax"], nsweeps)) > 0
    if dataset == "waymo":
        # one vehicle a frame, a quarter kept; the empty pedestrians are dropped at load
        assert 0 < len(want["vehicle"]) < WAYMO_FRAMES and "pedestrian" not in want
    else:
        assert sum(e["num_points_in_gt"] for v in want.values() for e in v) > 0


# ---------------------------------------------------------------- (b)


@pytest.mark.parametrize("version", ["v1.0-mini", "v1.0-test"])
def test_nuscenes_infos_match_jax(tmp_path, monkeypatch, version):
    tables = fake.make_nuscenes(tmp_path / "data")
    fake.install(monkeypatch, tables)
    for who, convert in (("jax", jax_nusc.create_nuscenes_infos), ("port", nusc_converter.create_nuscenes_infos)):
        (tmp_path / who).mkdir()
        convert(str(tmp_path / who), version=version, nsweeps=10)
    want, got = files(tmp_path / "jax"), files(tmp_path / "port")
    names = ["infos_test_10sweeps_withvelo.pkl"] if version == "v1.0-test" else [
        "infos_train_10sweeps_withvelo_filterZero.pkl", "infos_val_10sweeps_withvelo_filterZero.pkl"]
    assert sorted(got) == sorted(want) == sorted(names)
    for name in names:
        assert_same(pickle.loads(got[name]), pickle.loads(want[name]), name)

    infos = pickle.loads(got[names[0]])
    assert [i["token"] for i in infos] == (["sample-1-0", "sample-1-1"] + (
        ["sample-2-0", "sample-2-1"] if version == "v1.0-test" else []))
    # keyframe 0 reads its 3 sweeps; keyframe 1 those, keyframe 0 and its 3
    assert [len(i["sweeps"]) for i in infos[:2]] == [3, 7]
    assert infos[1]["sweeps"][3]["lidar_path"] == "samples/LIDAR_TOP/sd-1-0-3.bin"
    for info in infos:
        k = int(info["token"][-1])
        boxes = info["gt_boxes"]
        kept = [inst for inst in fake.INSTANCES
                if not (info["token"] == "sample-2-1" and inst[0].startswith("human"))]
        assert boxes.shape == (len(kept), 9)
        for box, (category, attr, wlh, centre, yaw) in zip(boxes, kept):
            np.testing.assert_allclose(box[:3], np.asarray(centre) + [0.5 * k, 0, 0], atol=1e-9)
            np.testing.assert_allclose(box[3:6], [wlh[1], wlh[0], wlh[2]])  # (l, w, h)
            np.testing.assert_allclose(np.cos(box[8] - yaw), 1.0, atol=1e-12)
            assert np.isfinite(box[6:8]).all()  # every split sample has a neighbour
        assert list(info["gt_names"]) == [nusc_converter.GENERAL_TO_DETECTION[c] for c, *_ in kept]
        assert list(info["gt_attributes"]) == [a or "" for _, a, *_ in kept]


def test_nuscenes_velocity_matches_jax_and_is_nan_without_neighbours(tmp_path, monkeypatch):
    """``_box_velocity`` of every annotation equals JAX's (NaN equal to
    NaN): the finite difference over its neighbours 0.2 s apart, and NaN
    for scene-0003's, which have no previous or next frame."""
    fake.install(monkeypatch, fake.make_nuscenes(tmp_path))
    nusc = fake.NuScenes()
    anns = list(fake.NuScenes.tables["sample_annotation"])
    for token in anns:
        got = nusc_converter._box_velocity(nusc, token)
        np.testing.assert_array_equal(got, jax_nusc._box_velocity(nusc, token))
        assert np.isnan(got).all() == token.startswith("ann-3-"), token
    first, second = (nusc.get("sample_annotation", f"ann-1-{k}-0") for k in (0, 1))
    np.testing.assert_allclose(nusc_converter._box_velocity(nusc, first["token"]),
                               (np.asarray(second["translation"]) - first["translation"]) / 0.2, rtol=1e-5)


# ---------------------------------------------------------------- (c)


def waymo_convert(tmp_path, monkeypatch):
    fake.install(monkeypatch)
    frames = fake.write_waymo_tfrecords(tmp_path / "tfrecord_train")
    for who, module in (("jax", jax_waymo), ("port", waymo_converter)):
        module.convert(str(tmp_path / "tfrecord_train"), str(tmp_path / who))
    return frames


def test_waymo_convert_reads_the_nlz_flag(tmp_path, monkeypatch):
    frames = waymo_convert(tmp_path, monkeypatch)
    assert_same(load(tmp_path / "port/waymo_infos_train.pkl"), load(tmp_path / "jax/waymo_infos_train.pkl"))
    infos = load(tmp_path / "port/waymo_infos_train.pkl")
    assert [len(i["sweeps"]) for i in infos] == [0, 1, 2, 3, 4, 4, 0, 1]
    assert [len(i["objects"]) for i in infos] == [3] * len(frames)  # the sign is skipped
    for info, frame in zip(infos, frames):
        token = info["token"]
        assert token == f"{frame['name']}-{frame['timestamp_micros']}"
        port, jax_pts = (np.fromfile(tmp_path / who / "lidar_point" / f"{token}.bin", np.float32).reshape(-1, 6)
                         for who in ("port", "jax"))
        np.testing.assert_array_equal(port[:, :5], jax_pts[:, :5])
        flags = fake.devkit_nlz(frame)
        np.testing.assert_array_equal(port[:, 5], flags)
        assert (jax_pts[:, 5] == -1).all()
        assert 0 < (flags == 1).sum() < len(flags)

        # the loaders: the port drops exactly the flagged points, JAX keeps all
        kwargs = dict(info_path="waymo_infos_train.pkl", nsweeps=1, loading_pipelines=["load_pointcloud"])
        index = infos.index(info)
        loaded = WaymoDataset(root_path=str(tmp_path / "port"), **kwargs).get(index, np.random.RandomState(0))
        np.testing.assert_array_equal(loaded["points"][:, :4], port[flags == -1, :4])
        np.random.seed(0)
        kept = JaxWaymoDataset(root_path=str(tmp_path / "jax"), **kwargs)[index]["points"]
        np.testing.assert_array_equal(kept[:, :4], jax_pts[:, :4])


def test_waymo_convert_refuses_flags_out_of_step_with_points(tmp_path, monkeypatch):
    """A devkit that emits another count of points than the range images
    have pixels with range > 0: the port raises instead of writing
    misaligned flags."""
    fake.install(monkeypatch)
    fake.write_waymo_tfrecords(tmp_path / "tfrecord_train", frames=(("segment-a", 1),))
    emit = fake.convert_range_image_to_point_cloud

    def one_short(*args, **kwargs):
        points, cp = emit(*args, **kwargs)
        return [points[0][1:], *points[1:]], cp

    monkeypatch.setattr(sys.modules["waymo_open_dataset.utils.frame_utils"], "convert_range_image_to_point_cloud",
                        one_short)
    with pytest.raises(ValueError, match="pixels with range > 0"):
        waymo_converter.convert(str(tmp_path / "tfrecord_train"), str(tmp_path / "port"))


# ---------------------------------------------------------------- (d)


def test_create_data_matches_jax_and_trains(tmp_path, monkeypatch):
    roots = {who: tmp_path / who for who in ("jax", "port")}
    for who, module in (("jax", jax_create_data), ("port", create_data)):
        tables = fake.make_nuscenes(roots[who] / "nuscenes")
        fake.install(monkeypatch, tables)
        module.nuscenes_data_prep(str(roots[who] / "nuscenes"), "v1.0-mini", 10)
        fake.write_waymo_tfrecords(roots[who] / "waymo" / "tfrecord_train")
        module.waymo_data_prep(str(roots[who] / "waymo"), "train", 1)

    # nuScenes: every file the same, under the same name
    want, got = files(roots["jax"] / "nuscenes"), files(roots["port"] / "nuscenes")
    assert sorted(got) == sorted(want)
    assert {"infos_train_10sweeps_withvelo_filterZero.pkl", "infos_val_10sweeps_withvelo_filterZero.pkl",
            "dbinfos_train_10sweeps_withvelo.pkl"} <= set(got)
    for name in got:
        if name.endswith(".pkl"):
            assert_same(pickle.loads(got[name]), pickle.loads(want[name]), name)
        else:
            assert got[name] == want[name], name
    # each crop holds the points planted in its box in the keyframe (time lag 0)
    db = pickle.loads(got["dbinfos_train_10sweeps_withvelo.pkl"])
    assert sum(len(v) for v in db.values()) == 8
    for entry in (e for v in db.values() for e in v):
        crop = np.frombuffer(got[entry["path"]], np.float32).reshape(-1, 5)
        assert len(crop) == entry["num_points_in_gt"] and (crop[:, 4] == 0).sum() >= fake.POINTS_IN_BOX

    # Waymo: the same names; points equal but the NLZ column; the GT
    # database equals JAX's tool run on the port's tree
    want, got = files(roots["jax"] / "waymo"), files(roots["port"] / "waymo")
    assert sorted(got) == sorted(want)
    assert_same(pickle.loads(got["waymo_infos_train.pkl"]), pickle.loads(want["waymo_infos_train.pkl"]))
    points = [n for n in got if n.startswith("lidar_point/")]
    assert len(points) == 8
    for name in points:
        a, b = (np.frombuffer(d[name], np.float32).reshape(-1, 6) for d in (got, want))
        np.testing.assert_array_equal(a[:, :5], b[:, :5])
    jax_db = tmp_path / "jax_on_port_tree"
    jax_create_gt("waymo", str(roots["port"] / "waymo"), "waymo_infos_train.pkl", 1,
                  db_path=str(jax_db / "gt_database_1sweeps_withvelo"), dbinfo_path=str(jax_db / "dbinfos.pkl"))
    assert_same(pickle.loads(got["dbinfos_train_1sweeps_withvelo.pkl"]), load(jax_db / "dbinfos.pkl"))
    assert crops(roots["port"] / "waymo", 1) == crops(jax_db, 1)

    # the port's cli.train, one step on the tree it wrote (the stand-ins gone)
    monkeypatch.undo()
    root = roots["port"] / "nuscenes"
    overrides = [o for o in cli_overrides(root) if "info_path" not in o and "dbinfo_path" not in o]
    trained = cli_train.main(["--config", str(FLAGSHIP), "--device", "cpu", "--work-dir", str(tmp_path / "work"),
                              *overrides])
    assert trained.step == 1 and np.isfinite([float(v) for v in trained.epoch_losses]).all()
    assert sorted(trained.last_detections) == ["sample-2-0", "sample-2-1"]
