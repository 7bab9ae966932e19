"""The port's data layer against the JAX package's, on the same inputs.

- box geometry: ``core/box_ops`` and the native library bit-equal to
  JAX's ``box_ops`` and ``native_geometry``, the library also equal to
  the NumPy versions; a failed build raises;
- augmentations: the port's explicit RandomState draws what JAX draws
  from the global stream, and leaves the global stream alone;
- batches: the port's datasets (built from the experiment YAMLs) and
  loader give JAX's batches bit for bit on the mini nuScenes and Waymo
  trees of tests/test_data_pipeline.py and tests/test_waymo_pipeline.py,
  GT paste and augmentations included, at 0 and 2 workers and two epochs;
  CBGS gives the same infos order and Waymo's NLZ filter the same points;
- the loader's workers: an exception propagates, torch runs one thread;
- scorers: the port writes JAX's ``results_nusc.json`` /
  ``metrics_summary.json`` and Waymo ``waymo_preds.npz`` for the same
  detections.
"""

from __future__ import annotations

import json
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from pillarnext_tpu.core import box_ops as jax_box_ops
from pillarnext_tpu.core import jax_box_ops as jax_box_ops_device
from pillarnext_tpu.core import native_geometry as jax_native
from pillarnext_tpu.data import augmentation as jax_aug
from pillarnext_tpu.data.loader import DataLoader as JaxLoader
from pillarnext_tpu.utils import builders as jax_builders
from pillarnext_tpu.utils.config import load_experiment as jax_load_experiment
from pillarnext_tpu_torch.core import box_ops, native_geometry, nms, torch_box_ops
from pillarnext_tpu_torch.data import augmentation, sampler
from pillarnext_tpu_torch.data import loader as loader_mod
from pillarnext_tpu_torch.data.loader import DataLoader
from pillarnext_tpu_torch.utils import builders
from pillarnext_tpu_torch.utils.config import load_experiment
from tests.test_cli_e2e import _overrides as nusc_overrides
from tests.test_data_pipeline import make_mini_nuscenes
from tests.test_waymo_pipeline import make_mini_waymo

EXPERIMENTS = Path(__file__).resolve().parent.parent / "pillarnext_tpu/configs/experiments"
FLAGSHIP = EXPERIMENTS / "nusc_det_pp18_aspp_iou_sp.yaml"
WAYMO_PP18 = EXPERIMENTS / "waymo_det_pp18_aspp_iou_car_sp.yaml"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread here: the suite runs several test processes on
    the machine's cores, and each torch pool of all cores in each of them
    oversubscribes the host many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_boxes(rng, n, velocity=True):
    boxes = np.zeros((n, 9 if velocity else 7), np.float32)
    boxes[:, :2] = rng.uniform(-20, 20, (n, 2))
    boxes[:, 2] = rng.uniform(-1, 1, n)
    boxes[:, 3:6] = rng.uniform(0.5, 5, (n, 3))
    if velocity:
        boxes[:, 6:8] = rng.uniform(-3, 3, (n, 2))
    boxes[:, -1] = rng.uniform(-np.pi, np.pi, n)
    return boxes


def assert_same_batch(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if k == "token":
            assert a[k] == b[k]
        elif isinstance(a[k], list):
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y, err_msg=k)
                assert x.dtype == y.dtype, k
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k


# ------------------------------------------------------------ box geometry


@pytest.mark.parametrize("seed", [0, 1])
def test_box_ops_bit_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    boxes = random_boxes(rng, 40)
    for fn, args in (("flip", ("x",)), ("flip", ("y",)), ("scaling", (1.07,)), ("rotate", (0.3,)),
                     ("translate", (np.float32([0.5, -0.2, 0.1]),))):
        np.testing.assert_array_equal(getattr(box_ops, fn)(boxes.copy(), *args),
                                      getattr(jax_box_ops, fn)(boxes.copy(), *args), err_msg=fn)
    for fn, arg in (("center_to_corner_box2d", boxes[:, [0, 1, 3, 4, 8]]),
                    ("center_to_corner_box3d", boxes), ("corners_nd", boxes[:, 3:6])):
        np.testing.assert_array_equal(getattr(box_ops, fn)(arg), getattr(jax_box_ops, fn)(arg), err_msg=fn)
    corners = box_ops.center_to_corner_box2d(boxes[:, [0, 1, 3, 4, 8]])
    np.testing.assert_array_equal(box_ops.corner_to_standup_nd(corners),
                                  jax_box_ops.corner_to_standup_nd(corners))

    points = np.concatenate([rng.uniform(-22, 22, (3000, 3)), rng.uniform(0, 1, (3000, 2))], 1)
    points = points.astype(np.float32)
    inside = box_ops.points_in_rbbox(points, boxes)
    assert inside.any() and not inside.all()
    np.testing.assert_array_equal(inside, jax_native.points_in_rbbox(points, boxes))
    np.testing.assert_array_equal(inside, box_ops.points_in_rbbox_np(points, boxes))

    coll = box_ops.box_collision_test(corners, corners)
    np.fill_diagonal(coll, False)
    assert coll.any() and not coll.all()
    want = jax_native.box_collision_test(corners, corners)
    np.fill_diagonal(want, False)
    np.testing.assert_array_equal(coll, want)
    oracle = box_ops.box_collision_test_np(corners, corners)
    np.fill_diagonal(oracle, False)
    np.testing.assert_array_equal(coll, oracle)



def test_native_oracles_hold_the_ports_rotated_iou_and_nms():
    """The library's exact polygon-clip overlap, IoU and greedy NMS as the
    oracles of the port's device-side ``torch_box_ops`` and ``nms``, on
    clustered boxes of 0.5-5 m sides; 400 candidates run NMS across its
    128-candidate chunks.  The port's f32 boundary-integral overlap equals
    JAX's (within 1e-4) and both sit up to ~1e-2 m^2 from the exact clip
    on thin boxes (0.008 at the worst pair of these), so the oracle bar
    is 1e-2."""
    rng = np.random.default_rng(11)
    b7 = random_boxes(rng, 400, velocity=False)
    b7[:, :2] = rng.uniform(-6, 6, (400, 2))
    a, b = b7[:64], b7[64:128]
    over = torch_box_ops.boxes_overlap_bev(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(over, jax_box_ops_device.boxes_overlap_bev(a, b), atol=1e-4)
    np.testing.assert_allclose(over, native_geometry.boxes_overlap_bev(a, b), atol=1e-2)
    iou = torch.diagonal(torch_box_ops.boxes_iou_bev(torch.from_numpy(a), torch.from_numpy(b))).numpy()
    np.testing.assert_allclose(iou, native_geometry.boxes_aligned_iou_bev(a, b), atol=1e-2)

    scores = rng.uniform(0, 1, 400).astype(np.float32)
    sel, valid = nms.rotated_nms(torch.from_numpy(b7)[None], torch.from_numpy(scores)[None], 0.3, 400, 400)
    order = np.argsort(-scores, kind="stable")
    oracle = order[native_geometry.rotated_nms(b7[order], 0.3)]
    assert 10 < len(oracle) < 390
    np.testing.assert_array_equal(np.sort(sel[0][valid[0]].numpy()), np.sort(oracle))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No silent fallback: a library that does not compile raises."""
    broken = tmp_path / "geometry.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_geometry, "SOURCE", broken)
    monkeypatch.setattr(native_geometry, "BUILD_DIR", tmp_path / "_build")
    native_geometry.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="building geometry.cpp failed"):
            box_ops.points_in_rbbox(np.zeros((3, 3), np.float32), random_boxes(np.random.default_rng(0), 2))
    finally:
        native_geometry.library.cache_clear()
    assert not list((tmp_path / "_build").glob("*.so"))


# ----------------------------------------------------------- augmentations


def test_augmentations_draw_what_jax_draws():
    """Each transform (and the four in the config's order) with a
    RandomState seeded s gives what JAX's gives after np.random.seed(s);
    NaN velocities stay NaN; the global stream is not touched."""
    rng = np.random.default_rng(0)
    points = rng.uniform(-30, 30, (500, 5)).astype(np.float32)
    boxes = random_boxes(rng, 6)
    boxes[2, 6:8] = np.nan
    params = {"Flip": ([0.5, 0.5],), "Scaling": ([0.9, 1.1],), "Rotation": ([-0.785, 0.785],),
              "Translation": (0.5,)}
    for seed in range(4):
        port_rng = np.random.RandomState(seed)
        np.random.seed(seed)
        port = {"points": points.copy(), "annotations": {"gt_boxes": boxes.copy()}}
        ref = {"points": points.copy(), "annotations": {"gt_boxes": boxes.copy()}}
        for name in ("Rotation", "Scaling", "Translation", "Flip"):
            state = np.random.get_state()
            port = getattr(augmentation, name)(*params[name])(port, port_rng)
            assert all(np.array_equal(a, b) for a, b in zip(state, np.random.get_state()))
            ref = getattr(jax_aug, name)(*params[name])(ref)
            np.testing.assert_array_equal(port["points"], ref["points"], err_msg=name)
            np.testing.assert_array_equal(port["annotations"]["gt_boxes"], ref["annotations"]["gt_boxes"])
        assert np.isnan(port["annotations"]["gt_boxes"][2, 6:8]).all()


# ----------------------------------------------------------------- batches


def both_datasets(path, overrides, key="train_dataset"):
    """(JAX's, the port's) dataset from the experiment YAML; JAX's GT-paste
    cursors take their first shuffle from the global stream seeded as the
    port's sampler seeds its own."""
    jcfg, pcfg = jax_load_experiment(path, overrides), load_experiment(path, overrides)
    np.random.seed(sampler.INIT_SEED)
    return jax_builders.build_dataset(jcfg["data"][key]), builders.build_dataset(pcfg["data"][key])


def assert_same_loaders(jds, pds, workers, batch_size=2, max_points=3000):
    """Two epochs of both loaders, batch for batch."""
    ref = JaxLoader(jds, batch_size, max_points, shuffle=True, seed=3, num_workers=workers)
    got = DataLoader(pds, batch_size, max_points, shuffle=True, seed=3, num_workers=workers)
    assert len(ref) == len(got) > 0
    for epoch in (0, 1):
        ref.set_epoch(epoch)
        got.set_epoch(epoch)
        batches = list(zip(ref, got, strict=True))
        assert len(batches) == len(ref)
        for a, b in batches:
            assert_same_batch(a, b)


@pytest.mark.parametrize("workers,gt_drop", [(0, 0.0), (2, 0.0), (0, 0.3)])
def test_nuscenes_batches_equal_jax(tmp_path, workers, gt_drop):
    """The flagship YAML's pipeline; ``gt_drop`` 0.3 also drops pasted
    crops' points (a draw per point)."""
    root = tmp_path / "nusc"
    make_mini_nuscenes(root, n_samples=6, n_points=700)
    jds, pds = both_datasets(FLAGSHIP, nusc_overrides(root) + [
        f"data.train_dataset.sampler.gt_drop_percentage={gt_drop}",
        "data.train_dataset.sampler.gt_drop_max_keep_points=20"])
    assert pds.sampler.gt_drop_rate == gt_drop
    assert pds.sampler is not None and set(pds.augmentations) == {"rotation", "scaling", "translation", "flip"}
    # GT paste pastes crops: more points than the two sweeps hold (one
    # sample from each, which moves both samplers' cursors alike)
    np.random.seed(1)
    ref, got = jds[0], pds.get(0, np.random.RandomState(1))
    assert got["points"].shape[0] > 2 * 700
    np.testing.assert_array_equal(got["points"], ref["points"])
    assert_same_loaders(jds, pds, workers)


def test_cbgs_gives_jax_infos_order(tmp_path):
    root = tmp_path / "nusc"
    make_mini_nuscenes(root, n_samples=6, n_points=100)
    overrides = [o for o in nusc_overrides(root) if "resampling" not in o]
    jds, pds = both_datasets(FLAGSHIP, overrides)
    assert len(pds) == len(jds) != 6
    assert [i["token"] for i in pds.infos] == [i["token"] for i in jds.infos]


def make_waymo_gt_database(root, seed=0):
    rng = np.random.default_rng(seed)
    (root / "gtdb").mkdir(exist_ok=True)
    db = {}
    for name, size in (("vehicle", [4.5, 2.0, 1.6]), ("pedestrian", [0.8, 0.8, 1.7]), ("cyclist", [1.8, 0.7, 1.7])):
        db[name] = []
        for j in range(6):
            crop = rng.uniform(-0.4, 0.4, (25, 5)).astype(np.float32)
            path = f"gtdb/{name}_{j}.bin"
            crop.tofile(root / path)
            box = np.zeros(9, np.float32)
            box[:2] = rng.uniform(-25, 25, 2)
            box[3:6] = size
            box[8] = rng.uniform(-np.pi, np.pi)
            db[name].append({"name": name, "path": path, "box3d_lidar": box, "num_points_in_gt": 25})
    with open(root / "dbinfos.pkl", "wb") as f:
        pickle.dump(db, f)


def waymo_overrides(root):
    return [
        f"data.train_dataset.root_path={root}",
        "data.train_dataset.info_path=waymo_infos_train.pkl",
        "data.train_dataset.sampler.dbinfo_path=dbinfos.pkl",
        "data.train_dataset.prepare_label.centermap.max_objs=20",
        "model.reader.pc_range=[-32.0,-32.0,-10.0,32.0,32.0,10.0]",
        "model.reader.voxel_size=[0.5,0.5,20.0]",
    ]


@pytest.mark.parametrize("workers", [0, 2])
def test_waymo_batches_equal_jax(tmp_path, workers):
    """nsweeps 3 with drop_frames 0.5 (a draw per sweep), GT paste and the
    four augmentations, through both loaders."""
    root = tmp_path / "waymo"
    make_mini_waymo(root, n_frames=6, n_points=400)
    make_waymo_gt_database(root)
    jds, pds = both_datasets(WAYMO_PP18, waymo_overrides(root))
    assert pds.drop_frames == 0.5 and pds.nsweeps == 3 and pds.sampler is not None
    assert_same_loaders(jds, pds, workers)


def test_waymo_nlz_filter_keeps_jax_points(tmp_path):
    root = tmp_path / "waymo"
    infos = make_mini_waymo(root, n_frames=3, n_points=400)
    jcfg = jax_load_experiment(WAYMO_PP18, waymo_overrides(root))["data"]["train_dataset"]
    pcfg = load_experiment(WAYMO_PP18, waymo_overrides(root))["data"]["train_dataset"]
    for cfg in (jcfg, pcfg):
        cfg.update(sampler=None, augmentation=None, prepare_label=None, create_database=True, drop_frames=0.0)
    jds, pds = jax_builders.build_dataset(jcfg), builders.build_dataset(pcfg)
    for i, info in enumerate(infos):
        raw = np.fromfile(root / "lidar_point" / f"{info['token']}.bin", np.float32).reshape(-1, 6)
        got = pds.get(i, np.random.RandomState(0))
        ref = jds[i]
        np.testing.assert_array_equal(got["points"], ref["points"])
        # the keyframe's points are the raw ones outside the no-label zones
        np.testing.assert_array_equal(got["points"][: (raw[:, 5] == -1).sum(), :4], raw[raw[:, 5] == -1, :4])
        assert got["points"].shape[0] == 200 * (1 + min(i, 2))
        for k in ("gt_boxes", "gt_names"):
            np.testing.assert_array_equal(got["annotations"][k], ref["annotations"][k])


# ------------------------------------------------------------------ workers


class _Stub:
    """A dataset whose sample ``boom`` raises; each sample records the
    worker's torch thread count."""

    def __init__(self, n, boom=None):
        self.n, self.boom = n, boom

    def __len__(self):
        return self.n

    def get(self, i, rng):
        if i == self.boom:
            raise ValueError("boom")
        return {"token": f"t{i}", "points": np.full((4, 5), i, np.float32),
                "threads": np.int64(torch.get_num_threads())}


def test_worker_exception_propagates():
    with pytest.raises(RuntimeError, match="boom"):
        list(DataLoader(_Stub(4, boom=2), batch_size=1, max_points=8, shuffle=False, num_workers=2))


class _Dies(_Stub):
    def get(self, i, rng):
        if i == 1:
            os._exit(3)  # as a worker killed for memory would
        return super().get(i, rng)


def test_a_worker_that_dies_raises(monkeypatch):
    monkeypatch.setattr(loader_mod._get, "__defaults__", (0.2,))
    with pytest.raises(RuntimeError, match="worker died .exit code 3"):
        list(DataLoader(_Dies(4), batch_size=1, max_points=8, shuffle=False, num_workers=2))


def test_workers_run_torch_on_one_thread_in_order():
    loader = DataLoader(_Stub(8), batch_size=2, max_points=8, shuffle=False, num_workers=3)
    batches = list(loader)
    assert [b["token"] for b in batches] == [[f"t{i}", f"t{i + 1}"] for i in range(0, 8, 2)]
    assert loader.start_s > 0 and len(loader.load_s) == 4 and all(t > 0 for t in loader.load_s)
    assert all((b["threads"] == 1).all() for b in batches)
    assert torch.get_num_threads() >= 1  # the parent's pool is its own


# ------------------------------------------------------------------ scorers


def detections_for(infos, rng):
    """Noisy detections around each sample's GT, plus false positives."""
    dets = {}
    for info in infos:
        gt = np.asarray(info["gt_boxes"], np.float32)
        boxes = np.concatenate([gt + rng.normal(0, 0.3, gt.shape).astype(np.float32),
                                random_boxes(rng, 2)])
        labels = np.array([0 if n == "car" else 1 for n in info["gt_names"]] + [0, 1])
        dets[info["token"]] = {"box3d_lidar": boxes, "scores": rng.uniform(0.1, 1, len(boxes)).astype(np.float32),
                               "label_preds": labels}
    return dets


def test_nuscenes_scorer_writes_jax_files(tmp_path):
    root = tmp_path / "nusc"
    infos = make_mini_nuscenes(root, n_samples=5, n_points=50)
    overrides = nusc_overrides(root)
    jds, pds = both_datasets(FLAGSHIP, overrides, key="val_dataset")
    dets = detections_for(infos, np.random.default_rng(0))
    ref = jds.evaluation(dets, tmp_path / "jax")
    got = pds.evaluation(dets, tmp_path / "port")
    assert got == ref and 0 < got["mean_ap"] < 1
    for name in ("results_nusc.json", "metrics_summary.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    assert len(json.loads((tmp_path / "port" / "results_nusc.json").read_text())["results"]) == 5
    with pytest.raises(AssertionError, match="eval gather"):
        pds.evaluation(dict(list(dets.items())[:4]), tmp_path / "short")


def test_waymo_export_writes_jax_npz(tmp_path):
    root = tmp_path / "waymo"
    make_mini_waymo(root, n_frames=3, n_points=50)
    rng = np.random.default_rng(1)
    dets = {f"ctx-{1000 + i}": {"box3d_lidar": random_boxes(rng, 4 + i), "scores": rng.uniform(0, 1, 4 + i),
                                "label_preds": rng.integers(0, 3, 4 + i)} for i in range(3)}
    overrides = [f"data.train_dataset.root_path={root}", "data.val_dataset.info_path=waymo_infos_train.pkl"]
    jds, pds = both_datasets(WAYMO_PP18, overrides, key="val_dataset")
    ref, got = jds.evaluation(dets, tmp_path / "jax"), pds.evaluation(dets, tmp_path / "port")
    assert got == {"waymo": ref["waymo"].replace(str(tmp_path / "jax"), str(tmp_path / "port"))}
    a, b = (np.load(tmp_path / d / "waymo_preds.npz", allow_pickle=True) for d in ("jax", "port"))
    assert a.files == b.files
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    for k in ("boxes", "labels", "scores"):
        for x, y in zip(a[k], b[k], strict=True):
            np.testing.assert_array_equal(x, y)
    assert (tmp_path / "port" / "convert_npz_to_proto.py").read_text() == \
        (tmp_path / "jax" / "convert_npz_to_proto.py").read_text()
