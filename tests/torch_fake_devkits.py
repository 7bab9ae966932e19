"""In-memory stand-ins of the dataset devkits the offline converters call,
for tests on a machine that has none of them: ``nuscenes`` (``NuScenes``,
``utils.splits``, ``utils.data_classes.Box``), ``pyquaternion``
(``Quaternion``) and ``waymo_open_dataset`` (``dataset_pb2.Frame``,
``utils.frame_utils``).  Each stand-in does what the converters use of the
real API, in the real API's conventions:

- ``NuScenes.get_boxes(sample_data_token)`` gives a keyframe's boxes in the
  global frame, one new ``Box`` per annotation in the order of
  ``sample["anns"]``; ``Box.rotate`` turns the centre and composes the
  orientation (``q * orientation``); ``Quaternion`` is [w, x, y, z] with
  the Hamilton product.
- ``frame_utils.convert_range_image_to_point_cloud`` emits one array a
  laser, lasers sorted by name, within a laser the pixels with range > 0
  in row-major order (``tf.where``'s order), with ``keep_polar_features``
  the columns [range, intensity, elongation, x, y, z].

``make_nuscenes(root)`` writes a small nuScenes tree's lidar files and
returns its tables; ``write_waymo_tfrecords(dir)`` writes TFRecords of
pickled frames (with ``tf.io.TFRecordWriter``) whose range images carry
no-label-zone flags in channel 3.  ``install(monkeypatch, tables)`` puts
the stand-ins in ``sys.modules``.
"""

from __future__ import annotations

import math
import pickle
import types
from pathlib import Path
from types import SimpleNamespace

import numpy as np

# ------------------------------------------------------------------ pyquaternion


class Quaternion:
    """[w, x, y, z]; ``Quaternion(q)`` from a sequence or a Quaternion."""

    def __init__(self, q):
        self.q = np.array(q.q if isinstance(q, Quaternion) else q, np.float64)

    @property
    def elements(self) -> np.ndarray:
        return self.q

    @property
    def inverse(self) -> "Quaternion":
        w, x, y, z = self.q
        return Quaternion(np.array([w, -x, -y, -z]) / float(self.q @ self.q))

    def __mul__(self, other: "Quaternion") -> "Quaternion":
        w1, x1, y1, z1 = self.q
        w2, x2, y2, z2 = other.q
        return Quaternion([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ])

    def rotate(self, v) -> np.ndarray:
        return (self * Quaternion([0.0, *v]) * self.inverse).q[1:]


def yaw_quaternion(yaw: float, roll: float = 0.0) -> list:
    """A rotation by ``yaw`` about z after ``roll`` about x, as [w, x, y, z]."""
    qz = Quaternion([math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)])
    qx = Quaternion([math.cos(roll / 2), math.sin(roll / 2), 0.0, 0.0])
    return list((qz * qx).q)


# ------------------------------------------------------------------ nuscenes


class Box:
    """``nuscenes.utils.data_classes.Box``: centre, size (w, l, h),
    orientation, name."""

    def __init__(self, center, size, orientation: Quaternion, name=None, token=None):
        self.center = np.array(center, np.float64)
        self.wlh = np.array(size, np.float64)
        self.orientation = orientation
        self.name = name
        self.token = token

    def translate(self, x) -> None:
        self.center = self.center + x

    def rotate(self, quaternion: Quaternion) -> None:
        self.center = quaternion.rotate(self.center)
        self.orientation = quaternion * self.orientation


class NuScenes:
    """``nuscenes.NuScenes`` over the tables ``install`` was given (the same
    tables for every version; ``splits`` says which scenes each holds)."""

    tables: dict = {}

    def __init__(self, version: str = "v1.0-mini", dataroot: str = "", verbose: bool = False):
        self.version, self.dataroot = version, dataroot
        self.sample = list(self.tables["sample"].values())
        self.scene = list(self.tables["scene"].values())

    def get(self, table: str, token: str) -> dict:
        return self.tables[table][token]

    def get_boxes(self, sample_data_token: str) -> list:
        sample, = [s for s in self.sample if s["data"]["LIDAR_TOP"] == sample_data_token]
        boxes = []
        for token in sample["anns"]:
            ann = self.get("sample_annotation", token)
            boxes.append(Box(ann["translation"], ann["size"], Quaternion(ann["rotation"]),
                             name=ann["category_name"], token=token))
        return boxes


SPLITS = {"train": ["scene-0001"], "val": ["scene-0002"], "mini_train": ["scene-0001"],
          "mini_val": ["scene-0002"], "test": ["scene-0001", "scene-0002"]}

# (category, attribute or None, size w l h, lidar-frame centre, yaw)
INSTANCES = (
    ("vehicle.car", "vehicle.moving", (1.9, 4.5, 1.6), (6.0, 2.0, -1.0), 0.3),
    ("human.pedestrian.adult", "pedestrian.standing", (0.7, 0.7, 1.7), (-4.0, 5.0, -0.9), -1.2),
    ("vehicle.truck", None, (2.5, 6.9, 2.8), (-8.0, -6.0, -0.4), 2.0),
    ("animal", None, (0.5, 1.0, 0.6), (3.0, -9.0, -1.4), 0.0),
)
POINTS_IN_BOX = 40


def make_nuscenes(root: Path, seed: int = 0, sweeps_between: int = 3) -> dict:
    """Tables of a three-scene nuScenes stand-in (scene-0001: 2 samples,
    scene-0002: 2, scene-0003: 1 and in no split), ``sweeps_between``
    non-key lidar sweeps before each keyframe, and every lidar file under
    ``root`` as (N, 5) f32 [x y z intensity ring] in its sensor's frame.
    Each keyframe has the four ``INSTANCES``' annotations, which hold
    ``POINTS_IN_BOX`` points of its file; an instance's annotations are
    chained by ``prev`` / ``next`` (scene-0003's have neither), the
    pedestrian's in the last scene-0002 sample has ``num_lidar_pts`` 0
    and no points, and the truck and the animal have no attribute."""
    rng = np.random.default_rng(seed)
    t = {name: {} for name in ("scene", "sample", "sample_data", "sample_annotation", "ego_pose",
                               "calibrated_sensor", "attribute")}
    for name in ("vehicle.moving", "pedestrian.standing"):
        t["attribute"][f"attr-{name}"] = {"token": f"attr-{name}", "name": name}
    time_us = 1_500_000_000_000_000
    for s, n_samples in enumerate((2, 2, 1), start=1):
        scene = f"scene-{s:04d}"
        cs = {"token": f"cs-{s}", "translation": [0.94, 0.0, 1.84], "rotation": yaw_quaternion(-math.pi / 2, 0.01 * s)}
        t["calibrated_sensor"][cs["token"]] = cs
        t["scene"][f"scene-token-{s}"] = {"token": f"scene-token-{s}", "name": scene}
        prev_sd, prev_ann = "", {}
        for k in range(n_samples):
            for j in range(sweeps_between + 1):
                time_us += 50_000
                sd_token = f"sd-{s}-{k}-{j}"
                key = j == sweeps_between
                pose = {"token": f"pose-{sd_token}", "rotation": yaw_quaternion(0.1 + 1e-8 * (time_us % 10**9)),
                        "translation": [100.0 + 1e-6 * (time_us % 10**8), 50.0 + 0.1 * k, 0.0]}
                t["ego_pose"][pose["token"]] = pose
                folder = "samples" if key else "sweeps"
                sd = {"token": sd_token, "filename": f"{folder}/LIDAR_TOP/{sd_token}.bin", "timestamp": time_us,
                      "prev": prev_sd, "calibrated_sensor_token": cs["token"], "ego_pose_token": pose["token"],
                      "is_key_frame": key}
                t["sample_data"][sd_token] = sd
                prev_sd = sd_token
                pts = np.zeros((300, 5), np.float32)
                pts[:, :2] = rng.uniform(-20, 20, (300, 2))
                pts[:, 2] = rng.uniform(-2, 1, 300)
                pts[:, 3] = rng.uniform(0, 255, 300)
                if key:
                    sample = {"token": f"sample-{s}-{k}", "scene_token": f"scene-token-{s}", "timestamp": time_us,
                              "data": {"LIDAR_TOP": sd_token}, "anns": []}
                    t["sample"][sample["token"]] = sample
                    inside = []
                    for i, (category, attr, wlh, centre, yaw) in enumerate(INSTANCES):
                        empty = s == 2 and k == n_samples - 1 and category.startswith("human")
                        centre = np.asarray(centre) + [0.5 * k, 0.0, 0.0]
                        token = f"ann-{s}-{k}-{i}"
                        ann = {"token": token, "sample_token": sample["token"], "category_name": category,
                               "size": list(wlh), "num_lidar_pts": 0 if empty else POINTS_IN_BOX,
                               "attribute_tokens": [f"attr-{attr}"] if attr else [], "prev": prev_ann.get(i, ""),
                               "next": "", **global_box(centre, yaw, cs, pose)}
                        if ann["prev"]:
                            t["sample_annotation"][ann["prev"]]["next"] = token
                        prev_ann[i] = token
                        t["sample_annotation"][token] = ann
                        sample["anns"].append(token)
                        if not empty:
                            local = rng.uniform(-0.4, 0.4, (POINTS_IN_BOX, 3)) * [wlh[1], wlh[0], wlh[2]]
                            c, sn = math.cos(yaw), math.sin(yaw)
                            xyz = np.stack([local[:, 0] * c - local[:, 1] * sn, local[:, 0] * sn + local[:, 1] * c,
                                            local[:, 2]], axis=1) + centre
                            inside.append(np.concatenate([xyz, rng.uniform(0, 255, (POINTS_IN_BOX, 2))], axis=1))
                    pts = np.concatenate([pts, *inside]).astype(np.float32)
                path = root / sd["filename"]
                path.parent.mkdir(parents=True, exist_ok=True)
                pts.tofile(path)
    return t


def global_box(centre, yaw: float, cs: dict, pose: dict) -> dict:
    """An annotation's global translation and rotation from its centre and
    yaw in the lidar frame of ``cs`` on an ego at ``pose``."""
    q_cs, q_pose = Quaternion(cs["rotation"]), Quaternion(pose["rotation"])
    ego = q_cs.rotate(centre) + cs["translation"]
    world = q_pose.rotate(ego) + pose["translation"]
    return {"translation": list(world), "rotation": list((q_pose * q_cs * Quaternion(yaw_quaternion(yaw))).q)}


# ------------------------------------------------------------------ waymo_open_dataset


class Frame:
    """``dataset_pb2.Frame`` parsed from the pickled dict a test wrote."""

    def ParseFromString(self, data) -> None:
        d = pickle.loads(bytes(data))
        self.context = SimpleNamespace(name=d["name"],
                                       laser_calibrations=[SimpleNamespace(name=n) for n in d["lasers"]])
        self.timestamp_micros = d["timestamp_micros"]
        self.pose = SimpleNamespace(transform=list(d["pose"]))
        self.laser_labels = [
            SimpleNamespace(type=lab["type"], id=lab["id"], num_lidar_points_in_box=lab["num_points"],
                            box=SimpleNamespace(**dict(zip(("center_x", "center_y", "center_z", "length", "width",
                                                            "height", "heading"), lab["box"]))),
                            metadata=SimpleNamespace(speed_x=lab["speed"][0], speed_y=lab["speed"][1]))
            for lab in d["labels"]]
        self.range_images = d["range_images"]


def parse_range_image_and_camera_projection(frame):
    """(range images {laser: [return 1, return 2]}, camera projections,
    segmentation labels, top pose); each image has ``data`` and
    ``shape.dims`` like a ``MatrixFloat``."""
    images = {name: [SimpleNamespace(data=a.ravel(), shape=SimpleNamespace(dims=list(a.shape))) for a in returns]
              for name, returns in frame.range_images.items()}
    return images, {}, {}, None


def convert_range_image_to_point_cloud(frame, range_images, camera_projections, range_image_top_pose,
                                       ri_index: int = 0, keep_polar_features: bool = False):
    """Points of return ``ri_index``: one array a laser, lasers sorted by
    name, pixels with range > 0 in row-major order; a pixel's point lies
    at its range along the beam of its row (inclination) and column
    (azimuth) from the laser's mount."""
    points, cp_points = [], []
    for calibration in sorted(frame.context.laser_calibrations, key=lambda c: c.name):
        image = range_images[calibration.name][ri_index]
        values = np.asarray(image.data, np.float32).reshape(image.shape.dims)
        h, w = values.shape[:2]
        rows, cols = np.nonzero(values[..., 0] > 0)
        r = values[rows, cols, 0]
        incl = np.deg2rad(-15.0 + 20.0 * rows / h)
        az = np.pi - 2 * np.pi * (cols + 0.5) / w
        xyz = np.stack([r * np.cos(incl) * np.cos(az) + 0.1 * calibration.name,
                        r * np.cos(incl) * np.sin(az), r * np.sin(incl) + 2.0], axis=1)
        feats = [values[rows, cols, :3], xyz] if keep_polar_features else [xyz]
        points.append(np.concatenate(feats, axis=1).astype(np.float32))
        cp_points.append(np.zeros((len(r), 6), np.int32))
    return points, cp_points


LASERS = (2, 1)  # listed out of name order, as a file may list them
RANGE_IMAGE = (8, 24)


def waymo_frame(rng: np.random.Generator, name: str, timestamp_micros: int, index: int) -> dict:
    """One frame: two lasers x two returns of (8, 24, 4) range images
    [range, intensity, elongation, nlz] with ~20% of pixels at range <= 0
    (some -1, some 0) and ~10% of the rest flagged 1 (inside a no-label
    zone), the others -1; labels of each type (a sign, type 3, is
    skipped by the converters)."""
    images = {}
    for laser in LASERS:
        returns = []
        for _ in range(2):
            a = np.zeros((*RANGE_IMAGE, 4), np.float32)
            a[..., 0] = rng.uniform(2.0, 60.0, RANGE_IMAGE)
            a[..., 0][rng.uniform(size=RANGE_IMAGE) < 0.1] = -1.0
            a[..., 0][rng.uniform(size=RANGE_IMAGE) < 0.1] = 0.0
            a[..., 1] = rng.uniform(0.0, 3.0, RANGE_IMAGE)
            a[..., 2] = rng.uniform(0.0, 0.5, RANGE_IMAGE)
            a[..., 3] = np.where(rng.uniform(size=RANGE_IMAGE) < 0.1, 1.0, -1.0)
            returns.append(a)
        images[laser] = returns
    pose = np.eye(4)
    pose[:2, 3] = [2.0 * index, 0.5 * index]
    labels = [{"type": typ, "id": f"{name}-obj{typ}", "num_points": 0 if typ == 2 and index == 0 else 30,
               "box": tuple(rng.uniform(-20, 20, 2)) + (0.5, 4.0, 2.0, 1.6, float(rng.uniform(-3, 3))),
               "speed": tuple(rng.normal(0, 2, 2))} for typ in (1, 2, 3, 4)]
    return {"name": name, "lasers": list(LASERS), "timestamp_micros": timestamp_micros,
            "pose": pose.ravel().tolist(), "labels": labels, "range_images": images}


def write_waymo_tfrecords(directory: Path, seed: int = 0, frames=(("segment-a", 6), ("segment-b", 2))) -> list:
    """TFRecord files ``<segment>.tfrecord`` of pickled ``waymo_frame``s
    (written with ``tf.io.TFRecordWriter``); returns the frames in file
    order."""
    import tensorflow as tf

    rng = np.random.default_rng(seed)
    directory.mkdir(parents=True, exist_ok=True)
    written = []
    for segment, count in frames:
        with tf.io.TFRecordWriter(str(directory / f"{segment}.tfrecord")) as writer:
            for i in range(count):
                frame = waymo_frame(rng, segment, 1_550_000_000_000_000 + 100_000 * i, i)
                writer.write(pickle.dumps(frame))
                written.append(frame)
    return written


def devkit_nlz(frame: dict) -> np.ndarray:
    """The NLZ flags of ``frame``'s points in the order the stand-in's
    ``convert_range_image_to_point_cloud`` emits them: return 1 then
    return 2, lasers sorted by name, pixels with range > 0 row-major."""
    flags = [frame["range_images"][laser][ri][..., 3][frame["range_images"][laser][ri][..., 0] > 0]
             for ri in (0, 1) for laser in sorted(frame["lasers"])]
    return np.concatenate(flags)


# ------------------------------------------------------------------ install


def _module(name: str, **attrs) -> types.ModuleType:
    module = types.ModuleType(name)
    module.__dict__.update(attrs)
    return module


def install(monkeypatch, nuscenes_tables: dict | None = None) -> None:
    """Put the stand-ins of ``nuscenes``, ``pyquaternion`` and
    ``waymo_open_dataset`` into ``sys.modules`` for the test."""
    import sys

    monkeypatch.setattr(NuScenes, "tables", nuscenes_tables or {})
    splits = _module("nuscenes.utils.splits", **SPLITS)
    data_classes = _module("nuscenes.utils.data_classes", Box=Box)
    utils = _module("nuscenes.utils", splits=splits, data_classes=data_classes)
    frame_utils = _module("waymo_open_dataset.utils.frame_utils",
                          parse_range_image_and_camera_projection=parse_range_image_and_camera_projection,
                          convert_range_image_to_point_cloud=convert_range_image_to_point_cloud)
    dataset_pb2 = _module("waymo_open_dataset.dataset_pb2", Frame=Frame)
    waymo_utils = _module("waymo_open_dataset.utils", frame_utils=frame_utils)
    for module in (
        _module("nuscenes", NuScenes=NuScenes, utils=utils), utils, splits, data_classes,
        _module("pyquaternion", Quaternion=Quaternion),
        _module("waymo_open_dataset", dataset_pb2=dataset_pb2, utils=waymo_utils), dataset_pb2, waymo_utils,
        frame_utils,
    ):
        monkeypatch.setitem(sys.modules, module.__name__, module)
