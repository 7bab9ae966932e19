"""nuScenes infos builder (offline data preparation).

The port's own copy of pillarnext_tpu/data/nusc_converter.py.  It writes
the pickle schema the reference writes (nusc_common.py:340-347, 443-483),
so prepared data is interchangeable: per sample {lidar_path, token,
sweeps[<= nsweeps - 1 x {lidar_path, sample_data_token, transform_matrix,
time_lag}], ref_from_car, car_from_global, timestamp, gt_boxes
[x, y, z, l, w, h, vx, vy, yaw], gt_names, gt_attributes}.

Differences from the reference:
- the sweep transforms and the yaw are computed locally (no pyquaternion);
  only the box rotation into the lidar frame goes through the devkit's
  ``Box`` and ``Quaternion``, as in the reference;
- GT is written for the val split too (the self-contained scorer reads it
  when the official devkit is absent at eval time).

Running it needs the ``nuscenes`` devkit (and ``pyquaternion``) and the raw
data: it is an offline tool.  Importing this module needs neither; each is
imported at its call and a missing one raises ``ImportError``.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

# detection-class mapping (public nuScenes protocol table, nusc_common.py:16-40)
GENERAL_TO_DETECTION = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.wheelchair": "ignore",
    "human.pedestrian.stroller": "ignore",
    "human.pedestrian.personal_mobility": "ignore",
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "animal": "ignore",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.emergency.ambulance": "ignore",
    "vehicle.emergency.police": "ignore",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.pushable_pullable": "ignore",
    "movable_object.debris": "ignore",
    "static_object.bicycle_rack": "ignore",
}

SPLITS = {
    "v1.0-trainval": ("train", "val"),
    "v1.0-mini": ("mini_train", "mini_val"),
    "v1.0-test": ("test", None),
}


def _require(module: str, package: str):
    """Import ``module`` or raise an ImportError that names ``package``."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"{package} is required for offline nuScenes conversion (the "
            f"reference converter has the same dependency); install it on the "
            f"data-prep host.  Training and evaluation read the produced .pkl "
            f"files and do not need it."
        ) from e


def quat_to_rotmat(q) -> np.ndarray:
    """Unit quaternion [w, x, y, z] -> 3x3 rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def transform_matrix(translation, rotation_quat, inverse: bool = False) -> np.ndarray:
    """4x4 homogeneous transform from translation + [w, x, y, z] quaternion."""
    tm = np.eye(4)
    rot = quat_to_rotmat(rotation_quat)
    if inverse:
        tm[:3, :3] = rot.T
        tm[:3, 3] = -rot.T @ np.asarray(translation)
    else:
        tm[:3, :3] = rot
        tm[:3, 3] = translation
    return tm


def quaternion_yaw(q) -> float:
    """Yaw of the +x axis under quaternion [w, x, y, z] (devkit convention)."""
    v = quat_to_rotmat(q) @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def _box_velocity(nusc, ann_token: str, max_time_diff: float = 1.5) -> np.ndarray:
    """Finite-difference global-frame velocity (nusc_common.py:156-201)."""
    current = nusc.get("sample_annotation", ann_token)
    has_prev = current["prev"] != ""
    has_next = current["next"] != ""
    if not has_prev and not has_next:
        return np.array([np.nan, np.nan, np.nan])

    first = nusc.get("sample_annotation", current["prev"]) if has_prev else current
    last = nusc.get("sample_annotation", current["next"]) if has_next else current

    def _time(ann):
        return 1e-6 * nusc.get("sample", ann["sample_token"])["timestamp"]

    time_diff = _time(last) - _time(first)
    if time_diff > max_time_diff or time_diff <= 0:
        return np.array([np.nan, np.nan, np.nan])
    return (np.asarray(last["translation"]) - np.asarray(first["translation"])) / time_diff


def create_nuscenes_infos(root_path: str, version: str = "v1.0-trainval", nsweeps: int = 10):
    """Walk the devkit's tables and write the train / val infos pickles
    (``infos_test_{N}sweeps_withvelo.pkl`` alone for ``v1.0-test``);
    reference flow nusc_common.py:443-483, 311-426."""
    if version not in SPLITS:
        raise ValueError(version)
    NuScenes = _require("nuscenes", "the nuscenes devkit").NuScenes
    splits = _require("nuscenes.utils.splits", "the nuscenes devkit")

    nusc = NuScenes(version=version, dataroot=root_path, verbose=True)
    train_split, val_split = SPLITS[version]
    train_scenes = getattr(splits, train_split)
    val_scenes = getattr(splits, val_split) if val_split else []

    name_to_token = {s["name"]: s["token"] for s in nusc.scene}
    train_tokens = {name_to_token[n] for n in train_scenes if n in name_to_token}
    val_tokens = {name_to_token[n] for n in val_scenes if n in name_to_token}

    train_infos, val_infos = [], []
    for sample in nusc.sample:
        info = _fill_one(nusc, sample, nsweeps)
        # GT for BOTH splits (the reference only annotates train,
        # nusc_common.py:395-424; val GT feeds the self-contained scorer)
        _attach_gt(nusc, sample, info)
        if sample["scene_token"] in train_tokens:
            train_infos.append(info)
        elif sample["scene_token"] in val_tokens:
            val_infos.append(info)

    root = Path(root_path)
    if version == "v1.0-test":
        with open(root / f"infos_test_{nsweeps}sweeps_withvelo.pkl", "wb") as f:
            pickle.dump(train_infos, f)
        return

    with open(root / f"infos_train_{nsweeps}sweeps_withvelo_filterZero.pkl", "wb") as f:
        pickle.dump(train_infos, f)
    with open(root / f"infos_val_{nsweeps}sweeps_withvelo_filterZero.pkl", "wb") as f:
        pickle.dump(val_infos, f)
    print(f"train: {len(train_infos)}  val: {len(val_infos)}")


def _fill_one(nusc, sample, nsweeps):
    """One sample's lidar path, frames and up to ``nsweeps - 1`` earlier
    sweeps with their transforms into the keyframe's lidar frame."""
    ref_sd = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
    ref_cs = nusc.get("calibrated_sensor", ref_sd["calibrated_sensor_token"])
    ref_pose = nusc.get("ego_pose", ref_sd["ego_pose_token"])
    ref_time = 1e-6 * ref_sd["timestamp"]

    ref_from_car = transform_matrix(ref_cs["translation"], ref_cs["rotation"], inverse=True)
    car_from_global = transform_matrix(ref_pose["translation"], ref_pose["rotation"], inverse=True)

    info = {
        "lidar_path": ref_sd["filename"],
        "token": sample["token"],
        "sweeps": [],
        "ref_from_car": ref_from_car,
        "car_from_global": car_from_global,
        "timestamp": ref_time,
    }

    cur = ref_sd
    while len(info["sweeps"]) < nsweeps - 1 and cur["prev"]:
        cur = nusc.get("sample_data", cur["prev"])
        pose = nusc.get("ego_pose", cur["ego_pose_token"])
        cs = nusc.get("calibrated_sensor", cur["calibrated_sensor_token"])
        global_from_car = transform_matrix(pose["translation"], pose["rotation"], inverse=False)
        car_from_current = transform_matrix(cs["translation"], cs["rotation"], inverse=False)
        tm = ref_from_car @ car_from_global @ global_from_car @ car_from_current
        info["sweeps"].append(
            {
                "lidar_path": cur["filename"],
                "sample_data_token": cur["token"],
                "transform_matrix": tm,
                "time_lag": ref_time - 1e-6 * cur["timestamp"],
            }
        )
    return info


def _attach_gt(nusc, sample, info):
    """The keyframe's annotations with lidar points, in the lidar frame:
    ``gt_boxes`` (M, 9) f64 with the devkit's (w, l, h) stored as (l, w, h)
    and the velocity rotated into the lidar frame, ``gt_names`` (detection
    classes) and ``gt_attributes`` ('' where an annotation has none)."""
    _require("nuscenes.utils.data_classes", "the nuscenes devkit")

    ref_sd_token = sample["data"]["LIDAR_TOP"]
    boxes = nusc.get_boxes(ref_sd_token)  # global frame, in sample["anns"] order
    sd = nusc.get("sample_data", ref_sd_token)
    pose = nusc.get("ego_pose", sd["ego_pose_token"])
    cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])

    rows, names, attrs = [], [], []
    ref_rot = info["ref_from_car"][:3, :3] @ info["car_from_global"][:3, :3]
    for box, ann_token in zip(boxes, sample["anns"]):
        ann = nusc.get("sample_annotation", ann_token)
        if ann["num_lidar_pts"] <= 0:
            continue
        # at most one attribute per annotation in nuScenes ('' = void);
        # carried so the self-contained scorer computes a real AttrErr
        atoks = ann.get("attribute_tokens", [])
        attrs.append(nusc.get("attribute", atoks[0])["name"] if atoks else "")
        # devkit Box: global -> ego -> lidar frame
        box.translate(-np.asarray(pose["translation"]))
        box.rotate(_quat_inv(pose["rotation"]))
        box.translate(-np.asarray(cs["translation"]))
        box.rotate(_quat_inv(cs["rotation"]))

        vel = _box_velocity(nusc, ann_token)
        vel_l = ref_rot @ np.array([vel[0], vel[1], 0.0])
        wlh = box.wlh  # devkit order (w, l, h) -> stored (l, w, h)
        yaw = quaternion_yaw(box.orientation.elements)
        rows.append([*box.center, wlh[1], wlh[0], wlh[2], vel_l[0], vel_l[1], yaw])
        names.append(GENERAL_TO_DETECTION.get(box.name, "ignore"))

    info["gt_boxes"] = np.asarray(rows, np.float64).reshape(-1, 9)
    info["gt_names"] = np.asarray(names)
    info["gt_attributes"] = np.asarray(attrs)


def _quat_inv(q):
    Quaternion = _require("pyquaternion", "pyquaternion").Quaternion
    return Quaternion(q).inverse
