"""Waymo Open Dataset converter: TFRecord -> per-frame .bin + infos pickle.

The port's own copy of pillarnext_tpu/data/waymo_converter.py (capability
parity with the reference waymo_convert.py:20-200): decompress the range
images, rebuild cartesian points for both lidar returns (per-pixel pose for
the TOP lidar), tanh the intensity, carry each point's no-label-zone flag,
extract the objects with their ego-frame speed, and keep up to 4 prior
frames as sweeps.

The NLZ flag is the range image's channel 3 (1 inside a no-label zone, -1
outside), as the reference reads it (waymo_convert.py:100-104); the loader
keeps the points whose flag is -1 (data/datasets.py).  The JAX package's
copy writes -1 for every point, so its loader keeps the NLZ points too.

Running ``convert`` needs ``tensorflow`` and the official
``waymo_open_dataset`` package (protos and range-image utilities), the
reference's own dependencies.  Importing this module needs neither;
``convert`` raises ``ImportError`` when one is absent.

Output schema (interchangeable with the reference, waymo_convert.py:165-196):
  lidar_point/<token>.bin       float32 (N, 6): x y z tanh(intensity) elongation nlz
  waymo_infos_{split}.pkl       [{token, pose, timestamp, sweeps[<=4], objects}]
    objects: [{id, label, box[9]=(x,y,z,l,w,h,vx,vy,yaw), num_points}]
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np


def _require_devkit():
    try:
        import tensorflow  # noqa: F401
        from waymo_open_dataset import dataset_pb2  # noqa: F401
        from waymo_open_dataset.utils import frame_utils  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "tensorflow and waymo_open_dataset are required for offline Waymo "
            "conversion (the reference converter's own dependencies); install "
            "them on the data-prep host.  Training and evaluation read the "
            "produced .bin / .pkl files and do not need them."
        ) from e


LABEL_MAP = {1: "vehicle", 2: "pedestrian", 4: "cyclist"}  # 3 = sign (skipped)
MAX_SWEEPS = 4  # prior frames kept as sweeps


def nlz_flags(frame, range_images, ri_index: int) -> list[np.ndarray]:
    """Channel 3 of return ``ri_index``'s range images, one array per laser
    in the order ``frame_utils.convert_range_image_to_point_cloud`` emits
    points: lasers sorted by name, within a laser the pixels with range > 0
    in row-major order."""
    flags = []
    for calibration in sorted(frame.context.laser_calibrations, key=lambda c: c.name):
        image = range_images[calibration.name][ri_index]
        values = np.asarray(image.data, np.float32).reshape(tuple(image.shape.dims))
        flags.append(values[..., 3][values[..., 0] > 0])
    return flags


def convert_frame(frame) -> tuple[np.ndarray, list[dict]]:
    """One Frame proto -> (points (N, 6) f32, objects)."""
    from waymo_open_dataset.utils import frame_utils

    range_images, camera_projections, _, range_image_top_pose = (
        frame_utils.parse_range_image_and_camera_projection(frame)
    )
    points, flags = [], []
    for ri_index in (0, 1):
        pts, _ = frame_utils.convert_range_image_to_point_cloud(
            frame, range_images, camera_projections, range_image_top_pose,
            ri_index=ri_index, keep_polar_features=True,
        )
        nlz = nlz_flags(frame, range_images, ri_index)
        if [len(p) for p in pts] != [len(f) for f in nlz]:
            raise ValueError(
                f"return {ri_index + 1}: {[len(p) for p in pts]} points per laser "
                f"but {[len(f) for f in nlz]} pixels with range > 0"
            )
        points += pts
        flags += nlz
    # polar features: range, intensity, elongation, then x, y, z
    all_pts = np.concatenate(points, axis=0)
    xyz = all_pts[:, 3:6]
    intensity = np.tanh(all_pts[:, 1:2])  # waymo_convert.py:31
    elong = all_pts[:, 2:3]
    nlz = np.concatenate(flags).reshape(-1, 1)
    return np.concatenate([xyz, intensity, elong, nlz], axis=1).astype(np.float32), _extract_objects(frame)


def _extract_objects(frame) -> list[dict]:
    """Labels with ego-frame speed (waymo_convert.py:108-130)."""
    objects = []
    for label in frame.laser_labels:
        if label.type not in LABEL_MAP:
            continue
        box = label.box
        meta = label.metadata
        objects.append(
            {
                "id": label.id,
                "label": LABEL_MAP[label.type],
                "box": np.array(
                    [
                        box.center_x, box.center_y, box.center_z,
                        box.length, box.width, box.height,
                        meta.speed_x, meta.speed_y, box.heading,
                    ],
                    np.float32,
                ),
                "num_points": label.num_lidar_points_in_box,
            }
        )
    return objects


def convert(tfrecord_dir: str, out_dir: str, split: str = "train"):
    """Convert a directory of TFRecords (reference flow waymo_convert.py:142-196)."""
    _require_devkit()
    import tensorflow as tf
    from waymo_open_dataset import dataset_pb2

    out = Path(out_dir)
    (out / "lidar_point").mkdir(parents=True, exist_ok=True)
    infos = []
    for record in sorted(Path(tfrecord_dir).glob("*.tfrecord*")):
        frame_infos: list[dict] = []
        for data in tf.data.TFRecordDataset(str(record), compression_type=""):
            frame = dataset_pb2.Frame()
            frame.ParseFromString(bytearray(data.numpy()))
            token = f"{frame.context.name}-{frame.timestamp_micros}"
            points, objects = convert_frame(frame)
            points.tofile(out / "lidar_point" / f"{token}.bin")

            info = {
                "token": token,
                "pose": np.array(frame.pose.transform, np.float64).reshape(4, 4),
                "timestamp": frame.timestamp_micros * 1e-6,
                "objects": objects,
                "sweeps": [],
            }
            # previous frames as sweeps, nearest first (waymo_convert.py:165-176)
            for prev in frame_infos[-MAX_SWEEPS:][::-1]:
                info["sweeps"].append(
                    {
                        "token": prev["token"],
                        "pose": prev["pose"],
                        "timestamp": info["timestamp"] - prev["timestamp"],
                    }
                )
            frame_infos.append(info)
        infos.extend(frame_infos)
        print(f"{record.name}: {len(frame_infos)} frames", flush=True)

    with open(out / f"waymo_infos_{split}.pkl", "wb") as f:
        pickle.dump(infos, f)
    print(f"wrote {len(infos)} infos")


def create_waymo_infos(root_path: str, split: str = "train"):
    """Convert ``root_path/tfrecord_{split}`` into ``root_path``."""
    convert(str(Path(root_path) / f"tfrecord_{split}"), root_path, split=split)
