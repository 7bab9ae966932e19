"""Waymo evaluation export.

The port's own copy of pillarnext_tpu/data/waymo_eval.py.

Parity with the reference (waymo.py:86-126): serialize detections to
``waymo_preds.bin`` (a ``metrics_pb2.Objects`` proto) for offline scoring by
the official devkit CLI.  When the ``waymo_open_dataset`` package is present
the official protos are used (identical to the reference flow); otherwise
detections are saved as ``waymo_preds.npz`` plus a tiny conversion script, so
the proto can be produced bit-exactly on any host that has the devkit.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def label_to_type(label: int) -> int:
    """Class index -> waymo Label.Type (vehicle=1, pedestrian=2, cyclist=4);
    reference waymo.py:9-13."""
    return int(label) + 1 if label <= 1 else 4


def export_detections(detections: dict, output_dir=None) -> dict:
    output_dir = Path(output_dir or "results")
    output_dir.mkdir(parents=True, exist_ok=True)
    try:
        return _export_proto(detections, output_dir)
    except ImportError:
        return _export_npz(detections, output_dir)


def _export_proto(detections: dict, output_dir: Path) -> dict:
    from waymo_open_dataset import label_pb2
    from waymo_open_dataset.protos import metrics_pb2

    objects = metrics_pb2.Objects()
    for token, det in detections.items():
        boxes = np.asarray(det["box3d_lidar"])
        labels = np.asarray(det["label_preds"])
        scores = np.asarray(det["scores"])
        context, stamp = token.rsplit("-", 1)
        for i in range(boxes.shape[0]):
            b = boxes[i]
            o = metrics_pb2.Object()
            o.context_name = context
            o.frame_timestamp_micros = int(stamp)
            box = label_pb2.Label.Box()
            box.center_x, box.center_y, box.center_z = float(b[0]), float(b[1]), float(b[2])
            box.length, box.width, box.height = float(b[3]), float(b[4]), float(b[5])
            box.heading = float(b[-1])
            o.object.box.CopyFrom(box)
            o.score = float(scores[i])
            o.object.type = label_to_type(int(labels[i]))
            objects.objects.append(o)

    path = output_dir / "waymo_preds.bin"
    with open(path, "wb") as f:
        f.write(objects.SerializeToString())
    print(f"wrote {path}; score with the official devkit CLI")
    return {"waymo": f"predictions exported to {path}"}


_CONVERT_SNIPPET = """\
# Run on a host with waymo_open_dataset installed:
#   python convert_npz_to_proto.py waymo_preds.npz waymo_preds.bin
import sys
import numpy as np
from waymo_open_dataset import label_pb2
from waymo_open_dataset.protos import metrics_pb2

data = np.load(sys.argv[1], allow_pickle=True)
objects = metrics_pb2.Objects()
for token, boxes, labels, scores in zip(
    data["tokens"], data["boxes"], data["labels"], data["scores"]
):
    context, stamp = str(token).rsplit("-", 1)
    for b, l, s in zip(boxes, labels, scores):
        o = metrics_pb2.Object()
        o.context_name = context
        o.frame_timestamp_micros = int(stamp)
        o.object.box.center_x, o.object.box.center_y, o.object.box.center_z = b[0], b[1], b[2]
        o.object.box.length, o.object.box.width, o.object.box.height = b[3], b[4], b[5]
        o.object.box.heading = b[-1]
        o.score = float(s)
        o.object.type = int(l) + 1 if l <= 1 else 4
        objects.objects.append(o)
open(sys.argv[2], "wb").write(objects.SerializeToString())
"""


def _export_npz(detections: dict, output_dir: Path) -> dict:
    tokens, boxes, labels, scores = [], [], [], []
    for token, det in detections.items():
        tokens.append(token)
        boxes.append(np.asarray(det["box3d_lidar"]))
        labels.append(np.asarray(det["label_preds"]))
        scores.append(np.asarray(det["scores"]))
    path = output_dir / "waymo_preds.npz"
    np.savez_compressed(
        path,
        tokens=np.asarray(tokens),
        boxes=np.asarray(boxes, dtype=object),
        labels=np.asarray(labels, dtype=object),
        scores=np.asarray(scores, dtype=object),
    )
    script = output_dir / "convert_npz_to_proto.py"
    script.write_text(_CONVERT_SNIPPET)
    print(
        f"waymo_open_dataset not installed: wrote {path} + {script.name} "
        "(run it where the devkit is available to produce waymo_preds.bin)"
    )
    return {"waymo": f"predictions exported to {path} (npz fallback)"}
