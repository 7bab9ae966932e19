"""nuScenes detection evaluation.

The port's own copy of pillarnext_tpu/data/nuscenes_eval.py.

Two halves, mirroring the reference protocol (det3d/datasets/nuscenes/
nusc.py:123-245, nusc_common.py:204-246):

1. **Submission JSON** in the official nuScenes format: detections are
   transformed lidar -> global using the ``ref_from_car`` / ``car_from_global``
   matrices already stored in the infos pickle (nusc_common.py:331-347) —
   no devkit required — with the velocity-based attribute rules
   (nusc.py:152-171) and per-class prior-argmax defaults (nusc_common.py:42-153).

2. **Metric computation**: if the official ``nuscenes-devkit`` is importable
   it is used (exactly like the reference); otherwise a self-contained
   implementation of the `detection_cvpr_2019` protocol runs: per-class
   center-distance matching at {0.5, 1, 2, 4} m, 101-point interpolated AP
   over recall/precision in [0.1, 1], TP metrics (ATE/ASE/AOE/AVE/AAE) at
   the 2 m threshold, and NDS.  Matching happens in the lidar frame — center
   distances, velocity differences, and yaw differences are invariant under
   the per-sample rigid transform to global, so the scores are identical.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

# argmax of the attribute priors (nusc_common.py:42-153); all-zero rows
# fall back to the first key, matching Python max() over the dict items.
DEFAULT_ATTRIBUTE = {
    "barrier": "cycle.with_rider",
    "bicycle": "cycle.without_rider",
    "bus": "vehicle.moving",
    "car": "vehicle.parked",
    "construction_vehicle": "vehicle.parked",
    "motorcycle": "cycle.without_rider",
    "pedestrian": "pedestrian.moving",
    "traffic_cone": "cycle.with_rider",
    "trailer": "vehicle.parked",
    "truck": "vehicle.parked",
}

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1

# classes where a TP metric is undefined in the official protocol
NO_VELOCITY = {"barrier", "traffic_cone"}
NO_ATTRIBUTE = {"barrier", "traffic_cone"}
NO_ORIENTATION = {"traffic_cone"}
PERIOD_PI = {"barrier"}  # orientation error modulo pi


def _rotmat_to_quat(r: np.ndarray) -> list[float]:
    """Rotation matrix -> quaternion [w, x, y, z] (Shepperd's method)."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                (r[1, 0] - r[0, 1]) / s]
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(r[i, i] - r[j, j] - r[k, k] + 1.0) * 2
    q = [0.0, 0.0, 0.0, 0.0]
    q[0] = (r[k, j] - r[j, k]) / s
    q[i + 1] = 0.25 * s
    q[j + 1] = (r[j, i] + r[i, j]) / s
    q[k + 1] = (r[k, i] + r[i, k]) / s
    return q


def _attr_for(name: str, velocity_xy: np.ndarray) -> str:
    """Velocity-based attribute rules (nusc.py:152-171)."""
    speed = float(np.sqrt(velocity_xy[0] ** 2 + velocity_xy[1] ** 2))
    if speed > 0.2:
        if name in ("car", "construction_vehicle", "bus", "truck", "trailer"):
            return "vehicle.moving"
        if name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
    else:
        if name == "pedestrian":
            return "pedestrian.standing"
        if name == "bus":
            return "vehicle.parked"
    return DEFAULT_ATTRIBUTE[name]


def detections_to_submission(
    infos_by_token: dict, detections: dict, class_names: list[str]
) -> dict:
    """Build the official results JSON dict from lidar-frame detections.

    ``detections[token]`` = {'box3d_lidar': (D, 9), 'scores': (D,),
    'label_preds': (D,)} (already validity-trimmed numpy).
    """
    results = {}
    for token, det in detections.items():
        info = infos_by_token[token]
        # lidar -> global: p_l = ref_from_car @ car_from_global @ p_g
        t_l_from_g = np.asarray(info["ref_from_car"]) @ np.asarray(
            info["car_from_global"]
        )
        t_g_from_l = np.linalg.inv(t_l_from_g)
        rot = t_g_from_l[:3, :3]

        annos = []
        boxes = np.asarray(det["box3d_lidar"], np.float64)
        scores = np.asarray(det["scores"], np.float64)
        labels = np.asarray(det["label_preds"], np.int64)
        for i in range(boxes.shape[0]):
            b = boxes[i]
            name = class_names[labels[i]]
            center = rot @ b[:3] + t_g_from_l[:3, 3]
            vel_g = rot @ np.array([b[6], b[7], 0.0])
            yaw = b[8]
            r_box = rot @ np.array(
                [
                    [np.cos(yaw), -np.sin(yaw), 0],
                    [np.sin(yaw), np.cos(yaw), 0],
                    [0, 0, 1],
                ]
            )
            annos.append(
                {
                    "sample_token": token,
                    "translation": center.tolist(),
                    "size": [float(b[4]), float(b[3]), float(b[5])],  # w, l, h
                    "rotation": _rotmat_to_quat(r_box),
                    "velocity": vel_g[:2].tolist(),
                    "detection_name": name,
                    "detection_score": float(scores[i]),
                    "attribute_name": _attr_for(name, b[6:8]),
                }
            )
        results[token] = annos
    return {
        "results": results,
        "meta": {
            "use_camera": False,
            "use_lidar": True,
            "use_radar": False,
            "use_map": False,
            "use_external": False,
        },
    }


# ------------------------------------------------------------ metric kernel


N_BINS = 101  # recall grid resolution of the official protocol


def _accumulate_bins(
    tp_flags: np.ndarray, scores: np.ndarray, n_gt: int
) -> tuple[np.ndarray, np.ndarray]:
    """Precision and confidence interpolated onto the official 101-point
    recall grid (semantics of nuscenes-devkit eval/detection/algo.py
    ``accumulate``: raw cumulative precision/recall, then ``np.interp`` with
    ``right=0`` — duplicated-recall behavior intentionally identical).

    ``tp_flags``/``scores`` are score-sorted descending.
    """
    tp_cum = np.cumsum(tp_flags)
    fp_cum = np.cumsum(~tp_flags)
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1)
    recall = tp_cum / n_gt
    rec_interp = np.linspace(0, 1, N_BINS)
    prec_b = np.interp(rec_interp, recall, precision, right=0)
    conf_b = np.interp(rec_interp, recall, scores, right=0)
    return prec_b, conf_b


def _calc_ap(prec_b: np.ndarray) -> float:
    """Official ``calc_ap``: mean precision over recall bins STRICTLY ABOVE
    MIN_RECALL (the +1 excludes the min-recall bin itself: 90 bins, not 91),
    precision clipped below MIN_PRECISION and renormalized."""
    prec = prec_b[round(100 * MIN_RECALL) + 1 :]
    prec = np.maximum(prec - MIN_PRECISION, 0.0)
    return float(np.mean(prec)) / (1.0 - MIN_PRECISION)


def _cummean(x: np.ndarray) -> np.ndarray:
    """Cumulative mean ignoring NaN entries (official ``cummean``): entry i
    is the mean of the non-NaN values among x[:i+1]; all-NaN input -> ones."""
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    count = np.cumsum(~np.isnan(x))
    total = np.nancumsum(x.astype(float))
    return np.divide(total, count, out=np.zeros_like(total), where=count != 0)


def _calc_tp(err_b: np.ndarray, conf_b: np.ndarray) -> float:
    """Official ``calc_tp``: mean of the binned error over recall bins
    (MIN_RECALL, max achieved recall]; 1.0 when that range is empty.  The
    max-achieved-recall bin is the last nonzero confidence bin."""
    first = round(100 * MIN_RECALL) + 1
    nonzero = np.nonzero(conf_b)[0]
    last = int(nonzero[-1]) if len(nonzero) else 0
    if last < first:
        return 1.0
    return float(np.mean(err_b[first : last + 1]))


def _yaw_diff(a: float, b: float, period: float) -> float:
    d = (a - b) % period
    if d > period / 2:
        d = period - d
    return abs(d)


def _match_class(
    dets: list,
    gts_by_token: dict,
    dist_th: float,
    with_tp: bool,
    gt_attrs_by_token: dict | None = None,
    det_attr_name: str | None = None,
):
    """Greedy score-ordered center-distance matching for one class.

    ``dets``: list of (score, token, box9), SORTED descending by score;
    ``gts_by_token``: token -> (M, 9) array.  Returns tp flags + optional
    per-TP error records.

    Attribute error: predicted attribute comes from the velocity rules (the
    same rules the submission writer applies, nusc.py:152-171); GT attribute
    from infos' ``gt_attributes`` when carried.  A TP whose GT attribute is
    void ('') carries a NaN attr error (skipped by the official cummean),
    as in the official protocol.
    """
    n_gt = sum(len(g) for g in gts_by_token.values())
    taken: dict = {t: np.zeros(len(g), bool) for t, g in gts_by_token.items()}
    tp_flags = np.zeros(len(dets), bool)
    # (score, trans, scale, yaw_det, yaw_gt, vel, attr_err or None)
    errors = []

    for di, (score, token, box) in enumerate(dets):
        gts = gts_by_token.get(token)
        if gts is None or len(gts) == 0:
            continue
        free = ~taken[token]
        if not free.any():
            continue
        d2 = np.linalg.norm(gts[:, :2] - box[:2], axis=1)
        d2[~free] = np.inf
        j = int(np.argmin(d2))
        if d2[j] >= dist_th:
            continue
        taken[token][j] = True
        tp_flags[di] = True
        if with_tp:
            gt = gts[j]
            trans = float(d2[j])
            # ASE: 1 - IoU of aligned, centered boxes
            inter = np.prod(np.minimum(box[3:6], gt[3:6]))
            union = np.prod(box[3:6]) + np.prod(gt[3:6]) - inter
            scale = 1.0 - inter / max(union, 1e-9)
            vel = float(np.linalg.norm(box[6:8] - gt[6:8]))
            attr_err = None
            if gt_attrs_by_token is not None and det_attr_name is not None:
                gt_attr = gt_attrs_by_token.get(token)
                gt_attr = gt_attr[j] if gt_attr is not None else ""
                if gt_attr:
                    attr_err = float(
                        _attr_for(det_attr_name, box[6:8]) != gt_attr
                    )
                else:
                    attr_err = float("nan")
            errors.append((score, trans, scale, box[8], gt[8], vel, attr_err))
    return n_gt, tp_flags, errors


def evaluate_protocol(
    gt_by_token: dict, detections: dict, class_names: list[str]
) -> dict:
    """Self-contained `detection_cvpr_2019` scoring in the lidar frame.

    ``gt_by_token``: token -> {'gt_boxes': (M, 9), 'gt_names': (M,)}.
    ``detections``: token -> {'box3d_lidar','scores','label_preds'} numpy.
    Returns {'label_aps', 'tp_errors', 'mean_ap', 'nd_score', ...}.
    """
    label_aps: dict = {}
    label_tp: dict = {}

    for ci, name in enumerate(class_names):
        cls_dets = []
        for token, det in detections.items():
            sel = np.asarray(det["label_preds"]) == ci
            boxes = np.asarray(det["box3d_lidar"])[sel]
            scores = np.asarray(det["scores"])[sel]
            for s, b in zip(scores, boxes):
                cls_dets.append((float(s), token, b))
        has_attrs = bool(gt_by_token) and all(
            "gt_attributes" in gt for gt in gt_by_token.values()
        )
        cls_gts = {}
        cls_gt_attrs: dict | None = {} if has_attrs else None
        for token, gt in gt_by_token.items():
            sel = np.asarray(gt["gt_names"]) == name
            cls_gts[token] = np.asarray(gt["gt_boxes"], np.float64)[sel]
            if has_attrs:
                cls_gt_attrs[token] = np.asarray(gt["gt_attributes"])[sel]

        cls_dets.sort(key=lambda d: -d[0])
        scores = np.asarray([d[0] for d in cls_dets], np.float64)

        aps = {}
        tp_metrics = None
        for dist_th in DIST_THRESHOLDS:
            n_gt, tp_flags, errors = _match_class(
                cls_dets,
                cls_gts,
                dist_th,
                with_tp=(dist_th == TP_THRESHOLD),
                gt_attrs_by_token=cls_gt_attrs,
                det_attr_name=name,
            )
            if n_gt == 0 or tp_flags.size == 0:
                ap, conf_b = 0.0, np.zeros(N_BINS)
            else:
                prec_b, conf_b = _accumulate_bins(tp_flags, scores, n_gt)
                ap = _calc_ap(prec_b)
            aps[str(dist_th)] = ap
            if dist_th == TP_THRESHOLD:
                tp_metrics = _tp_errors(name, errors, conf_b)
        label_aps[name] = aps
        label_tp[name] = tp_metrics

    mean_ap = float(np.mean([np.mean(list(a.values())) for a in label_aps.values()]))

    metric_names = ["trans_err", "scale_err", "orient_err", "vel_err", "attr_err"]
    tp_means = {}
    for m in metric_names:
        vals = [label_tp[c][m] for c in class_names if not np.isnan(label_tp[c][m])]
        tp_means[m] = float(np.mean(vals)) if vals else 1.0

    nds = (
        5.0 * mean_ap + sum(max(1.0 - min(1.0, tp_means[m]), 0.0) for m in metric_names)
    ) / 10.0

    return {
        "label_aps": label_aps,
        "label_tp_errors": label_tp,
        "tp_errors": tp_means,
        "mean_ap": mean_ap,
        "nd_score": float(nds),
    }


def _tp_errors(name, errors, conf_b):
    """Class TP metrics, official estimator: the per-TP error sequences (in
    confidence order) are CUMULATIVE-MEANED, interpolated onto the 101-bin
    recall grid via the binned confidences, then averaged over recall bins
    (MIN_RECALL, max achieved recall] — semantics of the devkit's
    ``accumulate`` match_data interpolation + ``calc_tp``.  NaN marks
    metrics the protocol excludes for this class."""
    nan = float("nan")
    out = {"trans_err": 1.0, "scale_err": 1.0, "orient_err": 1.0,
           "vel_err": 1.0, "attr_err": 1.0}
    if errors:
        period = np.pi if name in PERIOD_PI else 2 * np.pi
        conf_tp = np.asarray([e[0] for e in errors], np.float64)
        seqs = {
            "trans_err": np.asarray([e[1] for e in errors], np.float64),
            "scale_err": np.asarray([e[2] for e in errors], np.float64),
            "orient_err": np.asarray(
                [_yaw_diff(e[3], e[4], period) for e in errors], np.float64
            ),
            "vel_err": np.asarray([e[5] for e in errors], np.float64),
            "attr_err": np.asarray(
                [nan if e[6] is None else e[6] for e in errors], np.float64
            ),
        }
        for m, seq in seqs.items():
            cm = _cummean(seq)
            # xp must increase for np.interp: confidences descend, reverse
            err_b = np.interp(conf_b[::-1], conf_tp[::-1], cm[::-1])[::-1]
            out[m] = _calc_tp(err_b, conf_b)
    if name in NO_VELOCITY:
        out["vel_err"] = nan
    if name in NO_ATTRIBUTE:
        out["attr_err"] = nan
    if name in NO_ORIENTATION:
        out["orient_err"] = nan
    return out


# --------------------------------------------------------------- entry point


def evaluate(dataset, detections: dict, output_dir=None, class_names=None) -> dict:
    """Full evaluation: write the submission JSON, then score (devkit when
    available, self-contained protocol otherwise)."""
    output_dir = Path(output_dir or "results")
    output_dir.mkdir(parents=True, exist_ok=True)
    infos_by_token = {info["token"]: info for info in dataset.infos}

    # sanity: one detection dict per val sample (the reference hard-asserts
    # the 6019-sample nuScenes val count, nusc.py:133 — the generic form
    # catches dropped samples in the distributed eval gather)
    if len(detections) != len(infos_by_token):
        raise AssertionError(
            f"got {len(detections)} detection entries for "
            f"{len(infos_by_token)} dataset samples — eval gather dropped or "
            "duplicated samples"
        )

    submission = detections_to_submission(infos_by_token, detections, class_names)
    res_path = output_dir / "results_nusc.json"
    with open(res_path, "w") as f:
        json.dump(submission, f)

    try:
        return _evaluate_devkit(dataset, res_path, output_dir, class_names)
    except ImportError:
        pass

    # self-contained protocol path: needs GT in the infos
    gt_by_token = {}
    for token, info in infos_by_token.items():
        if token not in detections:
            continue
        if "gt_boxes" not in info:
            return {
                "nusc": "submission written to %s; metric skipped (no devkit "
                "and val infos carry no gt_boxes)" % res_path
            }
        gt_by_token[token] = {
            "gt_boxes": np.asarray(info["gt_boxes"]),
            "gt_names": np.asarray(info["gt_names"]),
        }
        if "gt_attributes" in info:
            gt_by_token[token]["gt_attributes"] = np.asarray(info["gt_attributes"])
    metrics = evaluate_protocol(gt_by_token, detections, class_names)

    with open(output_dir / "metrics_summary.json", "w") as f:
        json.dump(metrics, f, indent=2)

    lines = [f"mAP: {metrics['mean_ap']:.4f}  NDS: {metrics['nd_score']:.4f}"]
    for name in class_names:
        aps = metrics["label_aps"][name]
        lines.append(
            f"{name}: " + ", ".join(f"AP@{k}m {v * 100:.2f}" for k, v in aps.items())
        )
    return {"nusc": "\n".join(lines), "mean_ap": metrics["mean_ap"],
            "nd_score": metrics["nd_score"], "tp_errors": metrics["tp_errors"]}


def _evaluate_devkit(dataset, res_path, output_dir, class_names):
    """Official devkit path (same flow as the reference nusc_common.py:486-497)."""
    from nuscenes import NuScenes  # noqa: F401  (ImportError -> fallback)
    from nuscenes.eval.detection.config import config_factory
    from nuscenes.eval.detection.evaluate import NuScenesEval

    eval_set_map = {"v1.0-mini": "mini_val", "v1.0-trainval": "val", "v1.0-test": "test"}
    nusc = NuScenes(version=dataset.version, dataroot=str(dataset._root_path), verbose=False)
    nusc_eval = NuScenesEval(
        nusc,
        config=config_factory("detection_cvpr_2019"),
        result_path=str(res_path),
        eval_set=eval_set_map[dataset.version],
        output_dir=str(output_dir),
    )
    nusc_eval.main(plot_examples=0, render_curves=False)
    with open(Path(output_dir) / "metrics_summary.json") as f:
        metrics = json.load(f)
    return {"nusc": json.dumps(metrics["mean_dist_aps"]),
            "mean_ap": metrics["mean_ap"], "nd_score": metrics["nd_score"]}
