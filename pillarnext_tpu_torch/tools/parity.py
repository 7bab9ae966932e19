"""What the port's full-scale parity tools share: the verdict, the port's
side as served, the mirror's side in full f32, and the trained weights.

``compare_detections`` is the verdict of tools/flagship_parity.py:270-380
(greedy nearest-centre 1:1 matching with a 0.5 m gate, its diagnostics,
its bars), with each of its asserts an explicit raise so that no
interpreter flag can drop one, and the figures returned.  The three tools
(``flagship_parity``, ``voxel_parity``, ``mvf_parity``) hold the port's
``AdaptivePredictor.predict`` against the port's own copies of the
reference mirrors (``reference_mirror*``) on the same frame with the same
weights; ``mirror_forward`` runs a mirror under ``full_f32()``, so TF32 is
off on the card.  ``trained_weights`` overfits the port on one planted
scene (``utils/synth.synth_detection_scene``), as the JAX tools overfit
their model (tools/flagship_parity.py:41-110).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from pillarnext_tpu_torch.models.detector import full_f32
from pillarnext_tpu_torch.serving import AdaptivePredictor
from pillarnext_tpu_torch.tools import reference_mirror as tm
from pillarnext_tpu_torch.utils.profiling import synchronize

# the random-weight bar (tools/flagship_parity.py:375)
RANDOM_MIN_MATCHED, RANDOM_BOX_TOL, RANDOM_SCORE_TOL = 0.85, 0.5, 2e-3
# the trained-weight bars: the pillar flagship, the 3-D families
# (tools/voxel_parity.py:172-178, tools/mvf_parity.py:159-162)
FLAGSHIP_TOLS = (1e-2, 1e-3)
FAMILY_3D_TOLS = (5e-2, 5e-3)
# what a bucketed or repaired predict may differ from the unbucketed one by
SERVED_BOX_TOL, SERVED_SCORE_TOL = 1e-3, 1e-4


def compare_detections(ref, ours, test_cfg, *, overfit, family="FLAGSHIP", box_tol=1e-2, score_tol=1e-3,
                       log=print) -> dict:
    """Greedy nearest-centre 1:1 matching and the parity verdict between two
    ragged detection sets (``box3d_lidar``, ``scores``, ``label_preds``).
    Raises AssertionError on a count mismatch; with ``overfit`` (trained
    weights) unless the sets are exactly equal (every detection matched
    with its label, boxes within ``box_tol``, scores within ``score_tol``)
    and not empty; without it unless 85% are matched with their label,
    boxes within 0.5 and scores within 2e-3.  Returns the figures."""
    # score-sorted positional pairing mispairs near-tied scores: with random
    # weights many detections score within 1e-4 of each other and their
    # order is not stable across implementations
    def key(d):
        return np.argsort(-d["scores"], kind="stable")

    ri, oi = key(ref), key(ours)
    n = min(len(ri), len(oi))
    if len(ri) != len(oi):
        # diagnose: per-label counts and the scores around the disagreement
        labels = np.concatenate([ref["label_preds"], ours["label_preds"]])
        for lb in range(int(labels.max()) + 1 if len(labels) else 0):
            rc = int((ref["label_preds"] == lb).sum())
            oc = int((ours["label_preds"] == lb).sum())
            if rc != oc:
                rs = np.sort(ref["scores"][ref["label_preds"] == lb])
                os_ = np.sort(ours["scores"][ours["label_preds"] == lb])
                log(f"label {lb}: ref {rc} vs ours {oc}; ref min-kept {rs[:3]} ours min-kept {os_[:3]}")
        for name, d in (("ref", ref), ("ours", ours)):
            if len(d["scores"]):
                log(f"{name} score range {d['scores'].min()} {d['scores'].max()}")
        raise AssertionError(f"count mismatch: ref {len(ri)} vs ours {len(oi)}")
    if overfit and len(ri) == 0:
        # a 0 == 0 "pass" is vacuous: trained-weight parity must detect the
        # planted objects (an under-converged model with stale BN running
        # statistics, momentum 0.99, can suppress everything at eval)
        raise AssertionError("trained-weight parity produced no detections")
    if n == 0:
        raise AssertionError("no detections on either side: nothing to compare")
    rb, ob = ref["box3d_lidar"], ours["box3d_lidar"]
    # greedy 1:1 nearest-centre assignment with a 0.5 m gate.  With random
    # weights the heatmap is near-flat: out of ~1.8M cells x 6 tasks a few
    # dozen sit within f32 conv noise of score_threshold or of an NMS IoU
    # threshold and flip in or out of the set in one pipeline only.
    d2 = ((rb[:, None, :3] - ob[None, :, :3]) ** 2).sum(-1)
    taken = np.zeros(len(oi), bool)
    match = np.full(len(ri), -1, np.int64)
    for i in np.argsort(d2.min(axis=1)):  # most confident matches first
        j = next(j for j in np.argsort(d2[i]) if not taken[j])
        if d2[i, j] < 0.25:
            match[i], taken[j] = j, True
    got = match >= 0
    mi, mj = np.nonzero(got)[0], match[got]
    same = ref["label_preds"][mi] == ours["label_preds"][mj]
    si, sj = mi[same], mj[same]
    db = np.abs(rb[si] - ob[sj])
    db[:, -1] = np.minimum(db[:, -1], 2 * np.pi - db[:, -1])  # yaw mod 2 pi
    ds = np.abs(ref["scores"][si] - ours["scores"][sj])
    box = float(db.max()) if len(si) else float("inf")
    score = float(ds.max()) if len(si) else float("inf")
    result = {"ref": len(ri), "ours": len(oi), "matched": len(mi) / n, "same_label": len(si) / n,
              "max_box_delta": box, "max_score_delta": score}
    log(f"matched {len(mi)}/{n}, same-label {len(si)}/{n} ({result['same_label']:.1%}); on those: "
        f"max |box delta| {box:.2e}  max |score delta| {score:.2e}")
    thr = float(test_cfg["score_threshold"])
    # boundary evidence for the rest: the rectified score of a threshold cell
    # is thr^(1-r) * iou^r with iou = 1, r = 0.5 -> sqrt(thr).  Label flips of
    # matched pairs are class-argmax ties; unmatched detections threshold or
    # NMS-IoU flips.  Reported, not asserted (the flip set is noise).
    for name, sc in (("unmatched ref", ref["scores"][~got]),
                     ("unmatched ours", ours["scores"][np.setdiff1d(np.arange(len(oi)), mj)]),
                     ("label-flip pairs", ref["scores"][mi[~same]])):
        if len(sc):
            dist = np.abs(sc**2 - thr)  # raw-score distance to the threshold
            log(f"{name}: {len(sc)}; |raw score - thr| min/median/max = "
                f"{dist.min():.2e}/{np.median(dist):.2e}/{dist.max():.2e}")
    if overfit:
        # trained weights have score margins: the sets must be exactly equal
        if result["same_label"] != 1.0:
            raise AssertionError(f"trained-weight parity: only {result['same_label']:.1%} matched")
        if not (box < box_tol and score < score_tol):
            raise AssertionError(f"trained-weight parity: box delta {box} (< {box_tol}), "
                                 f"score delta {score} (< {score_tol})")
        log(f"TRAINED-WEIGHT {family}-PARITY OK (exact set equality)")
        return result
    # a random-weight flagship's whole kept-score mass lies within ~0.02 of
    # score_threshold, so every detection sits near one of three decision
    # surfaces (threshold, top-1000 cutoff, NMS IoU) and f32 noise between
    # two implementations flips ~9% of them
    if not (result["same_label"] >= RANDOM_MIN_MATCHED and box < RANDOM_BOX_TOL and score < RANDOM_SCORE_TOL):
        raise AssertionError(f"{family} parity: {result['same_label']:.1%} matched (>= 85%), box delta {box} "
                             f"(< {RANDOM_BOX_TOL}), score delta {score} (< {RANDOM_SCORE_TOL})")
    log(f"{family}-PARITY OK")
    return result


def ragged(out: dict, i: int = 0) -> dict:
    """Sample ``i`` of the port's fixed-size detections (``valid`` mask) as
    the ragged numpy dict of ``compare_detections`` and the mirror."""
    valid = out["valid"][i].cpu().numpy().astype(bool)
    return {"box3d_lidar": out["box3d_lidar"][i].float().cpu().numpy()[valid],
            "scores": out["scores"][i].float().cpu().numpy()[valid],
            "label_preds": out["label_preds"][i].cpu().numpy()[valid].astype(np.int64)}


def decode_cfg(model_cfg: dict) -> dict:
    """The mirror's ``reference_predict`` settings of a model config."""
    cfg = dict(model_cfg["post_processing"])
    cfg["pc_range"] = model_cfg["reader"]["pc_range"]
    cfg["voxel_size"] = model_cfg["reader"]["voxel_size"]
    cfg["out_size_factor"] = model_cfg["head"]["out_size_factor"]
    return cfg


def tasks_and_heads(model_cfg: dict) -> tuple[list, dict]:
    head = model_cfg["head"]
    return [list(t) for t in head["tasks"]], {k: tuple(v) for k, v in head["common_heads"].items()}


def mirror_forward(tmodel, inputs, device) -> tuple[list, float]:
    """A mirror's head maps (per task, name -> NCHW numpy), computed in full
    f32 (TF32 off), and its seconds."""
    synchronize(device)
    t0 = time.perf_counter()
    with torch.no_grad(), full_f32():
        preds = tmodel(inputs)
    preds = [{k: v.cpu().numpy() for k, v in pd.items()} for pd in preds]
    return preds, time.perf_counter() - t0


def mirror_predict(tmodel, inputs, model_cfg: dict, device, log=print) -> tuple[dict, float]:
    """The mirror's detections of one frame (reference decode, the C++
    oracle's NMS) and its seconds, decode included."""
    t0 = time.perf_counter()
    preds, _ = mirror_forward(tmodel, inputs, device)
    num_classes = [len(t) for t in model_cfg["head"]["tasks"]]
    ref = tm.reference_predict(preds, decode_cfg(model_cfg), model_cfg["head"]["rectifier"], num_classes)[0]
    seconds = time.perf_counter() - t0
    log(f"mirror: {seconds:.1f}s, {len(ref['scores'])} detections")
    return ref, seconds


def same_detections(a: dict, b: dict) -> dict:
    """How far two ragged detection sets of the port lie apart: counts, bit
    identity, and the largest box and score deltas of label-matched pairs
    (sorted by label, then score)."""
    rec = {"counts": [len(a["scores"]), len(b["scores"])]}
    rec["bit_identical"] = rec["counts"][0] == rec["counts"][1] and all(
        np.array_equal(a[k], b[k]) for k in ("box3d_lidar", "scores", "label_preds"))
    if rec["counts"][0] != rec["counts"][1]:
        return {**rec, "labels_equal": False, "max_box_delta": float("inf"), "max_score_delta": float("inf")}
    oa, ob = np.lexsort((-a["scores"], a["label_preds"])), np.lexsort((-b["scores"], b["label_preds"]))
    rec["labels_equal"] = bool(np.array_equal(a["label_preds"][oa], b["label_preds"][ob]))
    rec["max_box_delta"] = float(np.abs(a["box3d_lidar"][oa] - b["box3d_lidar"][ob]).max(initial=0.0))
    rec["max_score_delta"] = float(np.abs(a["scores"][oa] - b["scores"][ob]).max(initial=0.0))
    return rec


def port_predict(model, points, mask, device, log=print) -> tuple[dict, dict]:
    """The port's detections of one frame as served: the first frame of a
    fresh ``AdaptivePredictor`` (its bucket ladder, a repair where the
    first bucket overflows).  Beside it, an unbucketed ``model.predict`` at
    the reader's capacity and a predictor whose first bucket is half the
    frame's active count, so that its frame is repaired: both must give the
    served frame's detections (counts equal, labels equal, boxes within
    1e-3, scores within 1e-4).  Returns (ragged detections, the record)."""
    synchronize(device)
    t0 = time.perf_counter()
    engine = AdaptivePredictor(model)
    served = ragged(engine.predict(points, mask))
    synchronize(device)
    seconds = time.perf_counter() - t0
    tel: dict = {}
    with torch.inference_mode():
        whole = ragged(model.predict(points, mask, telemetry=tel))
    active = int(sum(v for k, v in tel.items() if k in ("pillar_active", "voxel_active")))
    forced = AdaptivePredictor(model, buckets=(max(active // 2, 1), int(model.reader.capacity)))
    repaired = ragged(forced.predict(points, mask))
    rec = {"port_seconds": seconds, "active": active, "served_bucket_repairs": engine.repaired,
           "forced_repairs": forced.repaired,
           "served_vs_unbucketed": same_detections(served, whole),
           "repaired_vs_unbucketed": same_detections(repaired, whole)}
    log(f"port: {seconds:.1f}s, {len(served['scores'])} detections served ({engine.repaired} repairs), "
        f"{len(whole['scores'])} unbucketed, {len(repaired['scores'])} after a forced repair")
    for name in ("served_vs_unbucketed", "repaired_vs_unbucketed"):
        d = rec[name]
        if forced.repaired != 1 or not (d["labels_equal"] and d["max_box_delta"] < SERVED_BOX_TOL
                                        and d["max_score_delta"] < SERVED_SCORE_TOL):
            raise AssertionError(f"{name}: the port's bucketed detections differ from its unbucketed ones "
                                 f"({forced.repaired} forced repairs): {d}")
    return served, rec


def head_deltas(mirror_maps: list, port_maps: list, log=print) -> dict:
    """The largest |mirror - port| of each raw head map (port NHWC, mirror
    NCHW), per task and name, and over all."""
    worst, per = 0.0, {}
    for task, (tp, pp) in enumerate(zip(mirror_maps, port_maps)):
        for name, tv in tp.items():
            pv = pp[name].float().permute(0, 3, 1, 2).cpu().numpy()
            d = float(np.abs(tv - pv).max())
            per[f"{task}/{name}"] = d
            log(f"task {task} {name:7s} max|delta| {d:.3e}  (max|ref| {float(np.abs(tv).max()):.3e})")
            worst = max(worst, d)
    log(f"HEADS max|delta| = {worst:.3e}")
    return {"max_abs_delta": worst, "per_map": per}


def planted_scene(model_cfg: dict, n_points: int, seed: int) -> tuple:
    """JAX's trained-weight scene (tools/flagship_parity.py:58-63): 24
    planted objects of every class of the config's tasks over a
    beam-structured background, from ``default_rng(seed + 7)``."""
    from pillarnext_tpu_torch.utils.synth import synth_detection_scene

    classes = [c for t in model_cfg["head"]["tasks"] for c in t]
    return synth_detection_scene(np.random.default_rng(seed + 7), n_points, model_cfg["reader"]["pc_range"],
                                 n_objects=24, class_names=classes)


def trained_weights(cfg: dict, steps: int, seed: int, n_points: int, device, log=print) -> tuple:
    """The config's model as its YAML gives it (bf16 on the card) overfitted
    for ``steps`` Trainer steps on ``planted_scene``; the loss must halve
    and no table may drop an active site (as JAX asserts at its step 0).
    Returns (the trained state_dict, the scene as (1, N, 5) points and mask
    tensors on ``device``, the overfit's record)."""
    from pillarnext_tpu_torch.tools.overfit_sanity import train_on_scene

    pts, gt, names = planted_scene(cfg["model"], n_points, seed)
    model, example, losses, seconds, _ = train_on_scene(cfg, pts, gt, names, steps, device, log,
                                                        raise_on_overflow=True)
    log(f"overfit: {steps} steps in {seconds:.0f}s, loss {losses[0]:.2f} -> {losses[-1]:.2f}")
    if not losses[-1] < losses[0] * 0.5:
        raise AssertionError(f"the overfit's loss did not halve: {losses[0]} -> {losses[-1]}")
    rec = {"overfit_steps": steps, "overfit_seconds": seconds, "loss_first": losses[0], "loss_last": losses[-1]}
    return model.state_dict(), (example["points"], example["points_mask"]), rec


def hold(family: str, mcfg: dict, model, tmodel, points, mask, mirror_inputs, *, trained: bool, tols=None,
         heads: bool = False, device="cuda:0", log=print) -> dict:
    """The port's f32 ``model`` against the mirror ``tmodel`` (moved to
    ``device`` here) on one frame, (1, N, 5) ``points`` and ``mask``
    tensors on ``device``; ``mirror_inputs(points, mask, device)`` forms the
    mirror's input.  With ``heads`` the raw head maps, else the detections:
    the port's as served (``port_predict``) against the mirror's, by
    ``compare_detections`` (trained: exact set equality within ``tols``).
    Returns the record (both ragged sets under ``detections``); raises on a
    miss."""
    tmodel.to(device)
    inputs = mirror_inputs(points, mask, device)
    rec = {}
    if type(model.reader).__name__ == "PillarFeatureNet":
        rec["zero_feature_pillars"] = zero_feature_pillars(model, points, mask)
        log(f"pillars active in the port with an all-zero PFN output: {rec['zero_feature_pillars']}")
    if heads:
        maps, rec["mirror_seconds"] = mirror_forward(tmodel, inputs, device)
        with torch.inference_mode():
            rec["heads"] = head_deltas(maps, model(points, mask), log)
        return rec
    ref, rec["mirror_seconds"] = mirror_predict(tmodel, inputs, mcfg, device, log)
    ours, rec_port = port_predict(model, points, mask, device, log)
    rec.update(rec_port)
    rec["detections"] = {"mirror": ref, "port": ours}
    box_tol, score_tol = tols or FLAGSHIP_TOLS
    rec.update(compare_detections(ref, ours, decode_cfg(mcfg), overfit=trained, family=family,
                                  box_tol=box_tol, score_tol=score_tol, log=log))
    return rec


def zero_feature_pillars(model, points, mask) -> int:
    """Pillars active in the port's compact table whose PFN output is all
    zero: active for the port's SubM stage, inactive in the pillar
    mirror's mask (``x.abs().sum(1) > 0``, ``reference_mirror.TBackbone``)."""
    with torch.inference_mode(), model.precision():
        sb = model.reader(points, mask)
    rows = sb.table[:sb.valid.shape[0]][sb.valid]
    return int((rows == 0).all(-1).sum())


def ragged_points(points, mask, device) -> np.ndarray:
    """The valid rows of sample 0 of (1, N, D) tensors, as host numpy: the
    3-D mirrors' input."""
    return points[0][mask[0].bool()].cpu().numpy()


def trained_run(family: str, config, eval_overrides: list, build_mirror, tols, steps: int, *, points: int,
                seed: int, heads: bool, device, overrides=(), trained=None, mirror_inputs=ragged_points,
                log=print) -> dict:
    """Trained-weight parity of one family: the port overfitted on
    ``planted_scene`` (``trained_weights``; or ``trained``, a state_dict
    and the (points, mask) it was trained on), its weights in the f32 eval
    model and through ``state_dict_to_reference`` in the mirror
    (``build_mirror(model_cfg)``), then ``hold``."""
    from pillarnext_tpu_torch.utils.builders import build_model
    from pillarnext_tpu_torch.utils.config import load_experiment
    from pillarnext_tpu_torch.utils.torch_import import state_dict_to_reference

    device = torch.device(device)
    cfg = load_experiment(config, list(overrides))
    mcfg = load_experiment(config, [*overrides, *eval_overrides])["model"]
    rec = {"config": Path(config).name, "mode": "trained"}
    if trained is None:
        sd, scene, rec_fit = trained_weights(cfg, steps, seed, points, device, log)
        rec.update(rec_fit)
    else:
        sd, scene = trained
    model = build_model(mcfg, device=device)
    model.load_state_dict(sd, strict=True)
    tmodel = build_mirror(mcfg)
    tmodel.load_state_dict(state_dict_to_reference(model.state_dict()), strict=True)
    pts, mask = (t.to(device) for t in scene)
    rec["points"] = int(mask.sum())
    rec.update(hold(family, mcfg, model, tmodel, pts, mask, mirror_inputs, trained=True, tols=tols,
                    heads=heads, device=device, log=log))
    return rec


def printable(rec: dict) -> dict:
    """A tool's record without its detection sets, for a JSON line."""
    return {k: v for k, v in rec.items() if k != "detections"}


def parser(description: str, overfit_default: int):
    """The tools' common arguments."""
    import argparse

    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--points", type=int, default=200_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--overfit", type=int, default=overfit_default, metavar="STEPS",
                    help="overfit the port STEPS Trainer steps on a planted scene, then require exact "
                         "detection-set equality")
    ap.add_argument("--heads", action="store_true", help="compare the raw per-task head maps instead")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("overrides", nargs="*", help="config overrides key.path=value (+key.path=value adds)")
    return ap
