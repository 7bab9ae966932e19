"""Evaluation cells: ``AdaptivePredictor.predict`` at the cell's batch, a
closed loop of one client over the pool.

Set-up builds the eval model, loads the weights the benchmark made and
warms the predictor (``AdaptivePredictor.warmup``: both buckets, the
capacity tracker).  In the window each batch is dispatched after the
previous one's detections are on the host; ``eval_frames_per_s`` counts
the frames with detections over the window, ``eval_batch_ms_p95`` is the
95th percentile of every batch's dispatch-to-host time.  A frame fails
when its predict raises.  After the window, batches sampled from the
seed are run through the reference and their detections compared.

The traced run replaces the window by two stretches of the same loop:
``host_batches`` batches untraced, with a forward hook on the neck that
stamps the host clock (the host's time after the neck, the seconds and
the reference FLOPs that ``head_host_ms.eval``, ``eval_mfu`` and
``idle_pct.eval`` read), then ``trace_batches`` under torch.profiler
(the device's busy time, the backbone's range, the breakdown).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import check, common, counts, trace
from benchmark.launches import Recorder
from benchmark.reference import postprocess
from benchmark.reference.model import Detector, f32
from benchmark.traffic import pool as make_pool


def host(out: dict) -> list:
    """A predict's fixed-size detections as per-frame numpy dicts of the
    valid ones."""
    valid = out["valid"].cpu().numpy().astype(bool)
    boxes, scores, labels = (out[k].float().cpu().numpy() if k != "label_preds" else out[k].cpu().numpy()
                             for k in ("box3d_lidar", "scores", "label_preds"))
    return [{"boxes": boxes[i][valid[i]], "scores": scores[i][valid[i]], "labels": labels[i][valid[i]]}
            for i in range(len(valid))]


def run(r: common.Run, program=None) -> None:
    """``program``, when given, wraps the predict (``(points, mask) ->
    frames``) and returns the one the window runs: a fault for the tests."""
    from pillarnext_tpu_torch.serving import AdaptivePredictor
    from pillarnext_tpu_torch.utils.builders import build_model

    spec, dev = r.spec, r.device
    exp, traffic = spec.config["experiment"], spec.traffic
    batches = [common.to_device(b, dev) for b in make_pool(exp, traffic, r.seed)]
    ref = Detector(exp["model"]).to(dev)
    weights = common.make_weights(ref, r.seed, dev, eval_stats=True, base_seed=traffic.get("weights_seed"),
                                  jitter=float(traffic.get("weights_jitter", 0.0)))
    model = build_model(exp["model"], device=dev)
    model.load_state_dict(weights, strict=True)
    predictor = AdaptivePredictor(model)
    predictor.warmup(batches[0]["points"], batches[0]["points_mask"])

    def predict(pts, mask):
        return host(predictor.predict(pts, mask))

    if program is not None:
        predict = program(predict)
    common.sync(dev)
    r.metrics["setup_s"] = time.perf_counter() - r.t0
    common.reset_peak(dev)

    n_pool, b = len(batches), int(traffic["batch"])
    outputs, latencies = [], []
    repairs0 = predictor.repaired

    neck_done = []

    def one(i):
        x = batches[i % n_pool]
        t = time.perf_counter()
        try:
            outputs.append(predict(x["points"], x["points_mask"]))
        except RuntimeError:
            outputs.append(None)
            r.failed += b
        latencies.append(time.perf_counter() - t)
        if neck_done:  # the host's time from the neck's (last) end to detections on the host
            r.extra.setdefault("after_neck_s", []).append(time.perf_counter() - neck_done[-1])
            neck_done.clear()

    if r.trace:
        flops = {}

        def work(i):  # the reference's FLOPs of the pool's batch i
            if i % n_pool not in flops:
                x = batches[i % n_pool]
                flops[i % n_pool] = counts.forward_flops(ref, x["points"], x["points_mask"])
            return flops[i % n_pool]

        k = int(traffic["host_batches"])
        hook = model.neck.register_forward_hook(lambda *a: neck_done.append(time.perf_counter()))
        t0 = time.perf_counter()
        for i in range(k):
            one(i)
        r.extra["host_s"] = time.perf_counter() - t0
        hook.remove()
        r.extra["host_batches"] = k
        spans = common.Spans({"backbone": model.backbone, "head": model.head})
        n = int(traffic["trace_batches"])
        with Recorder() as rec:
            r.profile = trace.profiled(lambda i: one(k + i), n, dev)
        spans.remove()
        r.launches = rec
        r.extra["batches"] = n
    else:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < r.seconds:
            one(len(outputs))
        elapsed = time.perf_counter() - t0
        done = sum(len(o) for o in outputs if o is not None)
        r.metrics["eval_frames_per_s"] = done / elapsed
        r.metrics["eval_batch_ms_p95"] = float(np.percentile(np.array(latencies) * 1e3, 95))
    r.repairs = predictor.repaired - repairs0
    r.attempted = b * len(outputs)
    r.memory_peak = common.peak(dev)
    del model, predictor, predict
    common.empty_cache(dev)
    if r.trace:  # the count runs the reference's reader on the card: after the peak is read
        r.extra["host_flops"] = sum(work(i) for i in range(k))
        r.flops = sum(work(k + i) for i in range(n))

    rng = np.random.default_rng(r.seed % 2**64)
    picks = sorted(rng.choice(len(outputs), min(int(traffic["check_batches"]), len(outputs)), replace=False))
    frames = []
    t = time.perf_counter()
    for i in picks:
        refs = reference_frames(ref, weights, batches[i % n_pool], exp)
        got = list(outputs[i] or [])[:len(refs)]
        # a frame the program answered with nothing, or not at all, is empty
        got += [{"boxes": np.zeros((0, 9)), "scores": np.zeros(0), "labels": np.zeros(0)}] * (len(refs) - len(got))
        frames += list(zip(got, refs))
    r.extra["reference_s"] = time.perf_counter() - t
    r.values = check.eval_values(frames)
    r.checks = check.rated(spec.cell["name"], r.values)
    r.frames = frames
    r.extra["check_batches"] = [int(i) for i in picks]


@torch.no_grad()
def reference_frames(ref: Detector, weights: dict, batch: dict, exp: dict, prec=None) -> list:
    """The reference's detections of one batch, per frame."""
    ref.load_state_dict(weights)
    ref.eval()
    with f32():
        preds = ref(batch["points"], batch["points_mask"], prec)
        return postprocess.predict(preds, exp["model"]["post_processing"], exp["model"]["head"])
