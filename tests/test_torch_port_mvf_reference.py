"""The benchmark's plain MVF reference (benchmark/reference/mvf.py) against
the port, on the CPU.

The MVF YAML narrowed as tests/test_torch_port_mvf.py narrows it (+-8 m at
0.25 m pillars, a 64 x 16 cylinder grid, the four tower stages and their
strides, narrow widths), B = 2 frames of the benchmark's own traffic
(``modes/train_mvf.make_pool``, a few thousand points a frame), one set of
weights from ``common.make_weights`` loaded strictly into both:

- the eval head maps and the train-mode loss and first-step gradients of
  every leaf, the port in float32 and in bfloat16 against the float32
  reference, each tolerance with its reason;
- a readback with its corners swapped, and the cylinder readback dropped,
  in the reference: the float32 comparison fails;
- the benchmark's configuration file is the YAML as loaded, at the
  published widths and capacities;
- ``counts_mvf.py`` against a hand count of a one-stage tower;
- the cell's mode at this size: correct by the cell's limits, and not
  correct with half the batch left out, nor the float8 reference.
"""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from benchmark import check, common, control_mvf, counts_mvf
from benchmark.control import half_batch
from benchmark.modes import train_mvf
from benchmark.reference import mvf
from benchmark.spec import ROOT, Spec
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.config import load_experiment
from tests.test_torch_port_mvf import MVF, OVERRIDES
from tests.torch_threads import one_torch_thread  # noqa: F401

TRAFFIC = {"batch": 2, "points_per_frame": 3000, "max_points": 4000, "objects": [3, 5],
           "points_per_surface": 10, "pool_batches": 3, "trace_steps": 1}
SEED = 0
# float32 on both sides: the same sums in other orders (four conv stages,
# the scatter means, the BatchNorm's one-pass variance in the port);
# measured at most 1e-6 of the largest map entry on seeds 0-2
F32_MAPS = 1e-5
# the loss: measured 6e-7-1.4e-6 relative on seeds 0-2
F32_LOSS = 1e-5
# a leaf's gradient, the norm of its difference over the larger of its
# norm and the median leaf's: 1.2e-5 on seed 0; two float32 runs can put
# a ReLU input on the two sides of 0, which moves every gradient below
# it (4.6e-4 on seed 1)
F32_GRAD = 1e-3
# bfloat16 activations against float32: a map entry's rounding of 2^-8
# grows over the towers and the head to 1.3-3.1% of the largest entry,
# and the loss by 0.1-1.9% (seeds 0-2)
BF16_MAPS = 0.1
BF16_LOSS = 0.05


def experiment(dtype: str = "float32") -> dict:
    return load_experiment(MVF, [*OVERRIDES, f"model.dtype={dtype}"])


def batch_of(exp: dict, seed: int = SEED) -> dict:
    return common.to_device(train_mvf.make_pool(exp, dict(TRAFFIC, pool_batches=1), seed)[0], "cpu")


def maps_gap(port: list, ref: list) -> float:
    """The largest |port - reference| over the largest |reference| of a map."""
    worst = 0.0
    for p, r in zip(port, ref):
        assert p.keys() == r.keys()
        for k in r:
            worst = max(worst, float((p[k].float() - r[k]).abs().max() / r[k].abs().max()))
    return worst


def eval_pair(dtype: str):
    exp = experiment(dtype)
    ref = mvf.MVFDetector(exp["model"])
    weights = common.make_weights(ref, SEED, "cpu", eval_stats=True)
    ref.load_state_dict(weights)
    port = build_model(exp["model"], device="cpu")
    port.load_state_dict(weights, strict=True)
    return exp, ref.eval(), port


def nchw(maps: list) -> list:
    return [{k: v.permute(0, 3, 1, 2) for k, v in m.items()} for m in maps]


@pytest.mark.parametrize("dtype, tol", [("float32", F32_MAPS), ("bfloat16", BF16_MAPS)])
def test_eval_head_maps_follow_the_reference(dtype, tol):
    exp, ref, port = eval_pair(dtype)
    b = batch_of(exp)
    with torch.no_grad():
        gap = maps_gap(nchw(port(b["points"], b["points_mask"])), ref(b["points"], b["points_mask"]))
    assert gap < tol, gap


BILINEAR = mvf.bilinear


def swapped_corners(x, bi, u, v):
    """The readback with its columns' corner weights exchanged."""
    return BILINEAR(x, bi, torch.floor(u) + 1 - (u - torch.floor(u)), v)


@pytest.mark.parametrize("fault", ["corners_swapped", "cylinder_dropped"])
def test_a_broken_readback_fails_the_comparison(fault, monkeypatch):
    exp, ref, port = eval_pair("float32")
    b = batch_of(exp)
    if fault == "corners_swapped":
        monkeypatch.setattr(mvf, "bilinear", swapped_corners)
    else:
        view = ref.reader.cylinder_view
        monkeypatch.setattr(view, "forward", lambda *a, _f=view.forward: torch.zeros_like(_f(*a)))
    with torch.no_grad():
        gap = maps_gap(nchw(port(b["points"], b["points_mask"])), ref(b["points"], b["points_mask"]))
    assert gap > 100 * F32_MAPS, gap


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loss_and_gradients_follow_the_reference(dtype):
    exp = experiment(dtype)
    b = batch_of(exp)
    ref = mvf.MVFDetector(exp["model"])
    weights = common.make_weights(ref, SEED, "cpu", eval_stats=False)
    ref.load_state_dict(weights)
    ref.train()
    port = build_model(exp["model"], device="cpu", train=True)
    port.load_state_dict(weights, strict=True)
    ref_loss = mvf.loss(ref(b["points"], b["points_mask"]), b, exp["model"]["head"])
    ref_loss.backward()
    port_loss, _ = port.loss(b)
    port_loss.backward()
    gap = abs(port_loss.item() - ref_loss.item()) / abs(ref_loss.item())
    assert gap < (F32_LOSS if dtype == "float32" else BF16_LOSS), gap
    if dtype != "float32":
        return  # the worst leaf's bfloat16 gradient is rounding noise (PERF.md section 2)
    rp, pp = dict(ref.named_parameters()), dict(port.named_parameters())
    assert rp.keys() == pp.keys()
    norms = {n: float(rp[n].grad.norm()) for n in rp}
    med = float(np.median(list(norms.values())))
    gaps = {n: float((pp[n].grad - rp[n].grad).norm()) / max(norms[n], med) for n in rp}
    assert max(gaps.values()) < F32_GRAD, max(gaps.items(), key=lambda kv: kv[1])


def test_the_configuration_file_is_the_yaml_as_loaded():
    spec = Spec("mvf-train-b3")
    conf = spec.config
    yaml = load_experiment(MVF)
    assert conf["reduced"] == ["num_gpus"] and all(k not in yaml for k in (*conf["reduced"], *conf["assumed"]))
    assert conf["experiment"] == json.loads(json.dumps(yaml))
    rd, post = conf["experiment"]["model"]["reader"], conf["experiment"]["model"]["post_processing"]
    assert (rd["pillar_capacity"], rd["cylinder_capacity"]) == (86016, 49152)
    assert (post["max_per_img"], post["nms"]["nms_pre_max_size"]) == (4096, 4096)
    assert rd["ds_num_filters"] == [48, 96, 192, 192] and rd["out_channels"] == 256
    assert (conf["published_num_gpus"], conf["train_batch_per_gpu"], conf["num_gpus"]) == (32, 3, 1)
    assert spec.traffic["batch"] == conf["train_batch_per_gpu"] and spec.traffic["mode"] == "train_mvf"
    # the schedule of the published Waymo recipe (docs/RUN.md:37-38), peak and length from one line:
    # max_lr 0.006 over 36 epochs of 158,081 frames, half dropped, at a global batch of 96
    assert conf["max_lr"] == 0.006 and conf["schedule_steps"] == round(158081 * 0.5 / 96 * 36)
    assert train_mvf.schedule(conf["experiment"], conf)["max_lr"] == conf["max_lr"]


def test_counts_match_a_hand_count():
    """One stage (a stride-2 ConvBlock 6 -> 4 and one residual block), k =
    3, over a 16 x 16 pillar grid and an 8 x 4 cylinder grid, B = 2."""
    cfg = copy.deepcopy(experiment()["model"])
    cfg["reader"].update(pc_range=[-2.0, -2.0, -1.0, 2.0, 2.0, 1.0], voxel_size=[0.25, 0.25, 2.0],
                         cylinder_range=[-180.0, -1.0, 0.0, 180.0, 1.0, 10.0], cylinder_size=[45.0, 0.5, 10.0],
                         num_filters=[6, 6], layer_nums=[1], ds_layer_strides=[2], ds_num_filters=[4],
                         kernel_size=[3], out_channels=8)
    det = mvf.MVFDetector(cfg)
    assert det.reader.pillar_grid == (16, 16) and det.reader.cylinder_grid == (4, 8)
    # per frame: 8 x 8 and 2 x 4 output cells; 9 taps; 6 x 4, 4 x 4, 4 x 4 channel pairs
    pillar, cyl = 2 * 64 * 9 * (24 + 16 + 16), 2 * 8 * 9 * (24 + 16 + 16)
    assert counts_mvf.tower_flops(det, 2) == 2 * (pillar + cyl)
    # each conv's input and output maps of two frames and its weight, 2 bytes an element
    maps = 2 * ((256 * 6 + 64 * 4) + 2 * (64 * 4 + 64 * 4)) + 2 * ((32 * 6 + 8 * 4) + 2 * (8 * 4 + 8 * 4))
    weights = 2 * 9 * (24 + 16 + 16)
    assert counts_mvf.tower_bytes(det, 2, 2) == 2 * (maps + weights)
    # two PFN layers a view (20 -> 3, 6 -> 6) and the PointNets (20 -> 4, 12 -> 8), at 100 points
    assert counts_mvf.point_flops(det, 100) == 2 * 100 * (2 * (20 * 3 + 6 * 6) + 20 * 4 + 12 * 8)


def tiny_spec() -> Spec:
    s = Spec("mvf-train-b3", ROOT)
    s.config = dict(s.config, experiment=experiment())
    s.traffic = dict(s.traffic, **TRAFFIC)
    return s


@pytest.mark.parametrize("fault", [None, "half_batch"])
def test_the_cell_at_a_tiny_size(fault):
    """The sound step is correct by the cell's limits, with no failed step
    and the occupancy of each checked step kept; half the batch left out
    is not."""
    r = common.Run(tiny_spec(), 2**31 + 21, 0.3, False, torch.device("cpu"), 0.0)
    train_mvf.run(r, program=half_batch if fault else None)
    assert r.attempted > 0 and r.failed == 0
    assert {n for n, _, lim in r.checks if lim is not None} == set(check.limits("mvf-train-b3"))
    if fault:
        assert not check.correct(r.checks), r.checks
        return
    assert r.values["first_loss_gap"] < F32_LOSS and r.values["grad_gap"] < F32_GRAD, r.values
    assert r.values["grad_gap_mean"] <= r.values["grad_gap"], r.values
    assert check.correct(r.checks), r.checks
    assert len(r.extra["occupancy"]["pillar"]) == 3 and min(r.extra["occupancy"]["cylinder"]) > 0


def test_the_float8_reference_fails_the_cells_limits():
    """The control that the limits are set against: the reference with
    every stored tensor and gradient in float8, judged against the float32
    reference, is not correct."""
    values, _ = control_mvf.control_values(tiny_spec(), 2**31 + 21, torch.device("cpu"), "float8")
    assert not check.correct(check.rated("mvf-train-b3", values)), values


REFERENCE_SCRIPT = r"""
import json, sys
import torch
from benchmark.reference import mvf
from benchmark.spec import Spec

exp = Spec("mvf-train-b3").config["experiment"]
cfg = json.loads(json.dumps(exp["model"]))
cfg["reader"].update(pc_range=[-4.0, -4.0, -10.0, 4.0, 4.0, 10.0], voxel_size=[0.25, 0.25, 20.0],
                     cylinder_size=[11.25, 0.625, 107.0], ds_num_filters=[8, 8, 8, 8], num_filters=[8, 8],
                     out_channels=8)
det = mvf.MVFDetector(cfg)
pts = torch.rand(1, 500, 5) * 6 - 3
maps = det(pts, torch.ones(1, 500, dtype=torch.bool))
print(json.dumps({"finite": all(bool(torch.isfinite(v).all()) for m in maps for v in m.values()),
                  "loaded": sorted(m for m in sys.modules
                                   if m.split(".")[0].startswith(("jax", "flax", "pillarnext_tpu")))}))
"""


def test_the_reference_imports_neither_jax_nor_the_program():
    """In a fresh interpreter: the reference builds and runs a narrowed MVF
    detector and loads no ``jax*``, ``flax*``, ``pillarnext_tpu*`` (the JAX
    package or the port) module."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", REFERENCE_SCRIPT], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"finite": True, "loaded": []}, out
