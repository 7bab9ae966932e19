"""The port's full-scale parity harness (``pillarnext_tpu_torch/tools``) on
the CPU, at small grids (+-8 m, 0.25 m pillars, narrow widths) with inputs
made from a seed with numpy:

- each mirror copy (``reference_mirror``, ``reference_mirror3d``,
  ``reference_mirror_mvf``) gives the bits of its original
  (tests/torch_mirror*.py) for the same state_dict and points;
- ``state_dict_to_reference`` after ``state_dict_from_reference`` gives a
  mirror's state_dict back bit for bit, for the flagship, voxel18 and MVF,
  in the mirror's layout and in a reference checkpoint's;
- the port's flagship tool in random-weight mode meets JAX's bar, and its
  detections match JAX's ``SingleStageDetector.predict`` under the same
  weights (JAX's ``import_pillarnext``) at box 1e-2 and score 1e-3;
- the port's ``compare_detections`` gives JAX's verdict
  (tools/flagship_parity.py) on crafted detection sets.
"""

from __future__ import annotations

import importlib.util
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mirror
import torch_mirror3d
import torch_mirror_mvf
from pillarnext_tpu.core import native_geometry as jax_geometry
from pillarnext_tpu.utils import builders as jax_builders
from pillarnext_tpu.utils import torch_import as jax_import
from pillarnext_tpu.utils.config import load_experiment as jax_load_experiment
from pillarnext_tpu_torch.tools import flagship_parity, mvf_parity, parity, voxel_parity
from pillarnext_tpu_torch.tools import reference_mirror
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.config import load_experiment
from pillarnext_tpu_torch.utils.torch_import import (sparse_kernel_names, state_dict_from_reference,
                                                     state_dict_to_reference)
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
PC = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
FLAGSHIP_OVERRIDES = [
    f"model.reader.pc_range={PC}", "model.reader.voxel_size=[0.25,0.25,8.0]",
    "model.reader.num_filters=[16,16]", "model.reader.pillar_capacity=4096",
    "model.backbone.ds_num_filters=[16,32,32,32]", "model.backbone.num_input_features=16",
    "+model.backbone.out_channels=32", "model.neck.in_channels=32", "model.head.in_channels=32",
]
VOXEL_OVERRIDES = [
    "model.reader.pc_range=[-8,-8,-2,8,8,4]", "model.reader.voxel_size=[0.25,0.25,0.15]",
    "model.reader.voxel_capacity=8192", "model.backbone.ds_num_filters=[8,12,16,16]",
    "+model.backbone.out_channels=16", "model.neck.in_channels=32", "model.head.in_channels=32",
]
MVF_OVERRIDES = [
    "model.reader.pc_range=[-8,-8,-10,8,8,10]", "model.reader.voxel_size=[0.25,0.25,20.0]",
    "model.reader.cylinder_size=[5.625,0.375,10.0]", "model.reader.cylinder_range=[-180,-3,0,180,3,10]",
    "model.reader.num_filters=[8,8]", "model.reader.ds_num_filters=[8,12,16,16]",
    "model.reader.out_channels=16", "model.reader.pillar_capacity=4096", "model.reader.cylinder_capacity=1024",
    "model.neck.in_channels=16", "model.head.in_channels=16",
]
FAMILIES = {
    "flagship": (flagship_parity, FLAGSHIP_OVERRIDES),
    "voxel18": (voxel_parity, VOXEL_OVERRIDES),
    "mvf": (mvf_parity, MVF_OVERRIDES),
}
GEOMETRY_WAIT_S = 180  # make's own limit is 120 s


def load_jax_geometry() -> None:
    """Load the JAX package's host geometry library, which the JAX mirrors'
    oracle NMS calls.  ``native_geometry`` builds it with ``make`` in place
    on first use and remembers a failed load for the rest of the process.
    The suite's worker processes start together, so another worker's
    compiler can still be writing the file when this one loads it.  Clear
    the remembered failure and load again until the writer has finished."""
    deadline = time.monotonic() + GEOMETRY_WAIT_S
    while True:
        jax_geometry._build_failed = False
        if jax_geometry._load() is not None:
            return
        if time.monotonic() > deadline:
            raise RuntimeError(f"{jax_geometry._LIB_PATH} did not build or load within {GEOMETRY_WAIT_S} s")
        time.sleep(0.5)


@pytest.fixture(scope="module", autouse=True)
def jax_geometry_library():
    load_jax_geometry()


def model_cfg(family: str) -> dict:
    tool, overrides = FAMILIES[family]
    return load_experiment(tool.CONFIG, [*overrides, *tool.EVAL])["model"]


def randomized(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter and BN statistic of ``module`` drawn from a seeded
    numpy generator (the sparse mirrors initialise their kernels to 0)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if t.dtype != torch.float32:
                continue
            if name.endswith("running_var"):
                a = rng.uniform(0.5, 2.0, t.shape)
            else:
                a = rng.normal(0.0, 0.3 if t.dim() < 2 else 1.0 / np.sqrt(t[0].numel()), t.shape)
            t.copy_(torch.from_numpy(a.astype(np.float32)))
    return module


def scene(family: str, n: int = 2500, seed: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """(1, N, 5) points and mask of a planted scene on the family's grid."""
    cfg = model_cfg(family)
    pts, _, _ = parity.planted_scene(cfg, n, seed)
    return pts[None], np.ones((1, len(pts)), bool)


def mirrors(family: str):
    """(original, copy) of the family's mirror at the narrow config, the
    copy holding the original's randomised state_dict."""
    cfg = model_cfg(family)
    tasks, common = parity.tasks_and_heads(cfg)
    if family == "flagship":
        rd, bb = cfg["reader"], cfg["backbone"]
        orig = torch_mirror.TModel(
            num_input_features=5, num_filters=tuple(rd["num_filters"]), voxel_size=rd["voxel_size"],
            pc_range=rd["pc_range"], bb_filters=tuple(bb["ds_num_filters"]), bb_strides=tuple(bb["ds_layer_strides"]),
            bb_layer_nums=tuple(bb["layer_nums"]), out_channels=32, tasks=tasks, common_heads=common,
            head_stride=2, subm=True)
    elif family == "voxel18":
        orig = torch_mirror3d.TVoxelModel(**_voxel_kw(cfg, tasks, common))
    else:
        orig = torch_mirror_mvf.TMVFModel(**_mvf_kw(cfg, tasks, common))
    copy = FAMILIES[family][0].build_mirror(cfg)
    randomized(orig, 1).eval()
    copy.load_state_dict(orig.state_dict(), strict=True)
    return orig, copy.eval()


def _voxel_kw(cfg, tasks, common):
    rd, bb = cfg["reader"], cfg["backbone"]
    return dict(num_input_features=5, voxel_size=rd["voxel_size"], pc_range=rd["pc_range"],
                bb_filters=tuple(bb["ds_num_filters"]), bb_strides=tuple(bb["ds_layer_strides"]),
                bb_layer_nums=tuple(bb["layer_nums"]), out_channels=bb["out_channels"], tasks=tasks,
                common_heads=common, head_stride=2)


def _mvf_kw(cfg, tasks, common):
    rd = cfg["reader"]
    return dict(in_channels=rd["in_channels"], voxel_size=rd["voxel_size"], pc_range=rd["pc_range"],
                cylinder_size=rd["cylinder_size"], cylinder_range=rd["cylinder_range"],
                num_filters=tuple(rd["num_filters"]), layer_nums=tuple(rd["layer_nums"]),
                ds_layer_strides=tuple(rd["ds_layer_strides"]), ds_num_filters=tuple(rd["ds_num_filters"]),
                out_channels=rd["out_channels"], tasks=tasks, common_heads=common, head_stride=2)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_mirror_copy_gives_the_originals_bits(family):
    orig, copy = mirrors(family)
    pts, mask = scene(family)
    if family == "flagship":
        a_in, b_in = torch_mirror.padded_to_ragged(pts, mask), reference_mirror.padded_to_ragged(pts, mask)
    else:
        a_in = b_in = pts[0][mask[0]]
    with torch.no_grad():
        a, b = orig(a_in), copy(b_in)
    assert len(a) == len(b) == len(model_cfg(family)["head"]["tasks"])
    for ta, tb in zip(a, b):
        assert ta.keys() == tb.keys()
        for name in ta:
            assert torch.equal(ta[name], tb[name]), name
    # the decode and the C++ oracle's NMS of each package, on the same maps
    cfg = model_cfg(family)
    maps = [{k: v.numpy() for k, v in t.items()} for t in a]
    num_classes = [len(t) for t in cfg["head"]["tasks"]]
    ref_a = torch_mirror.reference_predict(maps, parity.decode_cfg(cfg), cfg["head"]["rectifier"], num_classes)
    ref_b = reference_mirror.reference_predict(maps, parity.decode_cfg(cfg), cfg["head"]["rectifier"], num_classes)
    assert len(ref_a[0]["scores"]) > 0
    for key in ("box3d_lidar", "scores", "label_preds"):
        np.testing.assert_array_equal(ref_a[0][key], ref_b[0][key])


@pytest.mark.parametrize("checkpoint", [False, True], ids=["mirror-layout", "checkpoint-layout"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_weights_round_trip_bit_for_bit(family, checkpoint):
    """A mirror's state_dict -> the port (``state_dict_from_reference``) ->
    back (``state_dict_to_reference``): the mirror's bits under its keys;
    through a reference checkpoint's layout (``module.``, spconv's sparse
    kernels) and back into a second port model: the port's bits."""
    _, mirror = mirrors(family)
    sd = mirror.state_dict()
    model = build_model(model_cfg(family), device="cpu")
    model.load_state_dict(state_dict_from_reference(sd, model), strict=True)
    back = state_dict_to_reference(model.state_dict(), checkpoint=checkpoint)
    if not checkpoint:
        assert back.keys() == sd.keys()
        for k in sd:
            assert back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k]), k
        mirror.load_state_dict(back, strict=True)
        return
    assert all(k.startswith("module.") for k in back)
    # spconv's layout: the pillar backbone's blocks, every 3-D backbone conv; no MVF tower conv
    moved = {k.removeprefix("module.") for k, v in back.items() if v.shape != sd[k.removeprefix("module.")].shape}
    assert moved == sparse_kernel_names(model.state_dict()) and bool(moved) == (family != "mvf")
    assert all(k.startswith("backbone.blocks.") or family == "voxel18" for k in moved)
    again = build_model(model_cfg(family), device="cpu")
    again.load_state_dict(state_dict_from_reference(back, again), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_flagship_tool_meets_jax_bar_and_matches_jax_predict():
    """The port's flagship tool (random weights, ``device="cpu"``) passes
    JAX's random-weight bar against the mirror; its detections equal JAX's
    predict of the mirror's weights."""
    rec = flagship_parity.run(points=3000, seed=0, device="cpu", overrides=FLAGSHIP_OVERRIDES, log=lambda s: None)
    assert rec["mode"] == "random" and rec["ours"] >= 8
    assert rec["same_label"] >= parity.RANDOM_MIN_MATCHED
    assert rec["max_box_delta"] < parity.RANDOM_BOX_TOL and rec["max_score_delta"] < parity.RANDOM_SCORE_TOL
    assert rec["served_vs_unbucketed"]["bit_identical"] and rec["forced_repairs"] == 1
    ours = rec["detections"]["port"]

    # the same mirror weights and frame through JAX
    cfg = model_cfg("flagship")
    torch.manual_seed(0)
    mirror = flagship_parity.build_mirror(cfg)
    reference_mirror.randomize_bn_stats(mirror, np.random.default_rng(1))
    tasks, common = parity.tasks_and_heads(cfg)
    params, stats = jax_import.import_pillarnext(
        {k: v.numpy() for k, v in mirror.state_dict().items()}, num_filters=(16, 16), layer_nums=(2, 2, 2, 2),
        ds_num_filters=(16, 32, 32, 32), num_input_features=16, out_channels=32, tasks=tasks, common_heads=common)
    jcfg = jax_load_experiment(flagship_parity.CONFIG, [*FLAGSHIP_OVERRIDES, *flagship_parity.EVAL])["model"]
    jmodel = jax_builders.build_model(jcfg)
    from pillarnext_tpu_torch.utils.synth import lidar_like_points

    pts, mask = lidar_like_points(1, 3000, PC, seed=2)
    out = jax.jit(lambda v, p, m: jmodel.apply(v, {"points": p, "points_mask": m}, method=jmodel.predict))(
        {"params": params, "batch_stats": stats}, jnp.asarray(pts), jnp.asarray(mask))
    valid = np.asarray(out["valid"][0]).astype(bool)
    ref = {"box3d_lidar": np.asarray(out["box3d_lidar"][0])[valid], "scores": np.asarray(out["scores"][0])[valid],
           "label_preds": np.asarray(out["label_preds"][0])[valid].astype(np.int64)}
    got = parity.compare_detections(ref, ours, parity.decode_cfg(cfg), overfit=True, family="JAX-FLAGSHIP",
                                    box_tol=1e-2, score_tol=1e-3, log=lambda s: None)
    assert got["ref"] == got["ours"] == rec["ours"]


def _jax_compare():
    spec = importlib.util.spec_from_file_location("jax_flagship_parity", REPO / "tools" / "flagship_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.compare_detections


def _dets(n: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    boxes = np.zeros((n, 9), np.float32)
    boxes[:, 0] = np.arange(n) * 3.0 - 20.0  # centres 3 m apart
    boxes[:, 1] = rng.uniform(-20, 20, n)
    boxes[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    boxes[:, 8] = rng.uniform(-np.pi, np.pi, n)
    return {"box3d_lidar": boxes, "scores": rng.uniform(0.32, 0.9, n).astype(np.float32),
            "label_preds": rng.integers(0, 10, n).astype(np.int64)}


def _nudged(d: dict, box: float, score: float) -> dict:
    return {"box3d_lidar": d["box3d_lidar"] + box, "scores": d["scores"] + score, "label_preds": d["label_preds"]}


CASES = {
    # name: (ref, ours, overfit)
    "count-mismatch": (_dets(12), _dets(11), False),
    "vacuous-0==0-trained": (_dets(0), _dets(0), True),
    "trained-pass": (_dets(12), _nudged(_dets(12), 1e-3, 1e-4), True),
    "random-pass": (_dets(20), _nudged(_dets(20), 0.05, 1e-3), False),
    "trained-score-miss": (_dets(12), _nudged(_dets(12), 1e-3, 2e-3), True),
    "trained-label-flip": (_dets(12), {**_dets(12), "label_preds": (_dets(12)["label_preds"] + 1) % 10}, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_compare_detections_gives_jax_verdict(case, capsys):
    ref, ours, overfit = CASES[case]
    test_cfg = {"score_threshold": 0.1}
    verdicts = []
    for compare in (_jax_compare(), parity.compare_detections):
        try:
            compare(ref, ours, test_cfg, overfit=overfit)
            verdicts.append("pass")
        except (AssertionError, ValueError, ZeroDivisionError):
            verdicts.append("fail")
    assert verdicts[0] == verdicts[1], (case, verdicts)
    assert verdicts[1] == ("pass" if case.endswith("pass") else "fail")
