"""The port's CenterHead options vs the JAX package (CPU).

One random reference state_dict (the port's schema) is the head's weights
in every option: JAX gets it through its own importer,
``import_pillarnext(..., merge_tasks=, merge_branches=)``, the port loads
it as it is.  Held against JAX:

- ``fuse_eval`` true (the default of both) and false, f32 and bf16: the
  dense maps (f32 within 1e-4; bf16 within 8 bf16 ulps of the map's
  largest magnitude: the two CPU backends round bf16 conv sums
  differently, ~40% of elements are the same bits and the worst lie 2-4
  ulps apart), and
  in f32 the candidate-sparse detections, the same set as JAX's default
  head's (labels exactly, scores within 1e-5, boxes within 1e-4);
- ``merge_branches`` and ``merge_tasks`` in eval (maps within 1e-4 of
  JAX's merged heads' and 1e-5 of the port's unmerged head's, the same
  detections, both merges bypassing the candidate-sparse head as JAX's
  do) and in one train step: the loss within 1e-6 relative,
  every gradient within 1e-4 of its tensor's largest magnitude (at
  least 1e-6: a conv bias before a train-mode BatchNorm has an
  analytically zero gradient, f32 noise on both sides) and the
  updated BN statistics within 1e-6, JAX's gradient and statistic trees
  carried back through the port's ``state_dict_from_jax`` exporter;
- JAX's own merged trees (its random init, merged layout) load into the
  port with ``strict=True`` and give JAX's maps; JAX's imported trees
  carry back to the reference state_dict bit for bit.

The merged heads run at stride 2 (a deblock) and at stride 1, where
``merge_tasks`` tiles x across the task groups and JAX's merged tree has
no ``deblock``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pillarnext_tpu.models.centerhead import CenterHead as JaxCenterHead
from pillarnext_tpu.utils import torch_import as jax_import
from pillarnext_tpu_torch.models.centerhead import CenterHead
from pillarnext_tpu_torch.utils import torch_import as port_import
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.config import load_experiment
from pillarnext_tpu_torch.utils.weights import init_random
from tests.test_torch_port_e2e import FLAGSHIP, OVERRIDES

C = 16
TASKS = [["car"], ["truck", "bus"], ["ped", "cone", "barrier"]]
COMMON = {"reg": (2, 2), "height": (1, 2), "dim": (3, 2), "rot": (2, 2), "vel": (2, 2), "iou": (1, 2)}
PC = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
HEAD_KW = dict(
    in_channels=C, tasks=TASKS, weight=0.25, code_weights=[1.0] * 10, common_heads=COMMON,
    strides=[2, 2, 2], share_conv_channel=C, rectifier=[[0.5], [0.5, 0.3], [0.4, 0.4, 0.2]],
    voxel_size=[0.25, 0.25, 8.0], pc_range=PC, out_size_factor=[2, 2, 2],
)
TEST_CFG = {
    "post_center_limit_range": [-10.0, -10.0, -6.0, 10.0, 10.0, 4.0],
    "nms": {"nms_pre_max_size": 200, "nms_post_max_size": 20,
            "nms_iou_threshold": [[0.2], [0.2, 0.25], [0.2, 0.2, 0.2]]},
    "score_threshold": 0.1, "pc_range": PC, "voxel_size": [0.25, 0.25, 8.0],
    "out_size_factor": [2, 2, 2], "nms_type": "iou3d",
}
STRIDES = [2, 1]
OPTIONS = {"plain": {}, "merge_branches": {"merge_branches": True}, "merge_tasks": {"merge_tasks": True}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def head_kw(stride: int = 2) -> dict:
    return dict(HEAD_KW, strides=[stride] * len(TASKS))


def reference_state_dict(seed: int = 0, stride: int = 2) -> dict[str, np.ndarray]:
    """A random head in the reference schema (``head.``-prefixed keys):
    weights from the port's initialiser, random biases and BN."""
    head = CenterHead(**head_kw(stride))
    init_random(head, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in head.state_dict().items():
        a = v.numpy().astype(np.float32)
        if k.endswith(("running_var", ".weight")) and a.ndim == 1:
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif k.endswith(("running_mean", ".bias")):
            a = (a + rng.normal(0.0, 0.1, a.shape)).astype(np.float32)
        sd[f"head.{k}"] = a
    return sd


def _bn_keys(prefix, c=1):
    return {f"{prefix}.{n}": np.ones(c, np.float32) for n in ("weight", "bias", "running_mean", "running_var")}


def _without_deblock(tree: dict) -> dict:
    """A head tree with its tasks' deblocks (``ConvTransposeBlock_0``; the
    merged head's ``deblock``) taken out."""
    drop = ("deblock", "ConvTransposeBlock_0")
    return {k: ({kk: vv for kk, vv in v.items() if kk not in drop} if isinstance(v, dict) else v)
            for k, v in tree.items()}


def jax_variables(sd, **option) -> dict:
    """JAX's head variables from the reference state_dict through JAX's own
    importer (the rest of the detector as 1-channel stand-ins).  JAX's
    importer reads a deblock for every task; a stride-1 head has none, so
    its deblocks go in as stand-ins and come out of the imported tree."""
    full = dict(sd)
    stride1 = not any(".deblock." in k for k in sd)
    if stride1:
        for ti in range(len(TASKS)):
            full[f"head.tasks.{ti}.deblock.conv.weight"] = np.zeros((C, C, 2, 2), np.float32)
            full.update(_bn_keys(f"head.tasks.{ti}.deblock.norm", C))
    one = np.ones((1, 1, 1, 1), np.float32)
    full["backbone.mapping.0.weight"] = one
    full.update(_bn_keys("backbone.mapping.1"))
    for name in ("neck.pre_conv.block1", "neck.pre_conv.block2", "neck.post_conv"):
        full[f"{name}.conv.weight"] = one
        full.update(_bn_keys(f"{name}.norm"))
    full["neck.conv1x1.weight"] = one
    full["neck.weight"] = one
    params, stats = jax_import.import_pillarnext(
        full, num_filters=(), layer_nums=(), tasks=TASKS, common_heads=COMMON, **option)
    params, stats = params["head"], stats["head"]
    if stride1:
        params, stats = _without_deblock(params), _without_deblock(stats)
    return {"params": params, "batch_stats": stats}


def port_head(sd, stride: int = 2, **kwargs) -> CenterHead:
    head = CenterHead(**head_kw(stride), **kwargs)
    head.load_state_dict({k[len("head."):]: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return head


def port_state_dict_from(params, stats) -> dict[str, np.ndarray]:
    """JAX head trees -> reference-schema arrays through the port's exporter."""
    sd = {}
    port_import._export_neck_head(sd, {"head": params}, {"head": stats}, TASKS, COMMON)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _features(seed=3, b=2, h=12, w=12):
    return np.random.default_rng(seed).standard_normal((b, h, w, C)).astype(np.float32)


def assert_same_detections(got, want):
    assert int(want["valid"].sum()) >= 8, "vacuous: too few detections"
    for i in range(want["valid"].shape[0]):
        gv, wv = got["valid"][i].astype(bool), want["valid"][i].astype(bool)
        assert gv.sum() == wv.sum(), f"sample {i}: {gv.sum()} vs {wv.sum()} detections"
        go = np.lexsort((-got["scores"][i][gv], got["label_preds"][i][gv]))
        wo = np.lexsort((-want["scores"][i][wv], want["label_preds"][i][wv]))
        np.testing.assert_array_equal(got["label_preds"][i][gv][go], want["label_preds"][i][wv][wo])
        np.testing.assert_allclose(got["scores"][i][gv][go], want["scores"][i][wv][wo], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got["box3d_lidar"][i][gv][go], want["box3d_lidar"][i][wv][wo],
                                   atol=1e-4, rtol=1e-5)


def _numpy(d):
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v) for k, v in d.items()}


CANDIDATE_SPARSE = dict(TEST_CFG, candidate_sparse_head=True)


@pytest.fixture(scope="module")
def jax_detections():
    """JAX's default head (``fuse_eval``, candidate-sparse) on the test
    features, f32, at a stride: every f32 head option computes its
    detections.  Each stride's are computed once."""
    cache = {}

    def detections(stride: int) -> dict:
        if stride not in cache:
            jhead = JaxCenterHead(**head_kw(stride))
            out = jax.jit(lambda v, a: jhead.apply(v, a, test_cfg=CANDIDATE_SPARSE))(
                jax_variables(reference_state_dict(stride=stride)), jnp.asarray(_features()))
            cache[stride] = _numpy(out)
        return cache[stride]

    return detections


def _ulp_bound(ref: np.ndarray) -> float:
    """Eight bf16 ulps of the map's largest magnitude."""
    return 8.0 * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fuse_eval", [True, False])
def test_fuse_eval_matches_jax(fuse_eval, dtype, jax_detections):
    sd = reference_state_dict()
    variables = jax_variables(sd)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    jhead = JaxCenterHead(**HEAD_KW, fuse_eval=fuse_eval, dtype=jdt)
    x = _features()
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    jx = jnp.asarray(x, jdt or jnp.float32)
    jmaps = jax.jit(lambda v, a: jhead.apply(v, a))(variables, jx)
    head = port_head(sd, fuse_eval=fuse_eval).eval()
    assert all(sep.fuse_eval == fuse_eval for sep in head.tasks)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    with torch.no_grad():
        maps = head(tx)
    for t, (jm, m) in enumerate(zip(jmaps, maps)):
        assert set(jm) == set(m)
        for name in jm:
            ref = np.asarray(jm[name], np.float32)
            atol = 1e-4 if dtype == "float32" else _ulp_bound(ref)
            np.testing.assert_allclose(m[name].float().numpy(), ref, atol=atol, rtol=0,
                                       err_msg=f"task {t} {name}")
    if dtype == "bfloat16":
        return
    with torch.no_grad():
        got = head(tx, test_cfg=CANDIDATE_SPARSE)
    assert_same_detections(_numpy(got), jax_detections(2))


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("option", ["merge_branches", "merge_tasks"])
def test_merged_heads_eval_match_jax(option, stride, jax_detections):
    sd = reference_state_dict(stride=stride)
    variables = jax_variables(sd, **OPTIONS[option])
    tree = variables["params"]
    assert ("merged" in tree) == (option == "merge_tasks")
    assert ("branch1" in tree.get("task_0", {})) == (option == "merge_branches")
    deblocks = tree["merged"] if option == "merge_tasks" else tree["task_0"]
    assert ({"deblock", "ConvTransposeBlock_0"} & set(deblocks) != set()) == (stride > 1)
    # JAX's imported tree carries back to the reference state_dict exactly
    back = port_state_dict_from(variables["params"], variables["batch_stats"])
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)

    jhead = JaxCenterHead(**head_kw(stride), **OPTIONS[option])
    apply = jax.jit(jhead.apply)
    x = _features()
    jmaps = apply(variables, jnp.asarray(x))
    head = port_head(sd, stride, **OPTIONS[option]).eval()
    assert head.merge_tasks == (option == "merge_tasks")
    with torch.no_grad():
        maps = head(torch.from_numpy(x))
        unmerged = port_head(sd, stride).eval()(torch.from_numpy(x))
    assert maps[0]["hm"].shape[1:3] == (12 * stride, 12 * stride)
    for t, (jm, m, u) in enumerate(zip(jmaps, maps, unmerged)):
        for name in jm:
            np.testing.assert_allclose(m[name].numpy(), np.asarray(jm[name]), atol=1e-4, rtol=0,
                                       err_msg=f"task {t} {name}")
            np.testing.assert_allclose(m[name].numpy(), u[name].numpy(), atol=1e-5, rtol=0)
    # both merges bypass the candidate-sparse head (dense maps, then
    # predict): the same detections as JAX's default head
    with torch.no_grad():
        got = head(torch.from_numpy(x), test_cfg=CANDIDATE_SPARSE)
    assert_same_detections(_numpy(got), jax_detections(stride))

    # JAX's own merged tree (its random init) loads strictly and gives its maps
    init = jax.tree.map(np.asarray, jax.jit(jhead.init)(jax.random.PRNGKey(1), jnp.asarray(x)))
    own = port_state_dict_from(init["params"], init["batch_stats"])
    head = port_head(own, stride, **OPTIONS[option]).eval()
    jmaps = apply(init, jnp.asarray(x))
    with torch.no_grad():
        maps = head(torch.from_numpy(x))
    for jm, m in zip(jmaps, maps):
        for name in jm:
            np.testing.assert_allclose(m[name].numpy(), np.asarray(jm[name]), atol=1e-4, rtol=0)


def _example(seed=5, b=2, hw=24, m=8):
    """Random CenterPoint targets at the head's (hw x hw) output."""
    rng = np.random.default_rng(seed)
    ex = {k: [] for k in ("hm", "ind", "mask", "cat", "anno_box", "gt_boxes")}
    for classes in TASKS:
        hm = rng.uniform(0.0, 0.3, (b, hw, hw, len(classes))).astype(np.float32)
        ind = rng.integers(0, hw * hw, (b, m)).astype(np.int32)
        cat = rng.integers(0, len(classes), (b, m)).astype(np.int32)
        for i in range(b):
            hm[i, ind[i] // hw, ind[i] % hw, cat[i]] = 1.0
        gt = rng.normal(0.0, 2.0, (b, m, 7)).astype(np.float32)
        gt[..., 3:6] = rng.uniform(0.5, 3.0, (b, m, 3))
        ex["hm"].append(hm)
        ex["ind"].append(ind)
        ex["mask"].append(np.arange(m)[None].repeat(b, 0) < 5)
        ex["cat"].append(cat)
        ex["anno_box"].append(rng.normal(0.0, 1.0, (b, m, 10)).astype(np.float32))
        ex["gt_boxes"].append(gt)
    return ex


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("option", ["plain", "merge_branches", "merge_tasks"])
def test_merged_heads_train_step_matches_jax(option, stride):
    sd = reference_state_dict(stride=stride)
    variables = jax_variables(sd, **OPTIONS[option])
    jhead = JaxCenterHead(**head_kw(stride), **OPTIONS[option])
    x = _features()
    ex = _example(hw=12 * stride)

    def jloss(params):
        outs, upd = jhead.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(x), train=True, mutable=["batch_stats"])
        total, _ = jhead.apply({"params": params}, jax.tree.map(jnp.asarray, ex), outs, method=jhead.loss)
        return total, upd["batch_stats"]

    (jl, jstats), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    want_grads = port_state_dict_from(jax.tree.map(np.asarray, jgrads), variables["batch_stats"])
    want_stats = port_state_dict_from(variables["params"], jax.tree.map(np.asarray, jstats))

    head = port_head(sd, stride, **OPTIONS[option]).train()
    loss, _ = head.loss({k: [torch.from_numpy(np.asarray(a)) for a in v] for k, v in ex.items()},
                        head(torch.from_numpy(x)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    for name, p in head.named_parameters():
        want = want_grads[f"head.{name}"]
        np.testing.assert_allclose(p.grad.numpy(), want, atol=max(1e-4 * np.abs(want).max(), 1e-6), rtol=0,
                                   err_msg=name)
    for name, buf in head.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), want_stats[f"head.{name}"], atol=1e-6, rtol=1e-6,
                                       err_msg=name)


def test_merge_options_build_from_the_config():
    """The flagship YAML with a merge override builds in the port (JAX's
    ``merge_tasks`` condition holds: equal strides, two-conv branches)."""
    for override, attr in (("+model.head.merge_tasks=true", "merge_tasks"),
                           ("+model.head.merge_branches=true", "merge_branches")):
        model = build_model(load_experiment(FLAGSHIP, OVERRIDES + [override])["model"], device="cpu")
        assert getattr(model.head, attr)
    model = build_model(load_experiment(FLAGSHIP, OVERRIDES + ["+model.head.fuse_eval=false"])["model"],
                        device="cpu")
    assert not any(sep.fuse_eval for sep in model.head.tasks)
