"""The port's MVF reader (waymo_det_mvf18_aspp_iou_car) vs the JAX package, on the CPU.

Same seeded numpy inputs through JAX and the port, JAX weights carried
across by the port's ``export_mvfnext``:

- the two views' coordinates on 200,000-point frames at the config's grids
  (2048^2 pillars, 100 x 2560 cylinder cells).  The port divides by the
  true quotient (ops/voxelize.divide); XLA rewrites JAX's divisions by a
  constant (``/ voxel_size``, ``/ pi``, ``/ cylinder_size``) into products
  with the reciprocal, which can differ in the last bit.  ``atan2`` itself
  gives the same bits in both.  So a point within an ulp of a cell
  boundary can land in the neighbour cell: on seeds 0-2 that is 18 pillar
  cells and 20 cylinder cells of 600,000 points, each within 4 ulps of a
  boundary on both sides, which the test requires;
- ``_bilinear`` (f32 and bf16 images, points outside the image);
- one ``SingleView`` with sorted ids (the pillar view) and unsorted ids
  (the cylinder view, which the port runs in cylinder order);
- the whole ``MVFFeatureNet`` BEV in f32, within atol 1e-4 + rtol 1e-5
  (f32 convolutions over four stages summed in other orders; measured
  ~1e-5 at a largest magnitude of ~25);
- the detector from the real YAML, narrowed (+-8 m at 0.25 m pillars, a
  64 x 16 cylinder grid, the config's four stages and strides so that
  ds = 8, narrow widths, f32), through ``build_model`` +
  ``AdaptivePredictor`` against JAX ``predict``: the same detection set
  at the bars of tests/test_torch_port_e2e.py (scores 2e-3 / 1e-3, boxes
  2e-2 / 1e-3), tighter than tools/mvf_parity.py's 5e-2 / 5e-3;
- a pillar overflow repaired at the largest bucket and a cylinder
  overflow raised, as the JAX serving does.

The detector's BN statistics are set from the frames, as training would
set them (``calibrated``): MVF's raw features hold phi in degrees and rho
in metres, and with random statistics the head regresses box sizes from
1e-17 to 1e6 m, where both packages' rotated IoU is ill-conditioned (JAX's
gives ~3e10 for such a box with itself), so the NMS of either would be
noise.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pillarnext_tpu import serving as jax_serving
from pillarnext_tpu.models.mvf_encoder import SingleView as JaxSingleView
from pillarnext_tpu.models.mvf_encoder import _bilinear as jax_bilinear
from pillarnext_tpu.utils import builders as jax_builders
from pillarnext_tpu.utils.config import load_experiment
from pillarnext_tpu.utils.synth import lidar_like_points
from pillarnext_tpu_torch.models.mvf_encoder import SingleView, _bilinear
from pillarnext_tpu_torch.ops.compact import compactify
from pillarnext_tpu_torch.ops.voxelize import ViewCoords, VoxelGrid, mvf_view_coords
from pillarnext_tpu_torch.serving import AdaptivePredictor
from pillarnext_tpu_torch.utils.builders import build_model
from pillarnext_tpu_torch.utils.torch_import import export_mvf_view
from pillarnext_tpu_torch.utils.weights import load_jax_variables
from test_torch_port_e2e import randomized_variables


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread here: the suite runs several test processes on
    the machine's cores, and each torch pool of all cores in each of them
    oversubscribes the host many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MVF = (
    Path(__file__).resolve().parent.parent
    / "pillarnext_tpu/configs/experiments/waymo_det_mvf18_aspp_iou_car.yaml"
)
PC = [-8.0, -8.0, -10.0, 8.0, 8.0, 10.0]
OVERRIDES = [
    f"model.reader.pc_range={PC}",
    "model.reader.voxel_size=[0.25,0.25,20.0]",  # 64 x 64 pillars
    "model.reader.cylinder_size=[5.625,0.375,10.0]",
    "model.reader.cylinder_range=[-180.0,-3.0,0.0,180.0,3.0,10.0]",  # 64 x 16 cells
    "model.reader.num_filters=[8,8]",
    "model.reader.ds_num_filters=[8,12,16,16]",
    "model.reader.out_channels=16",
    "model.reader.pillar_capacity=4096",
    "model.reader.cylinder_capacity=1024",
    "model.neck.in_channels=16",
    "model.head.in_channels=16",
    "+model.head.share_conv_channel=16",
    "model.dtype=float32",
]


def small_mvf_cfg(*extra):
    return load_experiment(MVF, [*OVERRIDES, *extra])["model"]


def calibrated(jmodel, variables, pts, mask):
    """``variables`` with every BN's running statistics replaced by the
    statistics of this batch, as training sets them.  A train-mode forward
    moves each running value by ``(1 - m) * (batch - running)``; two
    forwards from known values give both ``m`` and the batch statistic."""
    step = jax.jit(lambda v, p, m: jmodel.apply(v, p, m, True, mutable=["batch_stats"])[1]["batch_stats"])
    p, m = jnp.asarray(pts), jnp.asarray(mask)
    old = variables["batch_stats"]
    new1 = step(variables, p, m)
    new2 = step({"params": variables["params"], "batch_stats": new1}, p, m)

    def solve(o, n1, n2):
        o, n1, n2 = (np.asarray(x, np.float64) for x in (o, n1, n2))
        mom = np.median((n2 - n1) / np.where(n1 == o, 1.0, n1 - o))
        return ((n1 - mom * o) / (1.0 - mom)).astype(np.float32)

    return {"params": variables["params"], "batch_stats": jax.tree.map(solve, old, new1, new2)}


@pytest.fixture(scope="module")
def mvf():
    cfg = small_mvf_cfg()
    pts, mask = lidar_like_points(2, 3000, PC, seed=0)
    jmodel = jax_builders.build_model(cfg)
    variables = randomized_variables(
        jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(pts[:1]), jnp.asarray(mask[:1]))
    )
    variables = calibrated(jmodel, variables, pts, mask)
    model = load_jax_variables(build_model(cfg, device="cpu"), variables)
    return cfg, pts, mask, jmodel, variables, model


# ---------------------------------------------------------------- views

WAYMO_PC = np.asarray([-76.8, -76.8, -10.0, 76.8, 76.8, 10.0], np.float64)
WAYMO_VS = [0.075, 0.075, 20.0]
WAYMO_CR = np.asarray([-180.0, -10.0, 0.0, 180.0, 10.0, 107.0], np.float64)
WAYMO_CS = [0.140625, 0.2, 107.0]


@jax.jit
def _jax_views(pts, mask):
    """The JAX reader's view coordinates, written as mvf_encoder.py:201-243
    writes them: (valid, pillar cells, pillar fractions, phi, rho,
    cylinder cells, cylinder fractions)."""
    pc, cyl = WAYMO_PC, WAYMO_CR
    valid = mask
    for axis in range(3):
        valid = valid & (pts[:, axis] >= pc[axis]) & (pts[:, axis] < pc[axis + 3])
    fp = jnp.stack([(pts[:, 0] - pc[0]) / WAYMO_VS[0], (pts[:, 1] - pc[1]) / WAYMO_VS[1]], -1)
    up = jnp.clip(jnp.floor((pts[:, 0] - pc[0]) / WAYMO_VS[0]).astype(jnp.int32), 0, 2047)
    vp = jnp.clip(jnp.floor((pts[:, 1] - pc[1]) / WAYMO_VS[1]).astype(jnp.int32), 0, 2047)
    phi = jnp.arctan2(pts[:, 1], pts[:, 0]) / np.pi * 180.0
    rho = jnp.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2)
    fc = jnp.stack([(phi - cyl[0]) / WAYMO_CS[0], (pts[:, 2] - cyl[1]) / WAYMO_CS[1]], -1)
    uc = jnp.clip(jnp.floor((phi - cyl[0]) / WAYMO_CS[0]).astype(jnp.int32), 0, 2559)
    vc = jnp.clip(jnp.floor((pts[:, 2] - cyl[1]) / WAYMO_CS[1]).astype(jnp.int32), 0, 99)
    return valid, jnp.stack([up, vp], -1), fp, phi, rho, jnp.stack([uc, vc], -1), fc


def _near_boundary(f: np.ndarray, ulps: int = 4) -> np.ndarray:
    return np.abs(f - np.round(f)) <= ulps * np.spacing(np.abs(f).astype(np.float32))


def test_view_coords_match_jax():
    pillar = VoxelGrid.create(WAYMO_VS, WAYMO_PC.tolist())
    cylinder = VoxelGrid.create(WAYMO_CS, WAYMO_CR.tolist())
    assert (pillar.size_x, pillar.size_y, cylinder.size_x, cylinder.size_y) == (2048, 2048, 2560, 100)
    mismatched = {"pillar": 0, "cylinder": 0}
    for seed in range(3):
        pts, mask = lidar_like_points(1, 200_000, WAYMO_PC.tolist(), seed=seed)
        pts[0, :50, :2] = WAYMO_PC[3] + 1.0  # outside in x and y
        pts[0, 50:100, 2] = WAYMO_PC[5]  # on the upper z edge: outside
        mask[0, 100:150] = False
        j_valid, j_pc, j_pf, j_phi, j_rho, j_cc, j_cf = (
            np.asarray(a) for a in _jax_views(jnp.asarray(pts[0]), jnp.asarray(mask[0])))
        valid, pv, cv, cyl_pos = mvf_view_coords(
            pillar, cylinder, torch.from_numpy(pts[0, :, :3]), torch.from_numpy(mask[0]))
        np.testing.assert_array_equal(valid.numpy(), j_valid)
        assert not valid[:150].any()
        np.testing.assert_allclose(cyl_pos[:, 0].numpy(), j_phi, rtol=0, atol=2e-5)  # degrees
        np.testing.assert_allclose(cyl_pos[:, 1].numpy(), pts[0, :, 2], rtol=0, atol=0)
        np.testing.assert_allclose(cyl_pos[:, 2].numpy(), j_rho, rtol=2e-7, atol=0)
        for view, got, jc, jf in (("pillar", pv, j_pc, j_pf), ("cylinder", cv, j_cc, j_cf)):
            gf = torch.stack([got.fu, got.fv], -1).numpy()
            np.testing.assert_allclose(gf, jf, rtol=2e-7, atol=2e-4)
            gc = torch.stack([got.u, got.v], -1).numpy()
            bad = gc != jc
            # each differing cell: both quotients within 4 ulps of the boundary
            assert _near_boundary(gf[bad]).all() and _near_boundary(jf[bad]).all(), (view, gf[bad], jf[bad])
            assert (np.abs(gc[bad] - jc[bad]) == 1).all()
            mismatched[view] += int(bad.any(-1).sum())
    # the counts the module docstring states
    assert mismatched == {"pillar": 18, "cylinder": 20}, mismatched


# ---------------------------------------------------------------- bilinear

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilinear_matches_jax(dtype):
    rng = np.random.default_rng(0)
    image = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    n = 400
    u = rng.uniform(-1.5, 8.5, n).astype(np.float32)
    v = rng.uniform(-1.5, 6.5, n).astype(np.float32)
    u[:4] = [0.0, 6.0, 3.0, 7.0]  # cell edges and the last column
    batch = rng.integers(0, 2, n).astype(np.int32)
    want = np.asarray(jax_bilinear(jnp.asarray(image).astype(dtype), jnp.asarray(batch),
                                   jnp.asarray(u), jnp.asarray(v)))
    got = _bilinear(torch.from_numpy(image).to(getattr(torch, dtype)), torch.from_numpy(batch),
                    torch.from_numpy(u), torch.from_numpy(v))
    assert got.dtype == torch.float32 and want.dtype == np.float32  # f32 weights promote
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- one view

VIEW = dict(num_filters=(8, 8), layer_nums=(1, 2), ds_layer_strides=(1, 2),
            ds_num_filters=(8, 12), kernel_size=(3, 3))


@pytest.mark.parametrize("sorted_ids", [True, False], ids=["pillar_order", "cylinder_order"])
def test_single_view_matches_jax(sorted_ids):
    """A view over a 16 x 24 grid of 2000 points (some masked), its table
    large enough for every cell (an overflowed frame is recomputed).  With
    unsorted ids JAX runs the view over the points in their given order;
    the port runs its PFN over them sorted by cell (compactify's stable
    order), and reads back in the given order."""
    rng = np.random.default_rng(1)
    n, (h, w), cap = 2000, (16, 24), 400
    feats = rng.standard_normal((n, 20)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    cell = np.where(valid, rng.integers(0, h * w // 2, n) * 2 + rng.integers(0, 2, n), h * w).astype(np.int32)
    pos = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n), np.zeros(n)], -1).astype(np.float32)
    order, slot_s, slot_id, _ = compactify(torch.from_numpy(cell), h * w, cap)
    if sorted_ids:  # the points arrive sorted by cell, as in the pillar view
        o = order.numpy()
        feats, valid, cell, pos = feats[o], valid[o], cell[o], pos[o]
        order = torch.arange(n)
        slot_j = slot_s
    else:
        slot_j = torch.empty_like(slot_s).scatter_(0, order, slot_s)
    feats = np.where(valid[:, None], feats, 0.0).astype(np.float32)

    jview = JaxSingleView(**VIEW, sorted_ids=sorted_ids)
    args = (jnp.asarray(feats), jnp.asarray(valid), jnp.asarray(slot_j.numpy()),
            jnp.asarray(slot_id.numpy()), cap + 1, (1, h, w), jnp.asarray(pos))
    variables = randomized_variables(jview.init(jax.random.PRNGKey(0), *args))
    want = np.asarray(jax.jit(lambda v, *a: jview.apply(v, *a[:4], cap + 1, (1, h, w), a[4]))(
        variables, *args[:4], args[6]))

    sd = {}
    export_mvf_view(sd, "v", variables["params"], variables["batch_stats"],
                    VIEW["num_filters"], VIEW["layer_nums"])
    view = SingleView(20, **VIEW)
    view.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    view.eval()
    o = order
    with torch.no_grad():
        got = view(torch.from_numpy(feats)[o], torch.from_numpy(valid)[o], slot_s, slot_id, (1, h, w),
                   ViewCoords(None, None, torch.from_numpy(pos[:, 0]), torch.from_numpy(pos[:, 1])),
                   torch.zeros(n, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- whole reader, e2e

def test_mvf_feature_net_bev_matches_jax(mvf):
    cfg, pts, mask, jmodel, variables, model = mvf
    want = np.asarray(jax.jit(lambda v, p, m: jmodel.apply(v, p, m, method=lambda mod, p, m: mod.reader(p, m)))(
        variables, jnp.asarray(pts), jnp.asarray(mask)))
    tel = {}
    with torch.inference_mode():
        got = model.reader(torch.from_numpy(pts), torch.from_numpy(mask), telemetry=tel)
    assert got.shape == want.shape == (2, 8, 8, 16)
    assert float(np.abs(want).max()) > 1.0 and (want != 0).mean() > 0.5
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    assert set(tel) == {"pillar_active", "pillar_overflow", "cylinder_active", "cylinder_overflow"}
    assert int(tel["pillar_overflow"]) == int(tel["cylinder_overflow"]) == 0
    assert int(tel["cylinder_active"]) > 0 and int(tel["pillar_active"]) > 0


def _assert_same_detections(got, ref):
    assert ref["valid"].sum() >= 8, "vacuous parity: too few detections"
    for i in range(ref["valid"].shape[0]):
        o_valid, r_valid = got["valid"][i], ref["valid"][i].astype(bool)
        assert o_valid.sum() == r_valid.sum(), f"sample {i}: {o_valid.sum()} vs {r_valid.sum()}"
        o_scores, r_scores = got["scores"][i][o_valid], ref["scores"][i][r_valid]
        o_labels, r_labels = got["label_preds"][i][o_valid], ref["label_preds"][i][r_valid]
        o_ord, r_ord = np.lexsort((-o_scores, o_labels)), np.lexsort((-r_scores, r_labels))
        np.testing.assert_array_equal(o_labels[o_ord], r_labels[r_ord])
        np.testing.assert_allclose(o_scores[o_ord], r_scores[r_ord], atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(got["box3d_lidar"][i][o_valid][o_ord],
                                   ref["box3d_lidar"][i][r_valid][r_ord],
                                   atol=2e-2, rtol=1e-3, err_msg=f"sample {i} box mismatch")


def test_mvf_slice_matches_jax(mvf):
    cfg, pts, mask, jmodel, variables, model = mvf
    ref = jax.jit(
        lambda v, p, m: jmodel.apply(v, {"points": p, "points_mask": m}, method=jmodel.predict)
    )(variables, jnp.asarray(pts), jnp.asarray(mask))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert model.backbone is None and model.reader.capacity == 4096
    got = AdaptivePredictor(model).predict(torch.from_numpy(pts), torch.from_numpy(mask))
    got = {k: v.numpy() for k, v in got.items()}
    # two tasks: vehicle; pedestrian + cyclist, 500 boxes per class
    assert got["box3d_lidar"].shape == ref["box3d_lidar"].shape == (2, 3 * 500, 9)
    _assert_same_detections(got, ref)


def test_mvf_overflow_is_repaired_or_raises_as_jax_does(mvf):
    """Buckets of 256 and 1024 pillars for a frame of 330: the small one
    overflows and both packages repair the frame at the large one.  With 64
    cylinder cells the cylinder table overflows at every bucket (the
    buckets scale the pillar table only): both raise."""
    _, pts, mask, _, variables, _ = mvf
    pts, mask = pts[:1], mask[:1]
    buckets = (256, 1024)
    for cyl_cap, repairs in ((1024, True), (64, False)):
        cfg = small_mvf_cfg("model.reader.pillar_capacity=1024", f"model.reader.cylinder_capacity={cyl_cap}")
        jengine = jax_serving.AdaptivePredictor(cfg, variables, buckets=buckets)
        engine = AdaptivePredictor(load_jax_variables(build_model(cfg, device="cpu"), variables),
                                   buckets=buckets)
        if repairs:
            ref = {k: np.asarray(v) for k, v in jengine.predict(jnp.asarray(pts), jnp.asarray(mask)).items()}
            got = {k: v.numpy() for k, v in engine.predict(torch.from_numpy(pts), torch.from_numpy(mask)).items()}
            assert jengine.repaired == engine.repaired == 1 and engine.level == 1
            assert engine.peak_required == 330
            _assert_same_detections(got, ref)
        else:
            with pytest.raises(RuntimeError, match="overflows even the largest"):
                jengine.predict(jnp.asarray(pts), jnp.asarray(mask))
            with pytest.raises(RuntimeError, match="overflows even the largest"):
                engine.predict(torch.from_numpy(pts), torch.from_numpy(mask))


def test_build_model_mvf_defaults_to_the_card_and_refuses_training():
    """Eval and training both default to the card (and raise without one);
    on the CPU ``train=True`` builds the MVF detector in train mode with the
    config's capacities (it has no train capacity), and a train-mode
    forward gives the BEV with a gradient.  (The name dates from before
    MVF trained, when both refused.)"""
    cfg = load_experiment(MVF)["model"]
    if not torch.cuda.is_available():
        for train in (False, True):
            with pytest.raises(RuntimeError, match="cuda"):
                build_model(cfg, train=train)
    model = build_model(small_mvf_cfg(), device="cpu", train=True)
    assert model.training and model.reader.training
    assert (model.reader.pillar_capacity, model.reader.cylinder_capacity) == (4096, 1024)
    pts, mask = lidar_like_points(1, 500, PC, seed=0)
    bev = model.reader(torch.from_numpy(pts), torch.from_numpy(mask))
    assert bev.shape == (1, 8, 8, 16) and bev.requires_grad
