"""The port's training ops vs the JAX package, forward and VJP, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  Bars:

- kernel 3's plain version (``sorted_segment_bcast``, which CPU tensors
  take) against the Pallas kernel in interpret mode, on layouts of a few
  TPU tiles and on those at the CUDA kernel's tile and thread-group
  boundaries (``segment_layout``): ``max`` exactly;
  ``sum`` within 2^-20 of the segment's sum of magnitudes, against both the
  interpret kernel and a float64 sum (the TPU kernel forms prefix + suffix
  - x, which cancels, so a relative bar on the sum itself cannot hold);
- ``pillar_max_broadcast``'s gradient against ``jax.vjp`` of
  ``gather_segments(segment_max(x))``: exactly, with many tied zeros;
- neighbour tables and active sets: exactly; gathers (densify): exactly;
- convolutions, BatchNorm and losses: rtol 1e-5 with an atol of 1e-6 of
  the largest magnitude (f32 sums reassociate in XLA CPU and ATen).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as flax_nn

from pillarnext_tpu.core import jax_box_ops
from pillarnext_tpu.data import assign as jax_assign
from pillarnext_tpu.data.collate import collate as jax_collate
from pillarnext_tpu.models import layers as jax_layers
from pillarnext_tpu.models import losses as jax_losses
from pillarnext_tpu.ops import densify as jax_densify
from pillarnext_tpu.ops import scatter as jax_scatter
from pillarnext_tpu.ops import sparse_down as jax_down
from pillarnext_tpu.ops import subm_conv as jax_subm
from pillarnext_tpu.ops.pallas_segscan import sorted_segment_bcast as jax_bcast
from pillarnext_tpu.utils import synth as jax_synth
from pillarnext_tpu_torch.core import torch_box_ops
from pillarnext_tpu_torch.data.assign import AssignLabel
from pillarnext_tpu_torch.data.collate import collate
from pillarnext_tpu_torch.models import losses
from pillarnext_tpu_torch.models.layers import BatchNorm
from pillarnext_tpu_torch.ops import densify, scatter, sparse_down, subm_conv
from pillarnext_tpu_torch.ops.compact import compactify, invert_slot_map
from pillarnext_tpu_torch.ops.segscan import TILE, device_launches, pillar_max_broadcast, sorted_segment_bcast
from pillarnext_tpu_torch.train.train_state import AdamW, cosine_onecycle_schedule
from pillarnext_tpu_torch.utils import synth
from test_torch_port_cuda import SEGMENT_LAYOUTS, group_rows, segment_layout


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * max(np.abs(want).max(), 1e-3))


def _segments(rng, n, kind):
    if kind == "random":
        return np.cumsum(rng.random(n) < 0.2).astype(np.int32)
    if kind == "singletons":
        return np.arange(n, dtype=np.int32) * 3
    seg = np.cumsum(rng.random(n) < 0.2).astype(np.int32)
    start = n // 5
    seg[start:start + n * 6 // 10] = seg[start]  # one segment of 60% of the rows
    return np.maximum.accumulate(seg)


# ------------------------------------------------------------------ kernel 3


@pytest.mark.parametrize("kind", ["random", "singletons", "giant", *SEGMENT_LAYOUTS])
def test_sorted_segment_bcast_plain_matches_pallas_interpret(kind):
    """The three layouts of a few TPU tiles, and the layouts at the CUDA
    kernel's tile and thread-group boundaries (``segment_layout``)."""
    if kind in SEGMENT_LAYOUTS:
        seg = segment_layout(kind, group_rows(8, 4))
        rng = np.random.default_rng(SEGMENT_LAYOUTS.index(kind))
    else:
        rng = np.random.default_rng({"random": 0, "singletons": 1, "giant": 2}[kind])
        seg = _segments(rng, 613, kind)  # three TPU tiles, a ragged last one
    n = seg.shape[0]
    x = rng.standard_normal((n, 8)).astype(np.float32)
    for reduce in ("max", "sum"):
        want = np.asarray(jax_bcast(jnp.asarray(x), jnp.asarray(seg), reduce=reduce, interpret=True))
        got = sorted_segment_bcast(torch.from_numpy(x), torch.from_numpy(seg), reduce).numpy()
        if reduce == "max":
            np.testing.assert_array_equal(got, want)
            continue
        exact = np.zeros((seg[-1] + 1, 8))
        np.add.at(exact, seg, x.astype(np.float64))
        mag = np.zeros((seg[-1] + 1, 8))
        np.add.at(mag, seg, np.abs(x.astype(np.float64)))
        # relative to the segment's magnitude sum: the TPU kernel's
        # prefix + suffix - x cancels, so rtol on the sum itself cannot hold
        bar = 2.0**-20 * mag[seg]
        assert np.all(np.abs(got - exact[seg]) <= bar)
        assert np.all(np.abs(got - want) <= bar)


def test_segscan_device_launches():
    """One kernel call is one device launch up to a tile, three up to
    TILE^2 / 2 rows (the train shape's 1.2M), then two more per level."""
    assert [device_launches(n) for n in (1, TILE, TILE + 1, 1_200_000, TILE * TILE // 2)] == [1, 1, 3, 3, 3]
    assert device_launches(TILE * TILE // 2 + 1) == 5


def test_sorted_segment_bcast_bf16_and_empty():
    rng = np.random.default_rng(3)
    seg = np.cumsum(rng.random(500) < 0.3).astype(np.int32)
    x = torch.from_numpy(rng.standard_normal((500, 5)).astype(np.float32)).bfloat16()
    s = torch.from_numpy(seg)
    got_max = sorted_segment_bcast(x, s, "max")
    assert got_max.dtype == torch.bfloat16
    ref = jax_scatter.segment_max(jnp.asarray(x.float().numpy()), jnp.asarray(seg), int(seg[-1]) + 1)
    np.testing.assert_array_equal(got_max.float().numpy(), np.asarray(ref)[seg])
    got_sum = sorted_segment_bcast(x, s, "sum").float().numpy()
    sums = np.zeros((seg[-1] + 1, 5), np.float64)
    np.add.at(sums, seg, x.float().numpy().astype(np.float64))
    np.testing.assert_allclose(got_sum, sums[seg], rtol=2**-8, atol=1e-6)  # one bf16 rounding
    empty = sorted_segment_bcast(torch.zeros((0, 4)), torch.zeros((0,), dtype=torch.int32), "max")
    assert empty.shape == (0, 4)


def test_pillar_max_broadcast_vjp_matches_jax_with_ties():
    rng = np.random.default_rng(4)
    n, c = 900, 16
    seg = np.cumsum(rng.random(n) < 0.25).astype(np.int32)
    seg[-200:] = seg[-201] + 1  # a dump segment of masked (zero) rows
    x = np.maximum(rng.standard_normal((n, c)), 0.0).astype(np.float32)  # ReLU: many tied zeros
    x[-200:] = 0.0
    g = rng.standard_normal((n, c)).astype(np.float32)
    num = int(seg[-1]) + 1
    sj = jnp.asarray(seg)

    def pair(v):
        return jax_scatter.gather_segments(
            jax_scatter.segment_max(v, sj, num, indices_are_sorted=True), sj
        )

    want, vjp = jax.vjp(pair, jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = pillar_max_broadcast(xt, torch.from_numpy(seg))
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_g))
    assert (x == 0).mean() > 0.4


def test_pillar_max_broadcast_non_finite_max_matches_jax():
    """A segment whose max overflowed to inf (or holds a NaN) reads 0 and
    passes no gradient, in the forward as in the JAX pair's VJP."""
    rng = np.random.default_rng(6)
    n, c = 300, 4
    seg = np.cumsum(rng.random(n) < 0.2).astype(np.int32)
    x = np.maximum(rng.standard_normal((n, c)), 0.0).astype(np.float32)
    x[seg == seg[50], 0] = np.inf
    x[seg == seg[150], 2] = np.nan
    g = rng.standard_normal((n, c)).astype(np.float32)
    sj = jnp.asarray(seg)
    num = int(seg[-1]) + 1
    want, vjp = jax.vjp(
        lambda v: jax_scatter.gather_segments(jax_scatter.segment_max(v, sj, num, indices_are_sorted=True), sj),
        jnp.asarray(x),
    )
    xt = torch.from_numpy(x).requires_grad_()
    got = pillar_max_broadcast(xt, torch.from_numpy(seg))
    got.backward(torch.from_numpy(g))
    assert np.isfinite(np.asarray(want)).all() and got.detach().numpy()[50, 0] == 0.0
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


def test_segment_max_and_gather_segments_vjp_match_jax():
    rng = np.random.default_rng(5)
    n, c, num = 400, 6, 90
    seg = np.sort(rng.integers(0, num - 5, n)).astype(np.int32)
    x = np.round(rng.standard_normal((n, c)), 1).astype(np.float32)  # rounded: ties
    g = rng.standard_normal((num, c)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jax_scatter.segment_max(v, jnp.asarray(seg), num), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = scatter.segment_max(xt, torch.from_numpy(seg), num)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))

    table = rng.standard_normal((num, c)).astype(np.float32)
    gb = rng.standard_normal((n, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jax_scatter.gather_segments(t, jnp.asarray(seg)), jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    scatter.gather_segments(tt, torch.from_numpy(seg)).backward(torch.from_numpy(gb))
    _close(tt.grad.numpy(), vjp(jnp.asarray(gb))[0])


# ------------------------------------------------------------- sparse convs

H = W = 24
B = 2


def _active_set(rng, cap, n_sites=500):
    ids = []
    for b in range(B):
        centers = rng.integers(0, H, (5, 2))
        yx = centers[rng.integers(0, 5, n_sites // B)] + rng.integers(-3, 4, (n_sites // B, 2))
        ok = (yx >= 0).all(1) & (yx < H).all(1)
        ids.append(b * H * W + yx[ok, 0] * W + yx[ok, 1])
    ids = torch.from_numpy(np.concatenate(ids).astype(np.int32))
    _, _, slot_id, n = compactify(ids, B * H * W, cap)
    assert int(n) <= cap
    sod, valid = invert_slot_map(slot_id, B * H * W)
    return sod, slot_id, valid


@pytest.mark.parametrize("k", [3, 1])
def test_subm_conv_forward_and_vjp(k):
    rng = np.random.default_rng(6 + k)
    cap, cin, cout = 400, 8, 12
    sod, slot_id, valid = _active_set(rng, cap)
    offsets = subm_conv.subm_offsets_2d(k)
    nbr = subm_conv.build_neighbor_table(sod, slot_id, (H, W), offsets, cap)
    jnbr = jax_subm.build_neighbor_table(jnp.asarray(sod.numpy()), jnp.asarray(slot_id.numpy()), (H, W), offsets, cap)
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(jnbr))
    feats = rng.standard_normal((cap, cin)).astype(np.float32) * valid.numpy()[:, None]
    table = np.concatenate([feats, np.zeros((1, cin), np.float32)])
    kernel = (rng.standard_normal((k * k, cin, cout)) / (k * np.sqrt(cin))).astype(np.float32)
    g = rng.standard_normal((cap, cout)).astype(np.float32)

    want, vjp = jax.vjp(lambda t, w: jax_subm.subm_conv(t, jnbr, w), jnp.asarray(table), jnp.asarray(kernel))
    want_dt, want_dk = vjp(jnp.asarray(g))
    tt = torch.from_numpy(table).requires_grad_()
    kt = torch.from_numpy(kernel).requires_grad_()
    got = subm_conv.subm_conv(tt, nbr, kt)
    got.backward(torch.from_numpy(g))
    _close(got.detach().numpy(), want)
    _close(tt.grad.numpy(), want_dt)
    _close(kt.grad.numpy(), want_dk)
    assert np.all(tt.grad.numpy()[-1] == 0)


def test_sparse_strided_conv_tables_forward_and_vjp():
    rng = np.random.default_rng(9)
    cap, cap_out, cin, cout = 400, 300, 8, 10
    sod, slot_id, valid = _active_set(rng, cap)
    out = sparse_down.downsample_active_set(sod, cap, B, (H, W), (3, 3), (2, 2), cap_out)
    jout = jax_down.downsample_active_set(jnp.asarray(sod.numpy()), cap, B, (H, W), (3, 3), (2, 2), cap_out)
    for a, b in zip(out[:3], jout[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tuple(out[3]) == tuple(jout[3]) and int(out[4]) == int(jout[4])
    fwd, rev = sparse_down.build_down_neighbor_tables(sod, out[0], slot_id, B, (H, W), (3, 3), (2, 2))
    jfwd, jrev = jax_down.build_down_neighbor_tables(
        jnp.asarray(sod.numpy()), jout[0], jout[1], jnp.asarray(slot_id.numpy()), B, (H, W), (3, 3), (2, 2)
    )
    np.testing.assert_array_equal(fwd.numpy(), np.asarray(jfwd))
    np.testing.assert_array_equal(rev.numpy(), np.asarray(jrev))

    feats = rng.standard_normal((cap, cin)).astype(np.float32) * valid.numpy()[:, None]
    table = np.concatenate([feats, np.zeros((1, cin), np.float32)])
    kernel = (rng.standard_normal((9, cin, cout)) / (3 * np.sqrt(cin))).astype(np.float32)
    g = rng.standard_normal((cap_out, cout)).astype(np.float32)
    want, vjp = jax.vjp(
        lambda t, w: jax_down.sparse_strided_conv(t, jfwd, jrev, w), jnp.asarray(table), jnp.asarray(kernel)
    )
    want_dt, want_dk = vjp(jnp.asarray(g))
    tt = torch.from_numpy(table).requires_grad_()
    kt = torch.from_numpy(kernel).requires_grad_()
    got = sparse_down.sparse_strided_conv(tt, fwd, rev, kt)
    got.backward(torch.from_numpy(g))
    _close(got.detach().numpy(), want)
    _close(tt.grad.numpy(), want_dt)
    _close(kt.grad.numpy(), want_dk)


def test_densify_vjp_matches_jax():
    rng = np.random.default_rng(10)
    cap, c = 400, 6
    sod, slot_id, valid = _active_set(rng, cap)
    table = np.concatenate([rng.standard_normal((cap, c)), np.zeros((1, c))]).astype(np.float32)
    g = rng.standard_normal((B * H * W, c)).astype(np.float32)
    want, vjp = jax.vjp(
        lambda t: jax_densify.densify(t, jnp.asarray(sod.numpy()), jnp.asarray(slot_id.numpy())),
        jnp.asarray(table),
    )
    tt = torch.from_numpy(table).requires_grad_()
    got = densify.densify(tt, sod, slot_id)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(tt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


# ---------------------------------------------------------------- BatchNorm


@pytest.mark.parametrize("masked", [True, False])
def test_batchnorm_train_and_running_stats(masked):
    rng = np.random.default_rng(11 + masked)
    c = 7
    x = (rng.standard_normal((60, c)) * 3 + 2).astype(np.float32)
    valid = rng.random(60) < 0.7
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    mean0 = rng.normal(0, 0.1, c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    g = rng.standard_normal((60, c)).astype(np.float32)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}
    if masked:
        mod = jax_layers.MaskedBatchNorm()

        def apply(p, v):
            return mod.apply({"params": p, "batch_stats": stats}, v, jnp.asarray(valid), True,
                             mutable=["batch_stats"])

        bn = BatchNorm(c, jax_layers.BN_EPS_SPARSE, jax_layers.BN_MOMENTUM_SPARSE)
    else:
        mod = flax_nn.BatchNorm(use_running_average=False, momentum=jax_layers.BN_MOMENTUM_DENSE,
                                epsilon=jax_layers.BN_EPS_DENSE)

        def apply(p, v):
            return mod.apply({"params": p, "batch_stats": stats}, v, mutable=["batch_stats"])

        bn = BatchNorm(c, jax_layers.BN_EPS_DENSE, jax_layers.BN_MOMENTUM_DENSE)
    want_y, vjp, new_stats = jax.vjp(apply, params, jnp.asarray(x), has_aux=True)
    want_dp, want_dx = vjp(jnp.asarray(g))
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    bn.train()
    xt = torch.from_numpy(x).requires_grad_()
    got = bn(xt, channel_dim=-1, valid=torch.from_numpy(valid) if masked else None)
    got.backward(torch.from_numpy(g))
    _close(got.detach().numpy(), want_y)
    _close(xt.grad.numpy(), want_dx)
    _close(bn.weight.grad.numpy(), want_dp["scale"])
    _close(bn.bias.grad.numpy(), want_dp["bias"])
    _close(bn.running_mean.numpy(), new_stats["batch_stats"]["mean"])
    _close(bn.running_var.numpy(), new_stats["batch_stats"]["var"])


# ------------------------------------------------------------------- losses


def _boxes(rng, n):
    xyz = rng.uniform(-5, 5, (n, 3))
    dims = rng.uniform(0.5, 4.0, (n, 3))
    yaw = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([xyz, dims, yaw], 1).astype(np.float32)


def test_box_ious_match_jax():
    rng = np.random.default_rng(12)
    a = _boxes(rng, 20)  # the shape the loss test below feeds the jitted IoU
    b = a + rng.normal(0, 0.5, a.shape).astype(np.float32) * [1, 1, 1, 0.2, 0.2, 0.2, 1]
    b[:, 3:6] = np.abs(b[:, 3:6])
    _close(torch_box_ops.boxes_aligned_iou3d(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
           jax_box_ops.boxes_aligned_iou3d(jnp.asarray(a), jnp.asarray(b)))
    _close(torch_box_ops.bbox3d_overlaps_diou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
           jax_box_ops.bbox3d_overlaps_diou(jnp.asarray(a), jnp.asarray(b)))


def test_losses_and_gradients_match_jax():
    rng = np.random.default_rng(13)
    b, h, w, c, m = 2, 12, 12, 3, 10
    out = np.clip(1 / (1 + np.exp(-rng.normal(-2, 2, (b, h, w, c)))), 1e-4, 1 - 1e-4).astype(np.float32)
    target = rng.uniform(0, 1, (b, h, w, c)).astype(np.float32) ** 4
    ind = rng.integers(0, h * w, (b, m)).astype(np.int64)
    mask = (rng.random((b, m)) < 0.6).astype(np.uint8)
    cat = rng.integers(0, c, (b, m)).astype(np.int64)
    reg_map = rng.standard_normal((b, h, w, 10)).astype(np.float32)
    anno = rng.standard_normal((b, m, 10)).astype(np.float32)
    anno[0, :3, 6:8] = np.nan  # pasted objects: no velocity target
    iou_map = rng.uniform(-1, 1, (b, h, w, 1)).astype(np.float32)
    pred_boxes = _boxes(rng, b * m).reshape(b, m, 7)
    gt_boxes = _boxes(rng, b * m).reshape(b, m, 7)
    J = jnp.asarray

    def jax_all(o, r, pb):
        return (jax_losses.fast_focal_loss(o, J(target), J(ind), J(mask), J(cat))
                + jax_losses.reg_loss(r, J(mask), J(ind), J(anno)).sum()
                + jax_losses.iou_pred_loss(J(iou_map), J(mask), J(ind), J(pred_boxes), J(gt_boxes))
                + jax_losses.iou_reg_loss(pb, J(mask), J(gt_boxes)))

    want, grads = jax.value_and_grad(jax_all, argnums=(0, 1, 2))(J(out), J(reg_map), J(pred_boxes))
    T = torch.from_numpy
    o, r, pb = (T(v).requires_grad_() for v in (out, reg_map, pred_boxes))
    got = (losses.fast_focal_loss(o, T(target), T(ind), T(mask), T(cat))
           + losses.reg_loss(losses.gather_feature_map(r, T(ind)), T(mask), T(anno)).sum()
           + losses.iou_pred_loss(T(iou_map), T(mask), T(ind), T(pred_boxes), T(gt_boxes))
           + losses.iou_reg_loss(pb, T(mask), T(gt_boxes)))
    got.backward()
    _close(got.detach().numpy(), want)
    for t, gw in zip((o, r, pb), grads):
        _close(t.grad.numpy(), gw)
    assert np.isfinite(got.item())


# ---------------------------------------------------------------- host data


def test_assign_label_and_collate_bit_exact():
    pc = [-20.0, -20.0, -5.0, 20.0, 20.0, 3.0]
    tasks = [["car"], ["truck", "construction_vehicle"], ["pedestrian", "traffic_cone"]]
    kw = dict(tasks=tasks, gaussian_overlap=0.1, max_objs=50, min_radius=2, pc_range=pc,
              voxel_size=[0.2, 0.2, 8.0], out_size_factor=[4, 4, 4])
    names = [n for t in tasks for n in t]
    samples, jsamples = [], []
    for seed in (0, 1):
        pts, boxes, labels = synth.synth_detection_scene(np.random.default_rng(seed), 4000, pc, 8, names)
        jpts, jboxes, jlabels = jax_synth.synth_detection_scene(np.random.default_rng(seed), 4000, pc, 8, names)
        np.testing.assert_array_equal(pts, jpts)
        np.testing.assert_array_equal(boxes, jboxes)
        ann = {"gt_boxes": boxes, "gt_names": labels}
        got = AssignLabel(**kw)({"annotations": ann})
        want = jax_assign.AssignLabel(**kw)({"annotations": dict(ann)})
        for key in ("hm", "anno_box", "ind", "mask", "cat", "gt_boxes"):
            for a, b in zip(got[key], want[key]):
                np.testing.assert_array_equal(a, b)
        samples.append({"points": pts, **{k: got[k] for k in ("hm", "ind", "mask")}})
        jsamples.append({"points": jpts, **{k: want[k] for k in ("hm", "ind", "mask")}})
    got = collate(samples, 5000, np.random.default_rng(0))
    want = jax_collate(jsamples, 5000, np.random.default_rng(0))
    for key in ("points", "points_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    small = collate(samples, 3000, np.random.default_rng(1))  # overflow: random subsample
    np.testing.assert_array_equal(small["points"], jax_collate(jsamples, 3000, np.random.default_rng(1))["points"])


# ---------------------------------------------------------------- optimizer


def test_onecycle_schedule_matches_optax():
    """Every step of a 100-step cycle (the flagship's pct_start and
    div_factor).  optax evaluates in float32 — its eager and jitted values
    differ by up to 6e-7 relative, and near the end of the cycle
    ``cos(pi * pct) + 1`` cancels — while the port evaluates in float64.
    So the bar is 1e-7 relative plus two float32 ulps of the cosine term's
    amplitude ``|start - end| / 2``."""
    kw = dict(pct_start=0.4, div_factor=10.0, final_div_factor=1e4)
    mine = cosine_onecycle_schedule(100, 0.002, **kw)
    ref = jax.jit(optax.cosine_onecycle_schedule(100, 0.002, **kw))
    values = [0.0002, 0.002, 2e-8]
    for step in range(101):
        want = float(ref(jnp.asarray(step, jnp.int32)))
        phase = 0 if step < 40 else 1
        amp = abs(values[phase] - values[phase + 1]) / 2
        assert abs(mine(step) - want) <= 1e-7 * want + 2.0**-22 * amp, step
    assert mine(0) == pytest.approx(0.0002, rel=1e-12)
    assert mine(40) == pytest.approx(0.002, rel=1e-12)
    assert mine(100) == pytest.approx(2e-8, rel=1e-12)


def test_adamw_with_clip_matches_optax():
    rng = np.random.default_rng(14)
    shapes = [(5, 3), (7,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    sched = optax.cosine_onecycle_schedule(20, 0.002, pct_start=0.4, div_factor=10.0)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, b1=0.9, b2=0.99, weight_decay=0.01))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = AdamW(tp, cosine_onecycle_schedule(20, 0.002, pct_start=0.4, div_factor=10.0),
                betas=(0.9, 0.99), weight_decay=0.01, clip_norm=1.0)
    for step in range(3):
        grads = [(rng.standard_normal(s) * (3.0 if step == 0 else 0.1)).astype(np.float32) for s in shapes]
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        norm = opt.step()
        assert float(norm) == pytest.approx(float(optax.global_norm([jnp.asarray(g) for g in grads])), rel=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-7)
