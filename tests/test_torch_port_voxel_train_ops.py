"""The 3-D ops of voxel18 training, and the port's segment sums, on the CPU.

First the JAX package's own 3-D VJPs against JAX autodiff, since the
port's backward is held against them: ``subm_conv``'s custom VJP with
``subm_offsets_3d(3)`` (K = 27; tests/test_subm_conv.py checks K = 9 in
2-D only) and ``sparse_strided_conv``'s through
``build_down_neighbor_tables``, for the backbone's (3,3,3)/(2,2,2) with
padding 1 and the extra z-conv's (3,1,1)/(2,1,1) with padding 0, each
against ``jax.vjp`` of the naive gather + matmul: rtol 1e-4 / atol 1e-6
(1e-4 for the cotangents, summed over more terms).  Then the port's
``_SubMConv`` and ``_SparseStridedConv`` on the same seeded numpy inputs
against those JAX VJPs (forward and both cotangents, f32, rtol 1e-4 /
atol 1e-6 of the largest magnitude), and the port's masked ``BatchNorm``
in train mode on a 3-D table against JAX ``MaskedBatchNorm`` (output,
batch statistics, running statistics: 1e-5).

The segment sums (ops/scatter.py: kernel 3's sorted sum, then each
segment's first row) against ``index_add_`` within f32 rounding, on
ascending ids with empty and one-row segments; and both readers hand them
ascending ids (``assert_ascending``), the order the sums rely on and do
not check.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pillarnext_tpu.models import layers as jax_layers
from pillarnext_tpu.ops import sparse_down as jax_down
from pillarnext_tpu.ops import subm_conv as jax_subm
from pillarnext_tpu_torch.models import pillar_encoder, voxel_encoder
from pillarnext_tpu_torch.models.layers import BN_EPS_SPARSE, BN_MOMENTUM_SPARSE, BatchNorm
from pillarnext_tpu_torch.ops import scatter, sparse_down, subm_conv
from pillarnext_tpu_torch.ops.compact import compactify, invert_slot_map
from tests.torch_threads import one_torch_thread  # noqa: F401

SPATIAL = (8, 12, 12)  # (D, H, W)
B = 2
STRIDED = {
    "stage_333_222_pad1": ((3, 3, 3), (2, 2, 2), None),
    "extra_311_211_pad0": ((3, 1, 1), (2, 1, 1), (0, 0, 0)),
}


def _close(got, want, rtol=1e-4):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * max(np.abs(want).max(), 1e-3))


def assert_ascending(seg: torch.Tensor) -> None:
    """The segment ids a sorted segment sum takes never decrease."""
    seg = seg.reshape(-1)
    assert bool((seg[1:] >= seg[:-1]).all()), "segment ids are not in ascending order"


def active_set_3d(rng, cap, n_sites=700):
    """(slot_of_dense, slot_id, valid) of a clustered 3-D active set."""
    d, h, w = SPATIAL
    ids = []
    for b in range(B):
        centers = rng.integers(0, (d, h, w), (4, 3))
        zyx = centers[rng.integers(0, 4, n_sites // B)] + rng.integers(-2, 3, (n_sites // B, 3))
        ok = (zyx >= 0).all(1) & (zyx < (d, h, w)).all(1)
        zyx = zyx[ok]
        ids.append(b * d * h * w + (zyx[:, 0] * h + zyx[:, 1]) * w + zyx[:, 2])
    ids = torch.from_numpy(np.concatenate(ids).astype(np.int32))
    _, _, slot_id, n = compactify(ids, B * d * h * w, cap)
    assert 0 < int(n) <= cap
    sod, valid = invert_slot_map(slot_id, B * d * h * w)
    return sod, slot_id, valid


def _table(rng, valid, c):
    feats = rng.standard_normal((valid.shape[0], c)).astype(np.float32) * valid.numpy()[:, None]
    return np.concatenate([feats, np.zeros((1, c), np.float32)])


def _subm_case(seed=0):
    rng = np.random.default_rng(seed)
    cap, cin, cout = 500, 6, 10
    sod, slot_id, valid = active_set_3d(rng, cap)
    offsets = subm_conv.subm_offsets_3d(3)
    nbr = subm_conv.build_neighbor_table(sod, slot_id, SPATIAL, offsets, cap)
    jnbr = jax_subm.build_neighbor_table(
        jnp.asarray(sod.numpy()), jnp.asarray(slot_id.numpy()), SPATIAL, jax_subm.subm_offsets_3d(3), cap
    )
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(jnbr))
    table = _table(rng, valid, cin)
    kernel = (rng.standard_normal((27, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    g = rng.standard_normal((cap, cout)).astype(np.float32)
    return nbr, jnbr, table, kernel, g


def test_jax_subm_conv_k27_vjp_matches_autodiff():
    _, jnbr, table, kernel, g = _subm_case()
    cap, k = jnbr.shape
    cin, cout = kernel.shape[1:]

    def naive(t, w):
        return t[jnbr.reshape(-1)].reshape(cap, k * cin) @ w.reshape(k * cin, cout)

    out_n, vjp_n = jax.vjp(naive, jnp.asarray(table), jnp.asarray(kernel))
    out_c, vjp_c = jax.vjp(lambda t, w: jax_subm.subm_conv(t, jnbr, w), jnp.asarray(table), jnp.asarray(kernel))
    np.testing.assert_allclose(np.asarray(out_c), np.asarray(out_n), rtol=1e-4, atol=1e-6)
    dt_n, dk_n = vjp_n(jnp.asarray(g))
    dt_c, dk_c = vjp_c(jnp.asarray(g))
    np.testing.assert_allclose(np.asarray(dk_c), np.asarray(dk_n), rtol=1e-4, atol=1e-4)
    # the dump row's cotangent is dropped on purpose (dead downstream)
    np.testing.assert_allclose(np.asarray(dt_c)[:-1], np.asarray(dt_n)[:-1], rtol=1e-4, atol=1e-4)
    assert np.abs(np.asarray(dt_n)[:-1]).max() > 0.1, "vacuous: no table cotangent"


def test_port_subm_conv_k27_matches_jax_vjp():
    nbr, jnbr, table, kernel, g = _subm_case()
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


def _strided_case(name, seed=1):
    kernel_shape, stride, padding = STRIDED[name]
    rng = np.random.default_rng(seed)
    cap, cap_out, cin, cout = 500, 400, 6, 8
    sod, slot_id, valid = active_set_3d(rng, cap)
    out = sparse_down.downsample_active_set(sod, cap, B, SPATIAL, kernel_shape, stride, cap_out, padding)
    jout = jax_down.downsample_active_set(
        jnp.asarray(sod.numpy()), cap, B, SPATIAL, kernel_shape, stride, cap_out, padding
    )
    for a, b in zip(out[:3], jout[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    fwd, rev = sparse_down.build_down_neighbor_tables(
        sod, out[0], slot_id, B, SPATIAL, kernel_shape, stride, padding
    )
    jfwd, jrev = jax_down.build_down_neighbor_tables(
        jnp.asarray(sod.numpy()), jout[0], jout[1], jnp.asarray(slot_id.numpy()), B, SPATIAL,
        kernel_shape, stride, padding,
    )
    np.testing.assert_array_equal(fwd.numpy(), np.asarray(jfwd))
    np.testing.assert_array_equal(rev.numpy(), np.asarray(jrev))
    k = int(np.prod(kernel_shape))
    table = _table(rng, valid, cin)
    kernel = (rng.standard_normal((k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)
    g = rng.standard_normal((cap_out, cout)).astype(np.float32) * out[2].numpy()[:, None]
    return (fwd, rev), (jfwd, jrev), table, kernel, g


@pytest.mark.parametrize("name", sorted(STRIDED))
def test_jax_sparse_strided_conv_3d_vjp_matches_autodiff(name):
    _, (jfwd, jrev), table, kernel, g = _strided_case(name)
    cap_out, k = jfwd.shape
    cin, cout = kernel.shape[1:]

    def naive(t, w):
        return t[jfwd.reshape(-1)].reshape(cap_out, k * cin) @ w.reshape(k * cin, cout)

    out_n, vjp_n = jax.vjp(naive, jnp.asarray(table), jnp.asarray(kernel))
    out_c, vjp_c = jax.vjp(
        lambda t, w: jax_down.sparse_strided_conv(t, jfwd, jrev, w), jnp.asarray(table), jnp.asarray(kernel)
    )
    np.testing.assert_allclose(np.asarray(out_c), np.asarray(out_n), rtol=1e-4, atol=1e-6)
    dt_n, dk_n = vjp_n(jnp.asarray(g))
    dt_c, dk_c = vjp_c(jnp.asarray(g))
    np.testing.assert_allclose(np.asarray(dk_c), np.asarray(dk_n), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(dt_c)[:-1], np.asarray(dt_n)[:-1], rtol=1e-4, atol=1e-4)
    assert np.abs(np.asarray(dt_n)[:-1]).max() > 0.1, "vacuous: no table cotangent"


@pytest.mark.parametrize("name", sorted(STRIDED))
def test_port_sparse_strided_conv_3d_matches_jax_vjp(name):
    (fwd, rev), (jfwd, jrev), table, kernel, g = _strided_case(name)
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


@pytest.mark.parametrize("momentum", [0.0, BN_MOMENTUM_SPARSE], ids=["batch_stats", "running_stats"])
def test_masked_batchnorm_train_on_a_3d_table_matches_jax(momentum):
    """Momentum 0 makes the updated statistics the batch's own."""
    rng = np.random.default_rng(2)
    cap, c = 500, 12
    _, _, valid = active_set_3d(rng, cap)
    x = (rng.standard_normal((cap, c)) * 2 + 1).astype(np.float32) * valid.numpy()[:, None]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    mean0 = rng.normal(0, 0.1, c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    mod = jax_layers.MaskedBatchNorm(momentum=momentum)
    want, new = mod.apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}},
        jnp.asarray(x), jnp.asarray(valid.numpy()), True, mutable=["batch_stats"],
    )
    bn = BatchNorm(c, BN_EPS_SPARSE, momentum)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    got = bn.train()(torch.from_numpy(x), channel_dim=-1, valid=valid)
    _close(got.detach().numpy(), want, rtol=1e-5)
    _close(bn.running_mean.numpy(), new["batch_stats"]["mean"], rtol=1e-5)
    _close(bn.running_var.numpy(), new["batch_stats"]["var"], rtol=1e-5)
    if momentum == 0.0:  # the batch's statistics over the valid rows alone
        xv = x[valid.numpy()].astype(np.float64)
        np.testing.assert_allclose(bn.running_mean.numpy(), xv.mean(0), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), xv.var(0), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------- segment sums


def _ascending_ids(kind: str, num_segments: int = 64):
    rng = np.random.default_rng(3)
    if kind == "empty_and_single":
        # every third segment empty, every fifth holds one row
        sizes = np.where(np.arange(num_segments) % 3 == 0, 0,
                         np.where(np.arange(num_segments) % 5 == 0, 1, rng.integers(2, 9, num_segments)))
    elif kind == "one_row_each":
        sizes = np.ones(num_segments, np.int64)
    else:  # a long dump segment last, as the readers' padded points give
        sizes = np.concatenate([rng.integers(0, 6, num_segments - 1), [5000]])
    return np.repeat(np.arange(num_segments), sizes).astype(np.int32), num_segments


@pytest.mark.parametrize("kind", ["empty_and_single", "one_row_each", "long_dump"])
def test_segment_sums_equal_index_add(kind):
    seg, num = _ascending_ids(kind)
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.standard_normal((seg.shape[0], 5)) * 20).astype(np.float32))
    s = torch.from_numpy(seg)
    assert_ascending(s)
    want = torch.zeros((num, 5), dtype=torch.float64).index_add_(0, s.long(), x.double())
    count = torch.bincount(s.long(), minlength=num).double()[:, None]
    mag = torch.zeros((num, 5), dtype=torch.float64).index_add_(0, s.long(), x.double().abs())
    bar = 2.0**-20 * mag + 1e-30
    got = scatter.segment_sum(x, s, num)
    assert got.dtype == torch.float32 and got.shape == (num, 5)
    assert bool(((got.double() - want).abs() <= bar).all())
    assert bool((got[count[:, 0] == 0] == 0).all())
    mean = scatter.segment_mean(x, s, num)
    assert bool(((mean.double() - want / count.clamp(min=1)).abs() <= bar / count.clamp(min=1)).all())
    # gather_segments' backward is the same sum
    table = torch.zeros((num, 5), requires_grad=True)
    scatter.gather_segments(table, s).backward(x)
    assert torch.equal(table.grad, got)
    assert scatter.segment_sum(x[:0], s[:0], num).abs().sum() == 0


def test_readers_hand_the_segment_sums_ascending_ids(monkeypatch):
    """The voxel reader's mean and the pillar reader's cluster mean (and
    its gather) get the slot stream of the stably sorted points."""
    from pillarnext_tpu_torch.utils.synth import lidar_like_points

    seen = []

    def checked(fn):
        def wrapper(data, seg, *args, **kwargs):
            assert_ascending(seg)
            seen.append(fn.__name__)
            return fn(data, seg, *args, **kwargs)
        return wrapper

    for name in ("segment_mean", "gather_segments"):
        monkeypatch.setattr(scatter, name, checked(getattr(scatter, name)))
    pc = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
    pts, mask = (torch.from_numpy(a) for a in lidar_like_points(2, 3000, pc, seed=5))
    voxel_encoder.VoxelFeatureNet([0.25, 0.25, 0.2], pc, voxel_capacity=4096, output="sparse")(pts, mask)
    reader = pillar_encoder.PillarFeatureNet(5, [16, 16], [0.25, 0.25, 8.0], pc, pillar_capacity=4096,
                                             output="sparse")
    reader.eval()(pts, mask)
    reader.train()(pts, mask)
    assert seen == ["segment_mean"] + ["segment_mean", "gather_segments"] * 2
