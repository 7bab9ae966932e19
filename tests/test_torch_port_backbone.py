"""The port's SparseResNet ``leading`` eval path vs the JAX package (CPU).

``build_neighbor_table`` must be exactly equal.  ``subm_conv`` and the
whole backbone (JAX ``SparseResNet(sparse_eval=True, masked_eval=True)``)
agree at ``atol = rtol = 1e-3`` — f32 convolutions reassociate differently
in XLA CPU and ATen — and every output outside the active set is exactly 0
on both sides.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from pillarnext_tpu.models.resnet import SparseResNet as JaxSparseResNet
from pillarnext_tpu.ops import subm_conv as jax_subm
from pillarnext_tpu.ops.sparse_bev import SparseBEV as JaxSparseBEV
from pillarnext_tpu.utils import torch_import as ti
from pillarnext_tpu_torch.models.resnet import SparseResNet
from pillarnext_tpu_torch.ops import subm_conv
from pillarnext_tpu_torch.ops.compact import compactify, invert_slot_map
from pillarnext_tpu_torch.ops.sparse_bev import SparseBEV
from tests.torch_threads import one_torch_thread  # noqa: F401

H = W = 32
B = 2
CAP = 600
CIN = 16


def _sparse_input(seed=0):
    """A compact table over a clustered active set (~25% of the grid)."""
    rng = np.random.default_rng(seed)
    ids = []
    for b in range(B):
        centers = rng.integers(0, H, (6, 2))
        yx = centers[rng.integers(0, 6, 400)] + rng.integers(-3, 4, (400, 2))
        ok = (yx >= 0).all(1) & (yx < H).all(1)
        ids.append(b * H * W + yx[ok, 0] * W + yx[ok, 1])
    ids = np.concatenate(ids).astype(np.int32)
    _, _, slot_id, n = compactify(torch.from_numpy(ids), B * H * W, CAP)
    assert int(n) <= CAP
    sod, valid = invert_slot_map(slot_id, B * H * W)
    feats = rng.standard_normal((CAP, CIN)).astype(np.float32) * valid.numpy()[:, None]
    table = np.concatenate([feats, np.zeros((1, CIN), np.float32)])
    port = SparseBEV(torch.from_numpy(table), valid, sod, slot_id, B, (H, W))
    jx = JaxSparseBEV(
        table=jnp.asarray(table), valid=jnp.asarray(valid.numpy()),
        slot_of_dense=jnp.asarray(sod.numpy()), slot_id=jnp.asarray(slot_id.numpy()),
        batch=B, spatial=(H, W),
    )
    return port, jx


def test_neighbor_table_and_subm_conv():
    port, jx = _sparse_input(1)
    offsets = subm_conv.subm_offsets_2d(3)
    np.testing.assert_array_equal(offsets, jax_subm.subm_offsets_2d(3))
    nbr = subm_conv.build_neighbor_table(port.slot_of_dense, port.slot_id, (H, W), offsets, CAP)
    jnbr = jax_subm.build_neighbor_table(jx.slot_of_dense, jx.slot_id, (H, W), offsets, CAP)
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(jnbr))

    kernel = np.random.default_rng(2).standard_normal((9, CIN, 24)).astype(np.float32) / 12
    got = subm_conv.subm_conv(port.table, nbr, torch.from_numpy(kernel)).numpy()
    want = np.asarray(jax_subm.subm_conv(jx.table, jnbr, jnp.asarray(kernel)))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    assert np.all(got[~port.valid.numpy()] == 0)


def _randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        elif k in ("bias", "mean"):
            out[k] = rng.normal(0.0, 0.1, np.shape(v)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _port_state_dict(params, stats, layer_nums):
    sd = {}
    for si, n_blocks in enumerate(layer_nums):
        bp, bs = params[f"stage_{si}"], stats[f"stage_{si}"]
        ti._inv_conv_block(sd, f"blocks.{si}.0", bp["down"], bs["down"])
        for bi in range(n_blocks):
            ti._inv_residual_block(sd, f"blocks.{si}.{bi + 1}", bp[f"block_{bi}"], bs[f"block_{bi}"])
    sd["mapping.0.weight"] = ti._inv_conv_kernel(params["ConvBlock_0"]["Conv_0"]["kernel"])
    ti._inv_bn(sd, "mapping.1", params["ConvBlock_0"]["BatchNorm_0"], stats["ConvBlock_0"]["BatchNorm_0"])
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def test_sparse_resnet_leading_eval_matches_jax():
    port, jx = _sparse_input(3)
    kw = dict(
        layer_nums=(1, 1, 1), ds_layer_strides=(1, 2, 2),
        ds_num_filters=(16, 24, 32), num_input_features=CIN, out_channels=32,
        sparse_eval=True, masked_eval=True,
    )
    jnet = JaxSparseResNet(**kw)
    variables = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0), jx))
    rng = np.random.default_rng(4)
    variables = {k: _randomize(v, rng) for k, v in variables.items()}
    want = np.asarray(jax.jit(lambda v, x: jnet.apply(v, x))(variables, jx))

    net = SparseResNet(**kw)
    net.load_state_dict(
        _port_state_dict(variables["params"], variables["batch_stats"], kw["layer_nums"]),
        strict=True,
    )
    with torch.no_grad():
        got = net.eval()(port).numpy()
    assert got.shape == want.shape == (B, H // 4, W // 4, 32)

    mask = (port.slot_of_dense < CAP).reshape(B, 1, H, W).float()
    for _ in range(2):
        mask = F.max_pool2d(mask, 3, 2, 1)
    inactive = (mask[:, 0] == 0).numpy()
    assert inactive.any() and (~inactive).any()
    assert np.all(got[inactive] == 0) and np.all(want[inactive] == 0)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
