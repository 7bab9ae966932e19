"""The port's tile-stack SubM (ops/tile_subm.py) vs the JAX package (CPU).

A compact table over a clustered active set on a 64 x 64 grid, B = 2,
8 x 8 tiles.  The tile map's fields equal JAX's, with and without tile
overflow; the row movements (pack, unpack, stack-to-dense, the halo) are
copies, so their outputs equal JAX's bit for bit; the halo's backward
agrees with JAX's custom VJP at ``rtol 1e-6``; a tile stage agrees with
JAX's ``_TileStage`` in eval and in training (output, BN statistics and
gradients) at the backbone's ``atol = rtol = 1e-3`` and the train test's
gradient bar (``1e-3 max|g_jax| + 1e-6``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pillarnext_tpu.models.resnet import _TileStage
from pillarnext_tpu.ops import tile_subm as jts
from pillarnext_tpu.utils import torch_import as ti
from pillarnext_tpu_torch.models.layers import BN_EPS_SPARSE, BN_MOMENTUM_SPARSE, ConvBlock, ResidualBlock
from pillarnext_tpu_torch.models.resnet import tile_stage
from pillarnext_tpu_torch.ops import tile_subm as ts
from tests.test_torch_port_train import random_variables
from tests.test_torch_port_backbone_modes import CAP, CIN, sparse_input

T = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    return sparse_input(5)


def maps(port, jx, tile_cap):
    tm = ts.build_tile_map(port.slot_of_dense, port.slot_id, port.batch, port.spatial, CAP, T, tile_cap)
    jtm = jts.build_tile_map(jx.slot_of_dense, jx.slot_id, jx.batch, jx.spatial, CAP, T, tile_cap)
    return tm, jtm


@pytest.mark.parametrize("tile_cap", [128, 24])
def test_tile_map_matches_jax(inputs, tile_cap):
    """128 slots hold every tile of the 2 x 8 x 8 grid; 24 overflow."""
    tm, jtm = maps(*inputs, tile_cap)
    for field in ("tile_sod", "tile_id", "nbr", "out_mask", "row_of_slot", "n_tiles"):
        np.testing.assert_array_equal(getattr(tm, field).numpy(), np.asarray(getattr(jtm, field)), err_msg=field)
    n = int(tm.n_tiles)
    assert (n > tile_cap) == (tile_cap == 24) and n > 24


@pytest.mark.parametrize("tile_cap", [128, 24])
def test_row_movements_bit_equal_to_jax(inputs, tile_cap):
    port, jx = inputs
    tm, jtm = maps(port, jx, tile_cap)
    stack = ts.pack_stack(port.table, tm)
    jstack = jts.pack_stack(jx.table, jtm)
    np.testing.assert_array_equal(stack.numpy(), np.asarray(jstack))
    np.testing.assert_array_equal(ts.unpack_stack(stack, tm).numpy(), np.asarray(jts.unpack_stack(jstack, jtm)))
    np.testing.assert_array_equal(ts.stack_to_dense(stack, tm).numpy(),
                                  np.asarray(jts.stack_to_dense(jstack, jtm)))
    # a stack with values in every cell, inactive ones too
    full = np.random.default_rng(1).standard_normal(tuple(stack.shape)).astype(np.float32)
    halo = ts.halo_gather(torch.from_numpy(full), tm).numpy()
    np.testing.assert_array_equal(halo, np.asarray(jts.halo_gather(jnp.asarray(full), jtm.nbr)))
    assert halo.shape == (tile_cap, T + 2, T + 2, CIN)


@pytest.mark.parametrize("tile_cap", [128, 24])
def test_backwards_match_jax(inputs, tile_cap):
    """The halo's backward against JAX's custom VJP (``rtol 1e-6``); the
    pack, unpack and stack-to-dense backwards (copies) bit for bit."""
    port, jx = inputs
    tm, jtm = maps(port, jx, tile_cap)
    rng = np.random.default_rng(2)
    stack = rng.standard_normal((tile_cap, T, T, CIN)).astype(np.float32)
    cot = rng.standard_normal((tile_cap, T + 2, T + 2, CIN)).astype(np.float32)
    x = torch.from_numpy(stack).requires_grad_(True)
    ts.halo_gather(x, tm).backward(torch.from_numpy(cot))
    _, vjp = jax.vjp(lambda s: jts.halo_gather(s, jtm.nbr), jnp.asarray(stack))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), rtol=1e-6, atol=1e-6)

    table = port.table[:-1].clone().requires_grad_(True)
    for fwd, jfwd, arg, jarg in (
        (lambda a: ts.pack_stack(a, tm), lambda a: jts.pack_stack(a, jtm), table, jx.table[:-1]),
        (lambda a: ts.unpack_stack(a, tm), lambda a: jts.unpack_stack(a, jtm), x, jnp.asarray(stack)),
        (lambda a: ts.stack_to_dense(a, tm), lambda a: jts.stack_to_dense(a, jtm), x, jnp.asarray(stack)),
    ):
        out, jvjp = jax.vjp(jfwd, jarg)
        g = rng.standard_normal(out.shape).astype(np.float32)
        arg.grad = None
        fwd(arg).backward(torch.from_numpy(g))
        np.testing.assert_array_equal(arg.grad.numpy(), np.asarray(jvjp(jnp.asarray(g))[0]))


def _port_stage(variables, cin, features):
    stage = nn.ModuleList([ConvBlock(cin, features, 3, eps=BN_EPS_SPARSE, momentum=BN_MOMENTUM_SPARSE),
                           ResidualBlock(features, 3, eps=BN_EPS_SPARSE)])
    sd = {}
    p, s = variables["params"], variables["batch_stats"]
    ti._inv_conv_block(sd, "0", p["down"], s["down"])
    ti._inv_residual_block(sd, "1", p["block_0"], s["block_0"])
    stage.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}, strict=True)
    return stage


@pytest.mark.parametrize("train", [False, True])
def test_tile_stage_matches_jax(inputs, train):
    port, jx = inputs
    features = 24
    tm, jtm = maps(port, jx, 128)
    jstack = jts.pack_stack(jx.table, jtm)
    jstage = _TileStage(features, 3, 1)
    variables = random_variables(jax.eval_shape(jstage.init, jax.random.PRNGKey(0), jstack, jtm.out_mask, jtm.nbr), 7)
    stage = _port_stage(variables, CIN, features).train(train)
    cot = np.random.default_rng(3).standard_normal((128, T, T, features)).astype(np.float32)

    def jloss(params, stack):
        out, state = jstage.apply({"params": params, "batch_stats": variables["batch_stats"]}, stack,
                                  jtm.out_mask, jtm.nbr, train, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, state)

    (_, (want, state)), (g_params, g_stack) = jax.jit(
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(variables["params"], jstack)

    stack = ts.pack_stack(port.table, tm).detach().requires_grad_(True)
    got = tile_stage(stage, stack, tm, plain=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-3, rtol=1e-3)
    mask = tm.out_mask.numpy()
    assert np.all(got.detach().numpy()[~mask] == 0) and mask.any()
    if not train:
        return
    got.backward(torch.from_numpy(cot))
    bar = 1e-3 * np.abs(np.asarray(g_stack)).max() + 1e-6
    assert np.abs(stack.grad.numpy() - np.asarray(g_stack)).max() <= bar
    want_grads, want_stats = {}, {}
    ti._inv_conv_block(want_grads, "0", jax.tree.map(np.asarray, g_params["down"]), variables["batch_stats"]["down"])
    ti._inv_residual_block(want_grads, "1", jax.tree.map(np.asarray, g_params["block_0"]),
                           variables["batch_stats"]["block_0"])
    new = jax.tree.map(np.asarray, state["batch_stats"])
    ti._inv_conv_block(want_stats, "0", variables["params"]["down"], new["down"])
    ti._inv_residual_block(want_stats, "1", variables["params"]["block_0"], new["block_0"])
    checked = 0
    for name, p in stage.named_parameters():
        ref = np.asarray(want_grads[name], np.float32)
        assert np.abs(p.grad.numpy() - ref).max() <= 1e-3 * np.abs(ref).max() + 1e-6, name
        checked += 1
    for name, buf in stage.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_stats[name], rtol=1e-5, atol=1e-5, err_msg=name)
        checked += 1
    assert checked == 9 + 6  # 3 convs, 3 BNs
