"""The port's eval PFN stack vs the JAX package (CPU).

Kernel 1 serves a two-layer PFN over at most 16 decorated features.  Any
other PFN runs the ``PFNLayer`` stack in eval too (JAX's
pillar_encoder.py:160-216): ``fuse_eval=False``, one layer, three layers,
and 12 input features (17 decorated).  Against JAX's ``PillarFeatureNet``
at a +-8 m grid of 0.25 m pillars (64 x 64), f32, random BN:

- eval: the compact pillar table within ``atol = rtol = 2e-5`` (f32
  reassociation, the bar of tests/test_torch_port_reader.py), its zero
  rows and dump row exactly equal, the slot maps equal;
- one train step (batch statistics, a random cotangent on the table):
  the table within 2e-5, the updated running statistics within 1e-6 and
  every gradient within 1e-4 of its tensor's largest magnitude;
- the weights of every depth carry through the port's
  ``export_pillarnext`` (``pfn_layers_{i}`` for every i) with
  ``strict=True``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pillarnext_tpu.models.pillar_encoder import PillarFeatureNet as JaxPFN
from pillarnext_tpu_torch.models.pillar_encoder import PillarFeatureNet
from pillarnext_tpu_torch.utils import torch_import as port_import
from pillarnext_tpu_torch.utils.synth import lidar_like_points
from tests.test_torch_port_head_options import one_torch_thread  # noqa: F401 (autouse)

PC = (-8.0, -8.0, -5.0, 8.0, 8.0, 3.0)
VS = (0.25, 0.25, 8.0)
CAP = 2048
CASES = {
    "depth2_unfused": dict(num_input_features=5, num_filters=(16, 16), fuse_eval=False),
    "depth1": dict(num_input_features=5, num_filters=(16,)),
    "depth3": dict(num_input_features=5, num_filters=(16, 16, 16)),
    "features12": dict(num_input_features=12, num_filters=(16, 16)),
}


def _points(d, seed=0, b=2, n=3000):
    pts, mask = lidar_like_points(b, n, list(PC), seed=seed)
    if d > pts.shape[-1]:
        extra = np.random.default_rng(seed).normal(0.0, 1.0, pts.shape[:2] + (d - pts.shape[-1],))
        pts = np.concatenate([pts, extra.astype(np.float32)], axis=-1)
    mask[:, -n // 20:] = False
    return pts, mask


def _random(variables, seed):
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.array, variables)
    for name, layer in out["params"].items():
        bn, st = layer["MaskedBatchNorm_0"], out["batch_stats"][name]["MaskedBatchNorm_0"]
        c = bn["scale"].shape[0]
        bn["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        bn["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
        st["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
        st["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return out


def _state_dict(params, stats, depth) -> dict:
    """JAX reader trees -> the port reader's keys, through the port's
    exporter's PFN-layer map."""
    sd = {}
    for i in range(depth):
        port_import._inv_point_layer(sd, f"pfn_layers.{i}", params[f"pfn_layers_{i}"], stats[f"pfn_layers_{i}"])
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _both(case):
    kw = dict(CASES[case], voxel_size=VS, pc_range=PC, pillar_capacity=CAP, output="sparse")
    pts, mask = _points(kw["num_input_features"])
    jnet = JaxPFN(**kw)
    variables = _random(jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask)), seed=1)
    net = PillarFeatureNet(**kw)
    depth = len(kw["num_filters"])
    sd = _state_dict(variables["params"], variables["batch_stats"], depth)
    net.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    assert not net.kernel_eval
    return jnet, variables, net, pts, mask, depth


@pytest.mark.parametrize("case", list(CASES))
def test_pfn_stack_eval_matches_jax(case):
    jnet, variables, net, pts, mask, _ = _both(case)
    jsb = jax.jit(jnet.apply)(variables, jnp.asarray(pts), jnp.asarray(mask))
    with torch.no_grad():
        sb = net.eval()(torch.from_numpy(pts), torch.from_numpy(mask))
    got, want = sb.table.numpy(), np.asarray(jsb.table)
    assert got.shape == want.shape and np.abs(want).sum(-1).astype(bool).sum() > 500
    np.testing.assert_array_equal(sb.slot_of_dense.numpy(), np.asarray(jsb.slot_of_dense))
    np.testing.assert_array_equal(np.abs(got).sum(-1) == 0, np.abs(want).sum(-1) == 0)
    assert not got[-1].any()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", ["depth1", "depth3", "features12"])
def test_pfn_stack_train_step_matches_jax(case):
    jnet, variables, net, pts, mask, depth = _both(case)
    rows = CAP * 2 + 1
    cot = np.random.default_rng(2).normal(0.0, 1.0, (rows, jnet.num_filters[-1])).astype(np.float32)

    def f(params):
        sb, upd = jnet.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             jnp.asarray(pts), jnp.asarray(mask), train=True, mutable=["batch_stats"])
        return jnp.sum(sb.table * cot), (sb.table, upd["batch_stats"])

    (_, (jtable, jstats)), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(variables["params"])
    want_grads = _state_dict(jax.tree.map(np.asarray, jgrads), variables["batch_stats"], depth)
    want_stats = _state_dict(variables["params"], jax.tree.map(np.asarray, jstats), depth)

    net.train()
    sb = net(torch.from_numpy(pts), torch.from_numpy(mask))
    (sb.table * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(sb.table.detach().numpy(), np.asarray(jtable), atol=2e-5, rtol=2e-5)
    for name, p in net.named_parameters():
        want = want_grads[name]
        np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0, err_msg=name)
    for name, buf in net.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_stats[name], atol=1e-6, rtol=1e-6, err_msg=name)
