"""The eval reader's kept kernel-1 parameters follow the module, on the CPU.

``PillarFeatureNet.pfn_params`` keeps the folded PFN parameters between
calls (kernel 1 takes them as they are).  After ``load_state_dict`` with
other weights, and after an in-place change of a weight or of a BN
statistic, the reader's table must equal that of a freshly built reader
with the same weights exactly, and the JAX ``PillarFeatureNet`` given the
same numpy weights at the tolerance of tests/test_torch_port_reader.py
(``atol = rtol = 2e-5``, zero rows exactly equal).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pillarnext_tpu.models.pillar_encoder import PillarFeatureNet as JaxPFN
from tests.test_torch_port_reader import PC, VS, _points, _port_reader, _random_bn
from tests.torch_threads import one_torch_thread  # noqa: F401

CAPACITY = 4096


def _jax_net():
    return JaxPFN(
        num_input_features=5, num_filters=(16, 16), voxel_size=VS, pc_range=PC,
        pillar_capacity=CAPACITY, dtype=None, output="sparse",
    )


def _variables(jnet, pts, mask, seed):
    """Random Dense kernels and BN parameters and statistics from ``seed``."""
    v = _random_bn(jnet.init(jax.random.PRNGKey(seed), jnp.asarray(pts), jnp.asarray(mask)), seed)
    rng = np.random.default_rng(seed + 100)
    for i in range(2):
        k = v["params"][f"pfn_layers_{i}"]["Dense_0"]["kernel"]
        v["params"][f"pfn_layers_{i}"]["Dense_0"]["kernel"] = (
            k * rng.uniform(0.5, 2.0, k.shape)
        ).astype(np.float32)
    return v


def _from_port(jvars, net):
    """``jvars`` with the port reader's current weights, as numpy."""
    v = jax.tree.map(np.array, jvars)
    for i in range(2):
        layer = net.pfn_layers[i]
        p = v["params"][f"pfn_layers_{i}"]
        s = v["batch_stats"][f"pfn_layers_{i}"]
        p["Dense_0"]["kernel"] = layer.linear.weight.detach().numpy().T.copy()
        p["MaskedBatchNorm_0"]["scale"] = layer.norm.weight.detach().numpy().copy()
        p["MaskedBatchNorm_0"]["bias"] = layer.norm.bias.detach().numpy().copy()
        s["MaskedBatchNorm_0"]["mean"] = layer.norm.running_mean.numpy().copy()
        s["MaskedBatchNorm_0"]["var"] = layer.norm.running_var.numpy().copy()
    return v


def _table(net, pts, mask):
    with torch.no_grad():
        return net(torch.from_numpy(pts), torch.from_numpy(mask)).table.numpy()


def _change(net, how, jnet, pts, mask):
    with torch.no_grad():
        if how == "load_state_dict":
            other = _port_reader(_variables(jnet, pts, mask, seed=7), CAPACITY)
            net.load_state_dict(other.state_dict())
        elif how == "inplace_weight":
            net.pfn_layers[1].linear.weight.mul_(1.5)
        elif how == "inplace_bn_statistic":
            net.pfn_layers[0].norm.running_var.add_(0.25)


@pytest.mark.parametrize("how", ["load_state_dict", "inplace_weight", "inplace_bn_statistic"])
def test_kept_pfn_params_follow_the_weights(how):
    pts, mask = _points(2, 3000, seed=3)
    jnet = _jax_net()
    variables = _variables(jnet, pts, mask, seed=1)
    net = _port_reader(variables, CAPACITY)
    before = _table(net, pts, mask)

    _change(net, how, jnet, pts, mask)
    got = _table(net, pts, mask)
    jvars = _from_port(variables, net)
    fresh = _table(_port_reader(jvars, CAPACITY), pts, mask)
    np.testing.assert_array_equal(got, fresh)
    assert not np.array_equal(got, before)

    want = np.asarray(jnet.apply(jvars, jnp.asarray(pts), jnp.asarray(mask)).table, np.float32)
    np.testing.assert_array_equal(np.abs(got).sum(-1) == 0, np.abs(want).sum(-1) == 0)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_kept_pfn_params_are_reused():
    """Unchanged weights: the second call takes the same tensors, built once."""
    pts, mask = _points(1, 2000, seed=4)
    net = _port_reader(_variables(_jax_net(), pts, mask, seed=2), CAPACITY)
    _table(net, pts, mask)
    kept = net.pfn_params(torch.device("cpu"))
    _table(net, pts, mask)
    again = net.pfn_params(torch.device("cpu"))
    assert all(a is b for a, b in zip(kept, again))
    w0, bn0, w1, bn1 = kept
    assert w0.shape == (10, 8) and w1.shape == (16, 16) and bn0.shape == (2, 8) and bn1.shape == (2, 16)
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in kept)
