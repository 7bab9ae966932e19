"""The port's dense 3-D voxel path vs the JAX package (CPU).

``VoxelFeatureNet(output="dense")`` and ``SparseResNet3D`` on a dense
(B, D, H, W, C) volume (JAX's resnet.py:960-1013), f32, at the
config's 0.2 m over 8 m in z on a 32 x 32 grid (40 x 32 x 32 voxels, the
final depth 2, so the depth-major fold is exercised):

- the reader's volume within 1e-6 relative (the port's sorted segment sum
  against JAX's scatter-add: f32 rounding only), its empty cells exactly
  zero as JAX's;
- the backbone's eval output within ``atol = rtol = 1e-4`` of JAX's
  (both read the same volume);
- one train step of the backbone (batch statistics over every cell of the
  volume, empty ones too; a random cotangent on its output): the output
  within 1e-4, every gradient within 1e-4 of its tensor's largest
  magnitude, the updated running statistics within 1e-5 relative, held
  against JAX's step in float64 on the same numbers.  The statistics of
  the mostly empty volume cancel: JAX's own f32 step lies up to 7e-3 of
  a tensor's largest gradient from its float64 step, the port's f32 step
  within 1.3e-5 (as for the dense-image backbone mode,
  tests/test_torch_port_backbone_modes_train.py);
- JAX's dense tree (auto-named ``Conv_i`` / ``BatchNorm_i``) carries
  through the port's ``export_voxelnext`` with ``strict=True`` onto the
  modules the sparse path reads.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pillarnext_tpu.models.resnet import SparseResNet3D as JaxSparseResNet3D
from pillarnext_tpu.models.voxel_encoder import VoxelFeatureNet as JaxVoxelFeatureNet
from pillarnext_tpu_torch.models.resnet import SparseResNet3D
from pillarnext_tpu_torch.models.voxel_encoder import VoxelFeatureNet
from pillarnext_tpu_torch.utils.torch_import import export_voxelnext
from tests.test_torch_port_head_options import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_port_voxel_backbone import FILTERS, GRIDS, LAYERS, OUT_CH, STRIDES, _randomize, make_points

VOXEL, PC, BEV = GRIDS["config_z_40x32x32"]


@pytest.fixture(scope="module")
def setup():
    pts, mask = make_points(PC, n=800)
    jreader = JaxVoxelFeatureNet(voxel_size=VOXEL, pc_range=PC, output="dense")
    volume = np.asarray(jax.jit(jreader.apply)({}, jnp.asarray(pts), jnp.asarray(mask)))
    jbb = JaxSparseResNet3D(layer_nums=LAYERS, ds_layer_strides=STRIDES, ds_num_filters=FILTERS,
                            num_input_features=5, out_channels=OUT_CH)
    variables = jax.tree.map(np.asarray, _randomize(jax.jit(jbb.init)(jax.random.PRNGKey(0), jnp.asarray(volume))))
    sd = export_voxelnext({"backbone": variables["params"]}, {"backbone": variables["batch_stats"]},
                          layer_nums=LAYERS, ds_layer_strides=STRIDES)
    bb = SparseResNet3D(LAYERS, STRIDES, FILTERS, 5, out_channels=OUT_CH)
    bb.load_state_dict({k[len("backbone."):]: torch.tensor(np.asarray(v)) for k, v in sd.items()}, strict=True)
    return pts, mask, volume, jbb, variables, bb


def _port_tree(params, stats) -> dict:
    sd = export_voxelnext({"backbone": params}, {"backbone": stats}, layer_nums=LAYERS, ds_layer_strides=STRIDES)
    return {k[len("backbone."):]: np.asarray(v, np.float32) for k, v in sd.items()}


def test_dense_voxel_reader_matches_jax(setup):
    pts, mask, volume, *_ = setup
    reader = VoxelFeatureNet(VOXEL, PC, output="dense")
    got = reader(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
    assert got.shape == volume.shape == (2, 40, 32, 32, 5)
    np.testing.assert_array_equal(got == 0, volume == 0)
    np.testing.assert_allclose(got, volume, rtol=1e-6, atol=1e-6)
    assert (volume.any(-1)).sum() > 500


def test_dense_resnet3d_eval_matches_jax(setup):
    _, _, volume, jbb, variables, bb = setup
    want = np.asarray(jax.jit(jbb.apply)(variables, jnp.asarray(volume)))
    with torch.no_grad():
        got = bb.eval()(torch.tensor(volume)).numpy()
    d, h, w = BEV
    assert got.shape == want.shape == (2, h, w, d * OUT_CH)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_dense_resnet3d_train_step_matches_jax(setup):
    _, _, volume, jbb, variables, bb = setup
    d, h, w = BEV
    cot = np.random.default_rng(4).normal(0.0, 1.0, (2, h, w, d * OUT_CH)).astype(np.float32)

    with jax.enable_x64(True):  # JAX's f32 step is the less exact one: see the module docstring
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)

        def f(params):
            out, upd = jbb.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                 jnp.asarray(volume, jnp.float64), train=True, mutable=["batch_stats"])
            return jnp.sum(out * cot.astype(np.float64)), (out, upd["batch_stats"])

        (_, (jout, jstats)), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(v64["params"])
        jout = np.asarray(jout)
        want_grads = _port_tree(jax.tree.map(np.asarray, jgrads), variables["batch_stats"])
        want_stats = _port_tree(variables["params"], jax.tree.map(np.asarray, jstats))

    bb.train()
    out = bb(torch.tensor(volume))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-4, rtol=1e-4)
    for name, p in bb.named_parameters():
        want = want_grads[name]
        np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0, err_msg=name)
    for name, buf in bb.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_stats[name], atol=1e-6, rtol=1e-5, err_msg=name)
