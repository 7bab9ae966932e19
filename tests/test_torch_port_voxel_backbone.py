"""The port's SparseResNet3D eval forward vs the JAX package, on the CPU.

JAX ``VoxelFeatureNet(output="sparse")`` + ``SparseResNet3D`` (its sparse
forward, resnet.py:1015-1144) with randomized parameters and batch
statistics; the port's reader and backbone with the same weights, carried
across by the port's own ``export_voxelnext``.  The BEV agrees at ``atol =
rtol = 1e-3`` (f32 convolutions reassociate differently in XLA CPU and
ATen) and every stage counter is equal.  Two grids: the 32 x 32 x 24 grid
of tests/test_voxel_mirror_parity.py (final depth 1) and the same x/y
with the config's 0.2 m over 8 m in z (40 levels, final depth 2, so the
depth-major fold is exercised); and one case whose stage tables overflow.
Training runs the same sparse forward; a dense volume runs the dense one.
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

LAYERS = (1, 1, 1, 1)
STRIDES = (1, 2, 2, 2)
FILTERS = (8, 12, 16, 16)
OUT_CH = 16
GRIDS = {
    # voxel size, pc range, (D', H', W') of the BEV
    "mirror_24x32x32": ([0.4, 0.4, 0.25], [-6.4, -6.4, -3.0, 6.4, 6.4, 3.0], (1, 4, 4)),
    "config_z_40x32x32": ([0.4, 0.4, 0.2], [-6.4, -6.4, -5.0, 6.4, 6.4, 3.0], (2, 4, 4)),
}


def make_points(pc, b=2, n=600, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.zeros((b, n, 5), np.float32)
    pts[..., :2] = rng.uniform(-6, 6, (b, n, 2))
    pts[..., 2] = rng.uniform(pc[2] + 0.2, pc[5] - 0.2, (b, n))
    pts[..., 3:] = rng.uniform(0, 1, (b, n, 2))
    mask = rng.uniform(size=(b, n)) < 0.9
    return pts, mask


def _randomize(variables, seed=1):
    """Random params and BN statistics, so eval BN is a real transform."""
    rng = np.random.default_rng(seed)

    def rnd(path, x):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if x.ndim == 0:
            return x
        if name.endswith("var"):
            return jnp.asarray(rng.uniform(0.5, 2.0, x.shape).astype(np.float32))
        return jnp.asarray(rng.normal(0, 0.3, x.shape).astype(np.float32))

    return jax.tree_util.tree_map_with_path(rnd, variables)


def _both(grid, capacity, fracs, n_points=600):
    voxel, pc, _ = GRIDS[grid]
    pts, mask = make_points(pc, n=n_points)
    jreader = JaxVoxelFeatureNet(voxel_size=voxel, pc_range=pc, voxel_capacity=capacity,
                                 output="sparse")
    jbb = JaxSparseResNet3D(layer_nums=LAYERS, ds_layer_strides=STRIDES, ds_num_filters=FILTERS,
                            num_input_features=5, out_channels=OUT_CH, stage_capacity_frac=fracs)
    jsb = jax.jit(jreader.apply)({}, jnp.asarray(pts), jnp.asarray(mask))
    variables = _randomize(jax.jit(jbb.init)(jax.random.PRNGKey(0), jsb))
    jbev, jtel = jax.jit(lambda v, sb: jbb.apply(v, sb, mutable="telemetry"))(variables, jsb)

    sd = export_voxelnext({"backbone": variables["params"]}, {"backbone": variables["batch_stats"]},
                          layer_nums=LAYERS, ds_layer_strides=STRIDES)
    reader = VoxelFeatureNet(voxel, pc, voxel_capacity=capacity, output="sparse")
    bb = SparseResNet3D(LAYERS, STRIDES, FILTERS, 5, out_channels=OUT_CH,
                        stage_capacity_frac=fracs).eval()
    bb.load_state_dict({k[len("backbone."):]: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                       strict=True)
    tel = {}
    with torch.inference_mode():
        bev = bb(reader(torch.from_numpy(pts), torch.from_numpy(mask)), telemetry=tel)
    jtel = {k: int(np.asarray(v[0])) for k, v in jtel["telemetry"].items()}
    return bev.numpy(), np.asarray(jbev), {k: int(v) for k, v in tel.items()}, jtel


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_sparse_resnet3d_eval_matches_jax(grid):
    bev, jbev, tel, jtel = _both(grid, 2048, (1.0, 1.45, 0.9, 0.4, 0.26))
    d, h, w = GRIDS[grid][2]
    assert bev.shape == jbev.shape == (2, h, w, d * OUT_CH)
    assert np.abs(jbev).max() > 0, "vacuous parity: an all-zero BEV"
    np.testing.assert_allclose(bev, jbev, atol=1e-3, rtol=1e-3)
    assert tel == jtel
    assert sorted(tel) == ["extra_active", "extra_overflow"] + [
        f"stage{i}_{k}" for i in (1, 2, 3) for k in ("active", "overflow")
    ]


def test_sparse_resnet3d_stage_overflow_counters_match_jax():
    """Tables of 4096 rows (the floor) for more dilated stage-1 sites: the
    stage truncates, on both sides the same way, and says so."""
    bev, jbev, tel, jtel = _both("config_z_40x32x32", 4096, (1.0, 0.01, 0.01, 0.01, 0.01), 3000)
    assert tel == jtel
    assert tel["stage1_overflow"] > 0
    np.testing.assert_allclose(bev, jbev, atol=1e-3, rtol=1e-3)


def test_sparse_resnet3d_train_and_dense_input_raise():
    """Training runs the sparse forward (batch statistics update the
    running ones); a dense volume runs the dense forward (held against JAX
    in tests/test_torch_port_dense3d.py), in train and eval mode; any other
    input raises."""
    voxel, pc, (d, h, w) = GRIDS["config_z_40x32x32"]
    pts, mask = make_points(pc)
    reader = VoxelFeatureNet(voxel, pc, voxel_capacity=2048, output="sparse")
    bb = SparseResNet3D(LAYERS, STRIDES, FILTERS, 5, out_channels=OUT_CH)
    tel = {}
    bev = bb.train()(reader(torch.from_numpy(pts), torch.from_numpy(mask)), telemetry=tel)
    assert bev.shape == (2, h, w, d * OUT_CH) and bev.requires_grad
    assert int(tel["extra_active"]) > 0
    assert not torch.equal(bb.mapping.norm.running_mean, torch.zeros(OUT_CH))
    for mode in (bb.train(), bb.eval()):
        assert mode(torch.zeros(1, 24, 4, 4, 5)).shape == (1, 1, 1, OUT_CH)
        with pytest.raises(TypeError, match="dense"):
            mode(torch.zeros(1, 4, 4, 5))
