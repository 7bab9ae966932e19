"""Every eval stage mode of the port's SparseResNet vs the JAX package (CPU).

One compact table over a clustered active set on a 64 x 64 grid (8 x 8
tiles divide it), B = 2, narrow widths, one block per stage, f32, the same
numpy weights on both sides.  Each mode's backbone output agrees with
JAX's ``SparseResNet`` at ``atol = rtol = 1e-3`` (f32 convolutions
reassociate differently in XLA CPU and ATen), and outside the active set
it is exactly 0 on both sides where the mode masks it:

- ``tile``: the stride-1 prefix over the active-tile stack;
- ``leading+down``: the sparse prefix and the first strided conv sparse;
- ``all``: every stage over compact tables (and ``tile_stride1``);
- ``packed``: ``packed_downsample``, the packed densify and 2x2 down conv;
- ``dense_first``: ``sparse_eval=False``, masked-dense from stage 0;
- ``unmasked``: ``masked_eval=False``, BN constants in empty cells;
- ``dense_image``: strides [2, 2, 2, 1] over a dense (B, H, W, C) image.

The narrowed flagship's detections in the ``tile`` and ``unmasked`` modes
agree with JAX's at the bars of tests/test_torch_port_e2e.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pillarnext_tpu.models.resnet import SparseResNet as JaxSparseResNet
from pillarnext_tpu.ops.sparse_bev import SparseBEV as JaxSparseBEV
from pillarnext_tpu_torch.models.resnet import SparseResNet
from pillarnext_tpu_torch.ops.compact import compactify, invert_slot_map
from pillarnext_tpu_torch.ops.sparse_bev import SparseBEV
from tests.test_torch_port_backbone import _port_state_dict
from tests.test_torch_port_train import random_variables

H = W = 64
B = 2
CAP = 1400
CIN = 16
KW = dict(layer_nums=(1, 1, 1, 1), ds_layer_strides=(1, 2, 2, 2), ds_num_filters=(16, 24, 32, 32),
          num_input_features=CIN, out_channels=32, sparse_eval=True, masked_eval=True)

MODES = {
    "tile": dict(sparse_stages_eval="tile"),
    "leading_down": dict(sparse_stages_eval="leading+down"),
    "all": dict(sparse_stages_eval="all"),
    "all_tile_stride1": dict(sparse_stages_eval="all", tile_stride1=True),
    "packed": dict(packed_downsample=True),
    "dense_first": dict(sparse_eval=False),
    "unmasked": dict(masked_eval=False),
    "dense_image": dict(ds_layer_strides=(2, 2, 2, 1)),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sparse_input(seed=0, b=B, h=H, w=W, cap=CAP, cin=CIN, clusters=8, per_sample=700):
    """A compact table over a clustered active set (about a fifth of the
    grid), in both packages."""
    rng = np.random.default_rng(seed)
    ids = []
    for i in range(b):
        centers = rng.integers(0, h, (clusters, 2))
        yx = centers[rng.integers(0, clusters, per_sample)] + rng.integers(-4, 5, (per_sample, 2))
        ok = (yx >= 0).all(1) & (yx[:, 0] < h) & (yx[:, 1] < w)
        ids.append(i * h * w + yx[ok, 0] * w + yx[ok, 1])
    ids = np.concatenate(ids).astype(np.int32)
    _, _, slot_id, n = compactify(torch.from_numpy(ids), b * h * w, cap)
    assert int(n) <= cap
    sod, valid = invert_slot_map(slot_id, b * h * w)
    feats = rng.standard_normal((cap, cin)).astype(np.float32) * valid.numpy()[:, None]
    table = np.concatenate([feats, np.zeros((1, cin), np.float32)])
    port = SparseBEV(torch.from_numpy(table), valid, sod, slot_id, b, (h, w))
    jx = JaxSparseBEV(
        table=jnp.asarray(table), valid=jnp.asarray(valid.numpy()),
        slot_of_dense=jnp.asarray(sod.numpy()), slot_id=jnp.asarray(slot_id.numpy()),
        batch=b, spatial=(h, w),
    )
    return port, jx


def pair(kw: dict, jx_input, seed: int = 4):
    """(JAX net, numpy variables drawn for its tree's shapes, random BN
    included, the port's net with the same weights)."""
    jnet = JaxSparseResNet(**kw)
    variables = random_variables(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jx_input), seed)
    net = SparseResNet(**kw)
    net.load_state_dict(_port_state_dict(variables["params"], variables["batch_stats"], kw["layer_nums"]),
                        strict=True)
    return jnet, variables, net


def active_out(port: SparseBEV, strides) -> np.ndarray:
    """The output grid's active cells: the occupancy dilated by each
    strided stage."""
    mask = (port.slot_of_dense < port.capacity).reshape(port.batch, 1, *port.spatial).float()
    for s in strides:
        if s > 1:
            mask = F.max_pool2d(mask, 3, s, 1)
    return (mask[:, 0] > 0).numpy()


@pytest.fixture(scope="module")
def inputs():
    return sparse_input(3)


@pytest.mark.parametrize("mode", list(MODES))
def test_sparse_resnet_eval_mode_matches_jax(inputs, mode):
    port, jx = inputs
    kw = {**KW, **MODES[mode]}
    if mode == "dense_image":
        port_in = port.to_dense()
        jx_in = jnp.asarray(port_in.numpy())
    else:
        port_in, jx_in = port, jx
    jnet, variables, net = pair(kw, jx_in)
    want, state = jax.jit(lambda v, x: jnet.apply(v, x, mutable="telemetry"))(variables, jx_in)
    tel_j = {k: int(np.asarray(v[0])) for k, v in state.get("telemetry", {}).items()}
    want = np.asarray(want)
    tel = {}
    with torch.no_grad():
        got = net.eval()(port_in, telemetry=tel).numpy()
    tel = {k: int(v) for k, v in tel.items()}
    assert got.shape == want.shape == (B, H // 8, W // 8, 32)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    assert tel == tel_j, (tel, tel_j)
    if mode in ("tile", "all_tile_stride1"):
        assert any("tiles64_active" in k for k in tel) and all(
            v == 0 for k, v in tel.items() if k.endswith("_overflow"))
    if mode == "dense_image":
        return
    inactive = ~active_out(port, kw["ds_layer_strides"])
    assert inactive.any() and (~inactive).any()
    if mode == "unmasked":
        # BN constants bleed into the empty cells: not the masked output
        assert np.abs(got[inactive]).max() > 1e-3 and np.abs(want[inactive]).max() > 1e-3
        return
    assert np.all(got[inactive] == 0) and np.all(want[inactive] == 0)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("mode", ["all", "leading+down"])
def test_strided_tables_are_sized_from_the_reader_capacity(monkeypatch, mode, train):
    """Each strided table holds ``min(max(int(cap0 * frac), 4096), cells)``
    rows, ``cap0`` the reader's table (resnet.py:757-761, 839-843), on a
    512 x 512 grid where stages 1 and 2 are not capped by their grid."""
    from pillarnext_tpu_torch.models import resnet

    port, _ = sparse_input(6, b=1, h=512, w=512, cap=30000, cin=4, clusters=40, per_sample=3000)
    frac = (1.0, 0.5, 0.3, 0.14)
    net = SparseResNet(layer_nums=(0, 0, 0, 0), ds_layer_strides=(1, 2, 2, 2), ds_num_filters=(4, 4, 4, 4),
                       num_input_features=4, out_channels=4, sparse_eval=True, stage_capacity_frac=frac,
                       sparse_stages_eval=mode, sparse_stages_train=mode).train(train)
    seen = []
    real = resnet.downsample_active_set

    def recording(*args):
        seen.append(args[6])
        return real(*args)

    monkeypatch.setattr(resnet, "downsample_active_set", recording)
    with torch.no_grad():
        net(port)
    cells = [256 * 256, 128 * 128, 64 * 64]
    want = [min(max(int(30000 * f), 4096), n) for f, n in zip(frac[1:], cells)]
    assert want == [15000, 9000, 4096]
    assert seen == (want if mode == "all" else want[:1])
    assert net.table_capacities(30000, 1, (512, 512)) == {f"stage{i + 1}": c for i, c in enumerate(want)}


@pytest.mark.parametrize("override", ["+model.backbone.sparse_stages_eval=tile",
                                      "model.backbone.masked_eval=false"])
def test_flagship_detections_match_jax(override):
    """The narrowed flagship in the mode, JAX predict vs the port's
    AdaptivePredictor, at the e2e test's bars."""
    from pillarnext_tpu.utils import builders as jax_builders
    from pillarnext_tpu.utils.config import load_experiment
    from pillarnext_tpu.utils.synth import lidar_like_points
    from pillarnext_tpu_torch.serving import AdaptivePredictor
    from pillarnext_tpu_torch.utils.builders import build_model
    from pillarnext_tpu_torch.utils.weights import load_jax_variables
    from tests.test_torch_port_e2e import FLAGSHIP, OVERRIDES, PC

    cfg = load_experiment(FLAGSHIP, OVERRIDES + [override])["model"]
    pts, mask = lidar_like_points(2, 3000, PC, seed=0)
    jmodel = jax_builders.build_model(cfg)
    variables = random_variables(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(pts[:1]), jnp.asarray(mask[:1])), 0
    )
    ref = jax.jit(
        lambda v, p, m: jmodel.apply(v, {"points": p, "points_mask": m}, method=jmodel.predict)
    )(variables, jnp.asarray(pts), jnp.asarray(mask))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    model = load_jax_variables(build_model(cfg, device="cpu"), variables)
    got = AdaptivePredictor(model).predict(torch.from_numpy(pts), torch.from_numpy(mask))
    got = {k: v.numpy() for k, v in got.items()}
    assert ref["valid"].sum() >= 8, "vacuous parity: too few detections"
    for i in range(pts.shape[0]):
        o_valid, r_valid = got["valid"][i], ref["valid"][i].astype(bool)
        assert o_valid.sum() == r_valid.sum()
        o_scores, r_scores = got["scores"][i][o_valid], ref["scores"][i][r_valid]
        o_labels, r_labels = got["label_preds"][i][o_valid], ref["label_preds"][i][r_valid]
        o_ord, r_ord = np.lexsort((-o_scores, o_labels)), np.lexsort((-r_scores, r_labels))
        np.testing.assert_array_equal(o_labels[o_ord], r_labels[r_ord])
        np.testing.assert_allclose(o_scores[o_ord], r_scores[r_ord], atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(got["box3d_lidar"][i][o_valid][o_ord], ref["box3d_lidar"][i][r_valid][r_ord],
                                   atol=1e-2, rtol=1e-3)
