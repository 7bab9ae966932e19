"""The port's CUDA kernels vs their plain versions on the card.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels are built from
``pillarnext_tpu_torch/csrc`` on first use) and skip elsewhere.  Run them on
the card with::

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

(``--noconftest``: the suite's conftest pins JAX to the CPU, and the GPU
machine need not have JAX.)

They cover widths and dtypes the flagship smoke test (chip_smoke.py) does
not: every per-lane channel count of kernel 1, row sizes that are not a
multiple of 16 bytes for kernel 2, odd row counts, narrow and wide
channels, one huge segment and empty input for kernel 3 (and its
gradient), empty inputs and the overflow slot, a narrowed flagship whose
detections on the card must match the CPU's, and one narrowed f32 train
step on the card against the same step on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pillarnext_tpu_torch.ops.gather import monotone_row_gather, monotone_row_gather_plain
from pillarnext_tpu_torch.ops.pfn import pfn_two_layer, pfn_two_layer_plain
from pillarnext_tpu_torch.ops.segscan import (
    pillar_max_broadcast,
    sorted_segment_bcast,
    sorted_segment_bcast_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _pfn_inputs(device, n, cap, df, c0, c1, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    slot = torch.sort(torch.randint(0, cap + 1, (n,), generator=g)).values.to(torch.int32)
    feats = (torch.randn(n, df, generator=g) * 5).to(dtype)
    w0 = torch.randn(df, c0, generator=g) / df**0.5
    w1 = torch.randn(2 * c0, c1, generator=g) / (2 * c0) ** 0.5
    bn0 = torch.stack([torch.rand(c0, generator=g) + 0.5, 0.2 * torch.randn(c0, generator=g)])
    bn1 = torch.stack([torch.rand(c1, generator=g) + 0.5, 0.2 * torch.randn(c1, generator=g)])
    return [t.to(device) for t in (feats, slot, w0, bn0, w1, bn1)]


@pytest.mark.parametrize("c0,c1", [(8, 16), (32, 64), (48, 96), (64, 128), (17, 33)])
def test_pfn_two_layer_f32(device, c0, c1):
    args = _pfn_inputs(device, 5000, 1500, 10, c0, c1, torch.float32, seed=c0 + c1)
    before = pfn_two_layer.launches
    got = pfn_two_layer(*args, 1500)
    want = pfn_two_layer_plain(*args, 1500)
    torch.cuda.synchronize()
    assert pfn_two_layer.launches == before + 1
    assert got.shape == (1501, c1)
    assert torch.equal((got == 0).all(1), (want == 0).all(1))
    assert torch.all(got[-1] == 0)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_pfn_two_layer_bf16_and_overflow(device):
    # slots drawn up to cap: the dump slot cap collects points and stays 0
    args = _pfn_inputs(device, 8000, 700, 13, 32, 64, torch.bfloat16, seed=3)
    got = pfn_two_layer(*args, 700)
    want = pfn_two_layer_plain(*args, 700)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.all(got[-1] == 0)
    a, b = got.float(), want.float()
    hi = torch.maximum(a.abs(), b.abs()).clamp(min=2.0**-9)
    ulps = (a - b).abs() / torch.exp2(torch.floor(torch.log2(hi)) - 7)
    assert float(ulps.max()) <= 1.0


def test_pfn_two_layer_rejects_bad_input(device):
    feats, slot, w0, bn0, w1, bn1 = _pfn_inputs(device, 100, 50, 10, 8, 16, torch.float32, seed=4)
    with pytest.raises(ValueError):
        pfn_two_layer(feats.half(), slot, w0, bn0, w1, bn1, 50)
    with pytest.raises(ValueError):
        pfn_two_layer(feats.t(), slot, w0, bn0, w1, bn1, 50)
    with pytest.raises(RuntimeError):  # c0 > 64 is outside the kernel's widths
        big = _pfn_inputs(device, 100, 50, 10, 80, 16, torch.float32, seed=5)
        pfn_two_layer(*big, 50)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,r,c", [(100_000, 3000, 64), (5000, 70, 3), (4097, 1, 5), (0, 10, 8)])
def test_row_gather_bit_exact(device, dtype, m, r, c):
    rng = np.random.default_rng(m + r + c)
    table = torch.from_numpy(rng.standard_normal((r, c)).astype(np.float32)).to(device, dtype)
    idx = torch.from_numpy(rng.integers(-3, r + 3, m).astype(np.int32)).to(device)
    before = monotone_row_gather.launches
    got = monotone_row_gather(table, idx)
    want = monotone_row_gather_plain(table, idx)
    torch.cuda.synchronize()
    assert monotone_row_gather.launches == before + (1 if m else 0)
    assert got.shape == (m, c) and got.dtype == dtype
    assert torch.equal(got, want)


def test_row_gather_rejects_bad_input(device):
    table = torch.zeros(10, 8, device=device)
    with pytest.raises(ValueError):
        monotone_row_gather(table, torch.zeros(5, dtype=torch.int64, device=device))
    with pytest.raises(ValueError):
        monotone_row_gather(table.half(), torch.zeros(5, dtype=torch.int32, device=device))


def test_small_flagship_gpu_matches_cpu(device):
    """The narrowed flagship (tests/test_torch_port_e2e.py's config, f32)
    gives the same detections on the card, through both kernels, as on the
    CPU, at the bars of tests/test_detection_parity.py."""
    from pathlib import Path

    from pillarnext_tpu_torch.utils.builders import build_model
    from pillarnext_tpu_torch.utils.config import load_experiment
    from pillarnext_tpu_torch.utils.synth import lidar_like_points

    torch.backends.cudnn.allow_tf32 = False
    pc = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
    flagship = (
        Path(__file__).resolve().parent.parent
        / "pillarnext_tpu/configs/experiments/nusc_det_pp18_aspp_iou_sp.yaml"
    )
    cfg = load_experiment(flagship, [
        f"model.reader.pc_range={pc}", "model.reader.voxel_size=[0.25,0.25,8.0]",
        "model.reader.num_filters=[16,16]", "model.reader.pillar_capacity=4096",
        "model.backbone.ds_num_filters=[16,32,32,32]", "model.backbone.num_input_features=16",
        "+model.backbone.out_channels=32", "model.neck.in_channels=32",
        "model.head.in_channels=32", "+model.head.share_conv_channel=32", "model.dtype=float32",
    ])["model"]
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    pts, mask = lidar_like_points(2, 3000, pc, seed=0)
    pts, mask = torch.from_numpy(pts), torch.from_numpy(mask)
    with torch.inference_mode():
        want = model.predict(pts, mask)
        launches = (pfn_two_layer.launches, monotone_row_gather.launches)
        got = model.to(device).predict(pts.to(device), mask.to(device))
    assert pfn_two_layer.launches > launches[0]
    assert monotone_row_gather.launches > launches[1]
    got = {k: v.cpu() for k, v in got.items()}
    assert int(want["valid"].sum()) >= 8
    for i in range(2):
        gv, wv = got["valid"][i], want["valid"][i]
        assert int(gv.sum()) == int(wv.sum())
        gs, ws = got["scores"][i][gv], want["scores"][i][wv]
        gl, wl = got["label_preds"][i][gv], want["label_preds"][i][wv]
        go = np.lexsort((-gs.numpy(), gl.numpy()))
        wo = np.lexsort((-ws.numpy(), wl.numpy()))
        np.testing.assert_array_equal(gl.numpy()[go], wl.numpy()[wo])
        np.testing.assert_allclose(gs.numpy()[go], ws.numpy()[wo], atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(
            got["box3d_lidar"][i][gv].numpy()[go], want["box3d_lidar"][i][wv].numpy()[wo],
            atol=2e-2, rtol=1e-3,
        )


def _sorted_segments(n, huge, seed):
    """Sorted int32 segment ids: runs of ~5 rows, the last ``huge`` rows
    one segment (the dump slot of masked points)."""
    g = torch.Generator().manual_seed(seed)
    real = n - huge
    seg = torch.sort(torch.randint(0, max(real // 5, 1), (real,), generator=g)).values
    return torch.cat([seg, torch.full((huge,), max(real // 5, 1) + 3)]).to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reduce", ["max", "sum"])
@pytest.mark.parametrize("n,c,huge", [(1, 3, 0), (257, 32, 0), (4097, 64, 3000), (100_003, 32, 60_000),
                                      (70_001, 3, 20)])
def test_sorted_segment_bcast_matches_plain(device, dtype, reduce, n, c, huge):
    seg = _sorted_segments(n, huge, seed=n + c).to(device)
    g = torch.Generator().manual_seed(c)
    x = (torch.randn(n, c, generator=g) * 3).to(device, dtype)
    before = sorted_segment_bcast.launches
    got = sorted_segment_bcast(x, seg, reduce)
    want = sorted_segment_bcast_plain(x, seg, reduce)
    torch.cuda.synchronize()
    assert sorted_segment_bcast.launches == before + 1
    assert got.shape == (n, c) and got.dtype == dtype
    if reduce == "max":
        assert torch.equal(got, want)
        return
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        # f32 sums in another order: within 1e-5 of the segment's sum of |x|
        mag = sorted_segment_bcast_plain(x.abs(), seg, "sum")
        assert bool((err <= 1e-5 * mag).all())
    else:
        a, b = got.float(), want.float()
        hi = torch.maximum(a.abs(), b.abs()).clamp(min=2.0**-9)
        assert float(((a - b).abs() / torch.exp2(torch.floor(torch.log2(hi)) - 7)).max()) <= 1.0


def test_sorted_segment_bcast_empty_and_bad_input(device):
    empty = torch.zeros((0, 8), device=device)
    before = sorted_segment_bcast.launches
    out = sorted_segment_bcast(empty, torch.zeros((0,), dtype=torch.int32, device=device), "max")
    assert out.shape == (0, 8) and sorted_segment_bcast.launches == before
    x = torch.zeros(10, 4, device=device)
    with pytest.raises(ValueError):
        sorted_segment_bcast(x, torch.zeros(10, dtype=torch.int64, device=device), "max")
    with pytest.raises(ValueError):
        sorted_segment_bcast(x.half(), torch.zeros(10, dtype=torch.int32, device=device), "max")
    with pytest.raises(ValueError):
        sorted_segment_bcast(x, torch.zeros(10, dtype=torch.int32, device=device), "min")


def test_pillar_max_broadcast_gradient_matches_plain(device):
    seg = _sorted_segments(50_000, 20_000, seed=7).to(device)
    g = torch.Generator().manual_seed(8)
    x = torch.relu(torch.randn(50_000, 32, generator=g)).to(device).requires_grad_()
    cot = torch.randn(50_000, 32, generator=g).to(device)
    out = pillar_max_broadcast(x, seg)
    out.backward(cot)
    got = x.grad.clone()
    x.grad = None
    want_out = pillar_max_broadcast(x, seg, plain=True)
    want_out.backward(cot)
    assert torch.equal(out, want_out)
    torch.testing.assert_close(got, x.grad, atol=1e-5 * float(x.grad.abs().max()), rtol=1e-5)


def test_small_flagship_train_step_gpu_matches_cpu(device):
    """One f32 train step of the narrowed flagship on the card (kernels 2
    and 3) and on the CPU (plain versions): same loss to 1e-5, same
    telemetry, and the step went through both kernels."""
    from pathlib import Path

    from pillarnext_tpu_torch.data.synthetic import synthetic_batches
    from pillarnext_tpu_torch.train.train_state import train_step
    from pillarnext_tpu_torch.train.trainer import batch_to_device
    from pillarnext_tpu_torch.utils.builders import build_model, build_optimizer
    from pillarnext_tpu_torch.utils.config import load_experiment

    torch.backends.cudnn.allow_tf32 = False
    pc = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
    flagship = (
        Path(__file__).resolve().parent.parent
        / "pillarnext_tpu/configs/experiments/nusc_det_pp18_aspp_iou_sp.yaml"
    )
    cfg = load_experiment(flagship, [
        f"model.reader.pc_range={pc}", "model.reader.voxel_size=[0.25,0.25,8.0]",
        "model.reader.num_filters=[16,16]", "model.reader.pillar_capacity=4096",
        "model.backbone.ds_num_filters=[16,32,32,32]", "model.backbone.num_input_features=16",
        "+model.backbone.out_channels=32", "model.neck.in_channels=32",
        "model.head.in_channels=32", "+model.head.share_conv_channel=32", "model.dtype=float32",
    ])
    batch = synthetic_batches(cfg, 1, 2, 3000, seed=1, n_objects=4, max_points=4000)[0]
    results = {}
    for dev in ("cpu", device):
        model = build_model(cfg["model"], device=dev, generator=torch.Generator().manual_seed(0), train=True)
        opt, _ = build_optimizer(cfg, 10, list(model.parameters()))
        launches = (monotone_row_gather.launches, sorted_segment_bcast.launches)
        scalars, _ = train_step(model, opt, batch_to_device(batch, dev))
        results[str(dev)] = (
            float(scalars["loss"]),
            {k: int(v) for k, v in scalars["telemetry"].items()},
            (monotone_row_gather.launches - launches[0], sorted_segment_bcast.launches - launches[1]),
        )
    cpu, gpu = results["cpu"], results[str(device)]
    assert gpu[0] == pytest.approx(cpu[0], rel=1e-5)
    assert gpu[1] == cpu[1]
    assert cpu[2] == (0, 0) and gpu[2][0] > 0 and gpu[2][1] > 0
