"""Two-layer PFN over pillar-sorted points into the compact table — kernel 1.

Counterpart of ``fused_pfn_two_layer`` / ``pfn_table_fused``
(pillarnext_tpu/ops/pallas_pfn.py:93, :264).  Both versions here compute

    v0  = relu(round_dt((x @ W0) * inv0 + shift0))        per point
    m0  = max over the pillar of v0
    v1  = relu(round_dt(([v0, m0] @ W1) * inv1 + shift1)) per point
    out = max over the pillar of v1                        (cap + 1, c1)

with ``x`` and the weights rounded to the compute type ``dt`` and every
dot product accumulated in f32 — one rounding after the folded BN, as the
TPU kernel does.  Row ``cap`` (the dump slot) and empty slots are 0.
"""

from __future__ import annotations

import ctypes

import torch

from pillarnext_tpu_torch.ops import kernels
from pillarnext_tpu_torch.ops.scatter import segment_max

FLOAT_TYPES = (torch.float32, torch.bfloat16)


def _round_params(dt, w0, bn0, w1, bn1):
    return tuple(t.to(dt).float().contiguous() for t in (w0, bn0, w1, bn1))


def pfn_two_layer_plain(feats, slot, w0, bn0, w1, bn1, cap: int) -> torch.Tensor:
    """``index_select`` + ``scatter_reduce("amax")`` + matmul version.

    Args:
        feats: (N, df) decorated features in the compute dtype, sorted by slot.
        slot: (N,) ascending compact slot per point; ``cap`` = dump.
        w0: (df, c0); bn0: (2, c0) rows (inv, shift); w1: (2 * c0, c1);
            bn1: (2, c1).
        cap: table capacity.
    """
    dt = feats.dtype
    w0, bn0, w1, bn1 = _round_params(dt, w0, bn0, w1, bn1)
    seg = slot.long()
    v0 = ((feats.float() @ w0) * bn0[0] + bn0[1]).to(dt).relu()
    m0 = segment_max(v0, seg, cap + 1)
    x1 = torch.cat([v0, m0.index_select(0, seg)], dim=1).float()
    v1 = ((x1 @ w1) * bn1[0] + bn1[1]).to(dt).relu()
    out = segment_max(v1, seg, cap + 1)
    out[cap] = 0
    return out


def pfn_two_layer(feats, slot, w0, bn0, w1, bn1, cap: int) -> torch.Tensor:
    """The same function; CPU tensors take the plain version, CUDA tensors
    launch ``csrc/pfn.cu``, which rounds the weights to the compute type
    itself.  Weights that are already f32, contiguous and on the features'
    device (``pfn_kernel_params``) go to the kernel without a copy."""
    if feats.device.type == "cpu":
        return pfn_two_layer_plain(feats, slot, w0, bn0, w1, bn1, cap)
    kernels.check_cuda_tensor(feats, "feats", FLOAT_TYPES, ndim=2)
    kernels.check_cuda_tensor(slot, "slot", (torch.int32,), ndim=1)
    if slot.device != feats.device or slot.shape[0] != feats.shape[0]:
        raise ValueError("slot must be an (N,) tensor on the features' device")
    n, df = feats.shape
    c0 = w0.shape[1]
    c1 = w1.shape[1]
    if w0.shape[0] != df or w1.shape[0] != 2 * c0 or bn0.shape != (2, c0) or bn1.shape != (2, c1):
        raise ValueError(
            f"weight shapes {tuple(w0.shape)} {tuple(bn0.shape)} "
            f"{tuple(w1.shape)} {tuple(bn1.shape)} do not fit df={df}"
        )
    w0, bn0, w1, bn1 = pfn_kernel_params(w0, bn0, w1, bn1, feats.device)
    if feats.data_ptr() % 16:
        raise ValueError("feats must be 16-byte aligned (the kernel stages rows with 16-byte copies)")
    dt = feats.dtype
    out = torch.empty((cap + 1, c1), dtype=dt, device=feats.device)
    kernels.launch(
        "pnx_pfn_two_layer", feats.data_ptr(), slot.data_ptr(), w0.data_ptr(),
        bn0.data_ptr(), w1.data_ptr(), bn1.data_ptr(), out.data_ptr(),
        n, cap, df, c0, c1, 0 if dt == torch.float32 else 1,
    )
    pfn_two_layer.launches += 1
    return out


def pfn_kernel_params(w0, bn0, w1, bn1, device) -> tuple[torch.Tensor, ...]:
    """The four parameters as the kernel takes them: f32, contiguous, on
    ``device`` (a no-op for tensors that already are)."""
    return tuple(t.to(device=device, dtype=torch.float32).contiguous() for t in (w0, bn0, w1, bn1))


def pfn_launch_shape(c0: int, c1: int, dtype: torch.dtype) -> dict:
    """Kernel 1's dynamic shared memory per block and resident blocks per
    SM on the current CUDA device (needs the card)."""
    smem, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    err = kernels.entry("pnx_pfn_launch_shape")(
        c0, c1, 0 if dtype == torch.float32 else 1, ctypes.byref(smem), ctypes.byref(per_sm)
    )
    if err != 0:
        raise RuntimeError(f"pnx_pfn_launch_shape failed with error code {err}")
    return {"smem_bytes": smem.value, "blocks_per_sm": per_sm.value}


pfn_two_layer.launches = 0
