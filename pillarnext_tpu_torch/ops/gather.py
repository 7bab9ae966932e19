"""Row gather with zero rows for out-of-range indices — kernel 2.

Counterpart of ``monotone_row_gather`` (pillarnext_tpu/ops/pallas_gather.py:60).
The TPU kernel required index streams whose real entries ascend within a
window; the CUDA kernel (``csrc/gather.cu``) is exact for any index stream,
so the name is kept only so a reader finds the counterpart.
"""

from __future__ import annotations

import torch

from pillarnext_tpu_torch.ops import kernels

FLOAT_TYPES = (torch.float32, torch.bfloat16)


def monotone_row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = table[idx[i]]`` for ``0 <= idx[i] < R``, else a zero row —
    ``index_select`` on the table padded with one zero row."""
    r, c = table.shape
    padded = torch.cat([table, table.new_zeros((1, c))], dim=0)
    safe = torch.where((idx >= 0) & (idx < r), idx, r)
    return padded.index_select(0, safe.reshape(-1).long())


def monotone_row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(R, C) f32/bf16 table, (M,) int32 indices -> (M, C).  A CPU table
    takes the plain version; a CUDA table launches the kernel."""
    if table.device.type == "cpu":
        return monotone_row_gather_plain(table, idx)
    kernels.check_cuda_tensor(table, "table", FLOAT_TYPES, ndim=2)
    kernels.check_cuda_tensor(idx, "idx", (torch.int32,), ndim=1)
    if idx.device != table.device:
        raise ValueError("table and idx must be on the same device")
    r, c = table.shape
    m = idx.shape[0]
    out = torch.empty((m, c), dtype=table.dtype, device=table.device)
    if m == 0:
        return out
    kernels.launch(
        "pnx_row_gather", table.data_ptr(), idx.data_ptr(), out.data_ptr(),
        m, r, c * table.element_size(),
    )
    monotone_row_gather.launches += 1
    return out


monotone_row_gather.launches = 0
