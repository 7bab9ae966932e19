"""Tensor ops and the CUDA kernel wrappers (counterparts of pillarnext_tpu/ops)."""
