"""Registry, builders and weights (counterparts of pillarnext_tpu/utils)."""
