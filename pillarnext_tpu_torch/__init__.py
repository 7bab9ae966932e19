"""PyTorch / CUDA port of pillarnext_tpu (eval path of the pillar family).

The JAX package ``pillarnext_tpu`` is the reference; each module here names
its counterpart.  This package imports torch and never jax or flax.
"""
