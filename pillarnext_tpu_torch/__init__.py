"""PyTorch / CUDA port of pillarnext_tpu (eval and training of the pillar
family).

The JAX package ``pillarnext_tpu`` is the reference; each module here names
its counterpart.  This package imports torch and never jax, flax or any
module of the JAX package.
"""
