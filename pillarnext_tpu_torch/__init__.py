"""PyTorch / CUDA port of pillarnext_tpu: eval and training of the pillar
family (PillarNeXt-B) and of voxel18 (the 3-D voxel reader and the fully
sparse 3-D ResNet).

The JAX package ``pillarnext_tpu`` is the reference; each module here names
its counterpart.  This package imports torch and never jax, flax or any
module of the JAX package.
"""
