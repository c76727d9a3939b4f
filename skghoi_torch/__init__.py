"""PyTorch/CUDA port of skghoi_tpu: the SCG HOI network for NVIDIA Hopper.

The JAX package ``skghoi_tpu`` is the reference; this package imports none
of it.  See README.md, section "PyTorch port".
"""
