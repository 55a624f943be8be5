"""PyTorch port of ggrt_official_tpu for NVIDIA Hopper GPUs.

The JAX package stays the reference; this package imports torch and never
jax, and nothing from ggrt_official_tpu.
"""
