"""Tile-based Gaussian rasterizer: hand-written CUDA compositor and binning
kernels, with plain PyTorch versions and backends beside them."""
