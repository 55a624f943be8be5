"""Tile-based Gaussian rasterizer with a hand-written CUDA compositor."""
