"""Small tensor ops and the Gaussian rasterizer."""
