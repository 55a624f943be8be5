"""PixelSplat encoder/decoder as torch nn.Modules."""
