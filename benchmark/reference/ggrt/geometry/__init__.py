"""Camera and ray geometry on torch tensors."""
