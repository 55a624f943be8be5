"""Camera trajectories for the video renderer (torch tensors)."""
