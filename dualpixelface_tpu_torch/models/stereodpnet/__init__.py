"""StereoDPNet: the flagship dual-pixel depth and normal model."""
