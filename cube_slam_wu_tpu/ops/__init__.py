"""Vectorized image / line / proposal tensor ops (the accelerator compute path)."""
