"""Checkpoints (training itself comes with a later slice)."""
