"""Numpy feature code shared by the offline builders and serving."""
