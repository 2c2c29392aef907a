"""Embedding lookups, masks and initializers."""
