"""Offline tools: the weights bridge to the JAX parameter tree."""
