"""Configs and JSON sidecars."""
