"""Serving: featurization, top-k recommendation, the HTTP endpoint."""
