"""Interval milliseconds a served batch of the request's host-to-device
copies: the port's ``serve.h2d`` span (a request's), over the batches.
A host-paced interval, not busy time: the host's pads and pageable
copies set it (benchmark/spans.py)."""

from benchmark import spans


def read(r):
    return spans.per_unit(r, spans.device_ms(r, "serve.h2d"), "h2d_ms.serve")
