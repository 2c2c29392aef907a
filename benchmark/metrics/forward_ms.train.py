"""Interval milliseconds a step of the model's forward: the port's
``train.forward`` span (the loss, the gathers included).  An interval
between CUDA events, not busy time: the device's idle inside the span
counts, so where the host sets the pace it reads the host's pace
(benchmark/spans.py)."""

from benchmark import spans


def read(r):
    return spans.per_unit(r, spans.device_ms(r, "train.forward"), "forward_ms.train")
