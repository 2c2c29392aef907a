"""Interval milliseconds a step of autograd's backward: the port's
``train.backward`` span around ``loss.backward()``, the gathers'
backward included.  An interval, not busy time: the device's idle
inside it counts (benchmark/spans.py)."""

from benchmark import spans


def read(r):
    return spans.per_unit(r, spans.device_ms(r, "train.backward"), "backward_ms.train")
