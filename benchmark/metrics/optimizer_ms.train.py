"""Interval milliseconds a step of the clip and the update: the port's
``train.optimizer`` span around ``opt.step``.  An interval, not busy
time: the device's idle inside it counts (benchmark/spans.py)."""

from benchmark import spans


def read(r):
    return spans.per_unit(r, spans.device_ms(r, "train.optimizer"), "optimizer_ms.train")
