"""Interval milliseconds a step of the embedding gathers' backward: every
``<gather>.bwd`` span the port records around a gather's backward node
(`nn/embedding.py::lookup`), summed.  Intervals, not busy time: the
device's idle inside them, while autograd's thread issues the next
node, counts (benchmark/spans.py)."""

from benchmark import spans


def read(r):
    names = [n for n in spans.table(r) if n.endswith(".bwd")]
    ms = spans.device_ms(r, *names) if names else None
    return spans.per_unit(r, ms, "gather_bwd_ms.train")
