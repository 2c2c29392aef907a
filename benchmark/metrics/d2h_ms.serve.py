"""Interval milliseconds a served batch of bringing ids and scores back:
the port's ``serve.d2h`` span (the concatenations and the two copies to
the host, a request's), over the batches.  A host-paced interval, not
busy time: the host waits on each pageable copy (benchmark/spans.py)."""

from benchmark import spans


def read(r):
    return spans.per_unit(r, spans.device_ms(r, "serve.d2h"), "d2h_ms.serve")
