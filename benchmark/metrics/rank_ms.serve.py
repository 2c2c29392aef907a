"""Interval milliseconds a served batch of ranking the catalog: the port's
``models.catalog_logits`` (product and bias), ``serve.exclusion`` (the
padding and history masks) and ``serve.topk`` spans.  Intervals, not
busy time: the host's pace in the exclusion counts (benchmark/spans.py)."""

from benchmark import spans


def read(r):
    ms = spans.device_ms(r, "models.catalog_logits", "serve.exclusion", "serve.topk")
    return spans.per_unit(r, ms, "rank_ms.serve")
