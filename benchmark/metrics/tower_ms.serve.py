"""Interval milliseconds a served batch of the user tower: the port's
``serve.logits`` span (the model's ``eval_logits``) less the catalog
product inside it (``models.catalog_logits``).  An interval, not busy
time: where the host sets the pace (TLSAN's tower) it reads the host's
issue of the tower's launches (benchmark/spans.py)."""

from benchmark import spans


def read(r):
    logits = spans.device_ms(r, "serve.logits")
    product = spans.device_ms(r, "models.catalog_logits")
    ms = None if logits is None or product is None else logits - product
    return spans.per_unit(r, ms, "tower_ms.serve")
