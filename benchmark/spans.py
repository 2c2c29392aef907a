"""The benchmark's door to the port's own spans (`tlsan_tpu_torch/
core/spans.py`): the span table of a traced stretch, taken once a
`Reading` and kept on it.  The port records its spans while the
profiler of `trace.profiled` runs; a span's device milliseconds are the
interval between its two CUDA events on the port's stream, the device's
idle time inside it included.  A checkout whose port records no spans
gives an empty table, and every metric read from it is left out."""

from __future__ import annotations

from typing import Dict, Optional


def table(r) -> Dict[str, Dict[str, float]]:
    """{span name: {count, parents, host_ms, device_ms, self_device_ms}}
    over the traced stretch of `r` (the device is synchronised at its
    end)."""
    got = getattr(r, "spans", None)
    if got is None:
        try:
            from tlsan_tpu_torch.core import spans
        except ImportError:
            got = {}
        else:
            got = spans.take()
        r.spans = got
    return got


def device_ms(r, *names: str) -> Optional[float]:
    """The summed device milliseconds of the named spans, None where any
    of them was not recorded."""
    t = table(r)
    if not all(n in t for n in names):
        return None
    return sum(t[n]["device_ms"] for n in names)


def per_unit(r, ms: Optional[float], metric: str) -> Optional[float]:
    """`ms` over the reading's units (train steps or served batches); None
    with a note where it is None."""
    if ms is None:
        r.notes.append(f"{metric}: the program recorded no such span; left out")
        return None
    return ms / r.units
