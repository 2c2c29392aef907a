"""Spans at the port's layer boundaries, recorded only while a
`torch.profiler` records in the process.

`span(name, device=...)` is a context manager.  With no profiler running
it costs one check of the flag the profiler sets for itself
(``torch.autograd.profiler._is_profiler_enabled``) and returns a shared
null context: nothing is allocated, no hook is registered.  With one
running, a span

  - enters a record function of its name (torch's
    ``_RecordFunctionFast``, `record_function`'s C++ core), so it lands in
    the profiler's own trace, on the device trace's clock;
  - where its work runs on a CUDA device, records a timing
    ``torch.cuda.Event`` on that device's current stream at its start and
    at its end.  The time between the two is the span's device interval:
    stream time from the first work issued inside the span to the last,
    with any time the device idled inside it, so a span whose host sets
    the pace reads that pace.  The port issues its work on one stream, so
    the intervals of sibling spans do not overlap.  For work on the CPU
    the host interval stands in for it;
  - keeps a record: its name, the span it opened inside (its parent), its
    host start and end, and its event pair.

The device of a span is the one its caller names (the top-level spans:
``train.step`` takes the Trainer's, ``serve.request`` the Recommender's);
a span opened inside another works on its parent's device, and a
top-level span that names none on the host.

`inner(name)` is a span of a lower layer (a gather, the catalog
product): it records only directly inside a span opened with an `inner`
prefix of its name.  So the gathers (``nn.embedding*``) are recorded in
the one-device train step's forward and the catalog product
(``models.catalog_logits``) in serving's model call, and nowhere else:
not in evaluation, the sparse step, the mesh or the replica fan-out, and
not the gathers of serving's user tower, where the host sets the pace
and a span's own cost would show in it.

`backward_span(out, name)` registers a pre-hook and a post-hook on
``out.grad_fn`` (only while a profiler records), so span `name` covers
exactly that node's backward, on whichever thread autograd runs it and
on the stream autograd gives it.  Its parent is the span open when the
node runs (``train.backward``).

`take()` resolves the events (waiting for each span's end event, which
a caller that has synchronised never does), clears the record and
returns, for each span name: its count, its parents' names, and its
host, device and self device milliseconds (the device milliseconds less
those of the spans whose parent it is).  Memory stays bounded: once
more than `FOLD_AT` closed spans are kept, those whose end event the
device has passed are folded into per-name totals (a count, the
parents, three sums), without waiting on the device, and their events go
back to a pool that later spans record again.

One recorder serves the process, as one profiler does.
"""

from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from typing import Dict

import torch
from torch.autograd import profiler as _profiler

FOLD_AT = 4096  # closed spans kept before the passed ones are folded

NULL = nullcontext()
HOST = -1  # a span's device: the host's work, timed on the host clock


class _Span:
    __slots__ = ("rec", "name", "inner", "device", "parent", "rf", "t0", "t1",
                 "stream", "ev0", "ev1")

    def __init__(self, rec: "Recorder", name: str, inner: str = "", device=None):
        self.rec, self.name, self.inner, self.device = rec, name, inner, device

    def __enter__(self):
        self.rec._enter(self)
        return self

    def __exit__(self, *exc):
        self.rec._exit(self)
        return False


def _index(device) -> int:
    """A CUDA device's index, or HOST."""
    device = torch.device(device)
    if device.type != "cuda":
        return HOST
    return torch.cuda.current_device() if device.index is None else device.index


class Recorder:
    """The process's spans (one profiler runs in a process at a time, and
    the autograd thread's backward spans nest in the caller's)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._open = []  # entered and not left, innermost last
        self._done = []  # closed, not yet folded, in the order they closed
        self._totals: Dict[str, list] = {}
        self._streams = {}  # a current stream's handle -> its Stream
        self._pool = []  # timing events read and free to record again

    # ------------------------------------------------------------ recording

    def span(self, name: str, device=None, inner: str = ""):
        """Span `name` of work on `device` (by default its parent's, or the
        host's); the `inner()` spans whose names start with `inner` record
        directly inside it."""
        if not _profiler._is_profiler_enabled:
            return NULL
        return _Span(self, name, inner, None if device is None else _index(device))

    def inner(self, name: str):
        """Span `name` of a lower layer: recorded only directly inside a
        span opened with an `inner` prefix of `name`."""
        if not _profiler._is_profiler_enabled:
            return NULL
        with self._lock:
            top = self._open[-1] if self._open else None
        if top is None or not top.inner or not name.startswith(top.inner):
            return NULL
        return _Span(self, name)

    def backward_span(self, out: torch.Tensor, name: str) -> None:
        """Span `name` around the backward of the node that made `out`."""
        if not _profiler._is_profiler_enabled or out.grad_fn is None:
            return
        held = []

        def pre(grad_outputs):
            held.append(_Span(self, name).__enter__())

        def post(grad_inputs, grad_outputs):
            held.pop().__exit__(None, None, None)

        out.grad_fn.register_prehook(pre)
        out.grad_fn.register_hook(post)

    def _enter(self, s: _Span) -> None:
        with self._lock:
            parent = self._open[-1] if self._open else None
            self._open.append(s)
        s.parent = None if parent is None else parent.name
        if s.device is None:
            s.device = HOST if parent is None else parent.device
        s.rf = torch._C._profiler._RecordFunctionFast(s.name)
        s.rf.__enter__()
        s.ev0 = s.ev1 = None
        if s.device != HOST:
            s.stream = self._stream(s.device)
            s.ev0 = self._event()
            s.ev0.record(s.stream)
        s.t0 = time.perf_counter_ns()

    def _exit(self, s: _Span) -> None:
        if s.ev0 is not None:
            s.ev1 = self._event()
            s.ev1.record(s.stream)
            s.stream = None
        s.t1 = time.perf_counter_ns()
        s.rf.__exit__(None, None, None)
        s.rf = None
        with self._lock:
            self._open.remove(s)
            self._done.append(s)
            if len(self._done) > FOLD_AT:
                self._fold(wait=False)

    def _event(self) -> torch.cuda.Event:
        return self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)

    def _stream(self, device: int):
        """The device's current stream, its Stream object kept by handle
        (building one costs a span several microseconds)."""
        raw = torch._C._cuda_getCurrentStream(device)
        got = self._streams.get(raw)
        if got is None:
            got = self._streams[raw] = torch.cuda.Stream(
                stream_id=raw[0], device_index=raw[1], device_type=raw[2])
        return got

    # ------------------------------------------------------------- reading

    def _fold(self, wait: bool) -> None:
        """Fold closed spans, oldest first, into the per-name totals
        [count, its parents' names, host ms, device ms, children's device
        ms].  With `wait` every one, else only up to the first whose end
        event the device has not passed (the spans closed in the order
        their end events were recorded, on one stream)."""
        n = 0
        for s in self._done:
            host = 1e-6 * (s.t1 - s.t0)
            if s.ev1 is None:
                dev = host
            else:
                if wait:
                    s.ev1.synchronize()
                elif not s.ev1.query():
                    break
                dev = s.ev0.elapsed_time(s.ev1)
                self._pool += (s.ev0, s.ev1)
            t = self._totals.setdefault(s.name, [0, set(), 0.0, 0.0, 0.0])
            t[0] += 1
            if s.parent is not None:
                t[1].add(s.parent)
                self._totals.setdefault(s.parent, [0, set(), 0.0, 0.0, 0.0])[4] += dev
            t[2] += host
            t[3] += dev
            n += 1
        del self._done[:n]

    def take(self) -> Dict[str, Dict[str, float]]:
        """{name: {count, parents, host_ms, device_ms, self_device_ms}} of
        every span closed since the last take; clears the record."""
        with self._lock:
            self._fold(wait=True)
            totals, self._totals = self._totals, {}
        return {name: {"count": n, "parents": sorted(parents), "host_ms": host,
                       "device_ms": dev, "self_device_ms": dev - child}
                for name, (n, parents, host, dev, child) in totals.items() if n}


RECORDER = Recorder()
span = RECORDER.span
inner = RECORDER.inner
backward_span = RECORDER.backward_span
take = RECORDER.take
