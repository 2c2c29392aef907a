"""The traced part of a `--trace 1` run: `torch.profiler` over a steady
stretch that ends in a sync, read from the raw kineto events (building
`key_averages()` takes tens of seconds at these event counts).

`Trace` holds the span (the benchmark's own ``bench.span`` annotation),
the device's kernels and copies inside it, the union of their intervals
(busy time), and the host ops of the span's thread, which name the idle
gaps.  `Reading` is what a per-layer metric's reader
(`metrics/<name>.py`, a ``read(reading)`` that returns a number or None)
gets: the trace, the units (train steps or served batches) it covers with
their valid lengths, the configuration's work counts, the card's peaks and
the program's launch counters over the span.
"""

from __future__ import annotations

import bisect
import glob
import os
import re
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

from benchmark import peaks as peak_table

SPAN = "bench.span"
TOP = 10
_COPY = re.compile(r"^(Memcpy|Memset)")


@contextmanager
def profiled(device):
    """Profile the enclosed work under the ``bench.span`` annotation,
    synchronising the device inside it; yields a holder whose `.prof` is
    the finished profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = type("Profiled", (), {})()
    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync = torch.cuda.synchronize if on_card else (lambda d: None)
    sync(device)
    with profile(activities=activities) as prof:
        with record_function(SPAN):
            yield holder
            sync(device)
    holder.prof = prof


class Trace:
    def __init__(self, prof):
        from torch.autograd import DeviceType

        events = list(prof.profiler.kineto_results.events())
        spans = [e for e in events if e.name() == SPAN and e.device_type() == DeviceType.CPU]
        if not spans:
            raise RuntimeError("the profiler recorded no bench.span annotation")
        span = spans[0]
        self.start, self.end = span.start_ns(), span.start_ns() + span.duration_ns()
        thread = span.start_thread_id()
        self.device: List[tuple] = []  # (name, start, end, is_kernel)
        host = []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                if e.name() == SPAN or e.is_user_annotation():
                    continue
                s, t = max(e.start_ns(), self.start), min(e.start_ns() + e.duration_ns(), self.end)
                if t > s:
                    self.device.append((e.name(), s, t, not _COPY.match(e.name())))
            elif e.start_thread_id() == thread and e.name() != SPAN:
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        self.device.sort(key=lambda d: d[1])
        host.sort()
        self._host = host
        self._host_starts = [h[0] for h in host]
        self.busy = self._union()
        self.window_s = 1e-9 * (self.end - self.start)
        self.busy_s = 1e-9 * sum(t - s for s, t in self.busy)

    @property
    def kernels(self) -> List[tuple]:
        return [d for d in self.device if d[3]]

    def _union(self):
        out = []
        for _, s, t, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    def _host_label(self, at: int) -> str:
        """What the span's thread was in at time `at`: its innermost op,
        with the op around it where the innermost is a runtime call."""
        i = bisect.bisect_right(self._host_starts, at) - 1
        found = []
        for j in range(i, max(i - 4000, -1), -1):
            s, t, name = self._host[j]
            if t >= at:
                found.append(name)
                if len(found) == 2 or not name.startswith("cuda"):
                    break
        if not found:
            return "host outside any op"
        if found[0].startswith("cuda") and len(found) == 2:
            return f"{found[1]} > {found[0]}"
        return found[0]

    def breakdown(self) -> dict:
        """The device ops that took most time and the idle gaps summed by
        what the host was doing, each [[name, seconds], ...] at most 10."""
        ops = defaultdict(float)
        for name, s, t, _ in self.device:
            ops[name[:200]] += 1e-9 * (t - s)
        gaps = defaultdict(float)
        edges = [self.start] + [x for iv in self.busy for x in iv] + [self.end]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps[self._host_label((a + b) // 2)[:200]] += 1e-9 * (b - a)
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


class Reading:
    """What a per-layer metric reads.  `units` is the number of train
    steps or served batches inside the span and `unit_lengths` their valid
    lengths; `work` is `work/<config>.py`; `counters` the program's launch
    counters' increments over the span; `notes` collects why a metric was
    left out."""

    def __init__(self, trace: Trace, kind: str, units: int,
                 unit_lengths: Sequence[Dict], work, config: dict,
                 device_name: str, counters: Dict[str, int]):
        self.trace, self.kind, self.units = trace, kind, units
        self.unit_lengths, self.work, self.config = unit_lengths, work, config
        self.peaks = peak_table.peaks(device_name)
        self.counters = counters
        self.notes: List[str] = []

    @staticmethod
    def patterns(metric_file: str) -> List[re.Pattern]:
        """The kernel-name patterns of a metric: one regular expression a
        line in each `<metric>.d/*.txt` beside its reader."""
        out = []
        for path in sorted(glob.glob(os.path.join(metric_file[:-3] + ".d", "*.txt"))):
            with open(path) as f:
                out += [re.compile(line.strip()) for line in f
                        if line.strip() and not line.startswith("#")]
        return out

    def kernel_time(self, metric_file: str):
        """(launches, device seconds) of the span's kernels whose names
        match the metric's patterns."""
        pats = self.patterns(metric_file)
        hits = [k for k in self.trace.kernels if any(p.search(k[0]) for p in pats)]
        return len(hits), 1e-9 * sum(t - s for _, s, t, _ in hits)

    def flops(self) -> float:
        train = self.kind == "train"
        return sum(self.work.unit_flops(l, self.config, train) for l in self.unit_lengths)

    def mfu(self) -> Optional[float]:
        """The span's operations over the span and the f32 peak, in %."""
        if self.peaks is None:
            self.notes.append("no peaks for this card")
            return None
        return 100.0 * self.flops() / (self.trace.window_s * self.peaks["f32_flops_per_s"])

    def roofline(self, metric_file: str, families: Sequence[str],
                 counters: Sequence[str]) -> Optional[float]:
        """The kernels' bound (work/<config>.py, a call at a time) over
        their summed device time, in %; None where the profiler saw fewer
        launches than the program counted, or none."""
        name = os.path.basename(metric_file)[:-3]
        n, seconds = self.kernel_time(metric_file)
        counted = sum(self.counters.get(c, 0) for c in counters)
        if n == 0 or n < counted or self.peaks is None:
            self.notes.append(f"{name}: the profiler saw {n} launches, the program "
                              f"counted {counted} calls; left out")
            return None
        train = self.kind == "train"
        bound = 0.0
        for lengths in self.unit_lengths:
            calls = self.work.unit_kernels(lengths, self.config, train)
            bound += sum(peak_table.bound_s(b, o, self.peaks)
                         for fam in families for b, o in calls.get(fam, ()))
        return 100.0 * bound / seconds
