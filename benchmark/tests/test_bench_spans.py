"""The per-layer metrics read from the port's own spans (`benchmark/
spans.py`, `metrics/*` with ``"source": "program_span"``), on the CPU: a
traced run of each tiny cell prints every one that applies to it, the
phases account for the steps, and a port that records no spans gives no
such metric and no error."""

import json
import math
import sys

import pytest

from benchmark import harness, run
from benchmark import spans as bench_spans
from benchmark.tests.test_bench_runs import CELLS, REPO

SPAN_METRICS = [m for m in json.loads((REPO / "BENCHMARK.json").read_text())["per_layer"]
                if m["source"] == "program_span"]


def _traced(root, cell):
    return run.run_cell(harness.find_cell(cell, root), 2**31 + 11, 0.2, True, "cpu")


def test_every_span_metric_applies_to_its_cells():
    """Each span metric lists its cells, and each of them reports the
    end-to-end metric the span metric moves."""
    assert SPAN_METRICS
    for m in SPAN_METRICS:
        assert m["workloads"], m["name"]
        for name in m["workloads"]:
            cell = harness.find_cell(name, REPO)
            assert m in cell.per_layer, (m["name"], name)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}, (m["name"], name)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_tiny_cell_prints_its_span_metrics(tiny_root, cell):
    line = _traced(tiny_root, cell)
    assert line["correct"], line["checks"]
    want = {m["name"] for m in harness.find_cell(cell, tiny_root).per_layer
            if m["source"] == "program_span"}
    assert want
    for name in want:
        value = line["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0.0, (name, value)
    if cell.split(".")[1] == "train":
        # a step's phases, read on the CPU's host clock
        steps = sum(line["metrics"][f"{p}_ms.train"]["value"]
                    for p in ("forward", "backward", "optimizer"))
        assert line["metrics"]["gather_bwd_ms.train"]["value"] < steps
        assert 1e3 * line["device"]["window_s"] / steps > 3 - 1e-9  # 3 steps traced


def test_a_port_without_spans_gives_no_span_metric(monkeypatch):
    """The parent commit's port has no `core/spans.py`: the readers leave
    their metrics out with a note and raise nothing."""
    monkeypatch.setitem(sys.modules, "tlsan_tpu_torch.core.spans", None)
    reading = type("Reading", (), {"units": 4})()
    reading.notes = []
    assert bench_spans.table(reading) == {}
    for m in SPAN_METRICS:
        reader = harness.load_module(REPO / "benchmark" / "metrics" / f"{m['name']}.py")
        assert reader.read(reading) is None
    assert len(reading.notes) == len(SPAN_METRICS)
