"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic mix and
limits are found by name (benchmark/harness.py); the mix's kind
(`kinds/<kind>.py`) sets up the port `tlsan_tpu_torch` on the card, warms
every shape, measures for `--seconds` (with `--trace 1`, profiles a steady
stretch instead and reads the cell's per-layer metrics from it), then
checks what the timed path produced against the plain reference.  The
last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown with `--trace 1`), and last the
checks, each number with its limit; the same numbers close standard
error.  Without a card, with fewer cards than the cell asks for, or with
JAX loaded, it prints no result and exits non-zero.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool,
             device, t0: float = T0) -> dict:
    """Run the cell on `device` (no look for a card) and build the result
    line; raises on a run that cannot finish."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = cell.root / "benchmark"
    kind = harness.load_module(bench / "kinds" / f"{cell.traffic['kind']}.py")
    ctx = harness.Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                          device=torch.device(device), t0=t0)
    out = kind.run(ctx)
    correct, table = harness.judge(out.checks, cell.limits)
    on_card = ctx.device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(ctx.device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed}
    notes = []
    if trace:
        r = out.reading
        metrics = {}
        for m in cell.per_layer:
            reader = harness.load_module(bench / "metrics" / f"{m['name']}.py")
            value = reader.read(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        notes += r.notes
        line["metrics"] = metrics
        dev.update(busy_s=r.trace.busy_s, window_s=r.trace.window_s)
        line["device"] = dev
        line["breakdown"] = r.trace.breakdown()
    else:
        line["metrics"] = {m["name"]: {"value": out.metrics[m["name"]], "unit": m["unit"]}
                           for m in cell.end_to_end}
        line["device"] = dev
    line["checks"] = table
    line["notes"] = notes
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = harness.jax_loaded()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    notes = line.pop("notes")
    for note in notes:
        print(f"note: {note}", file=sys.stdout)
    if "serve_request_ms_p95" in line["metrics"]:
        print(f"serve_request_ms_p95 over {line['attempted']} requests", file=sys.stdout)
    print(json.dumps(line), flush=True)
    width = max(len(k) for k in line["checks"]) if line["checks"] else 0
    for name, c in line["checks"].items():
        print(f"check {name:<{width}} {c['value']!r:>24} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
