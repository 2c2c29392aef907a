"""The readings that a cell's limits are set from: the checked numbers of
the program's sound runs over many seeds, of the control (the plain
reference computed with TF32 products, one precision below the
configurations' float32) and, for training cells, of the half-batch fault
planted in the reference, over a few, at the cell's own sizes, in one
process.  The benchmark's own runs never run this.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 ... \
        [--control_seeds 7 8 9] [--fault_seeds 7 8 9] [--out readings.jsonl]

Each line of output is {"seed", "side": "program"|"control"|"fault", checks...}.
A limit goes above the program's largest reading and below the
control's smallest (limits/<cell>.json).
"""

import argparse
import json
import sys
import time

import torch

from benchmark import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=())
    ap.add_argument("--control_seeds", type=int, nargs="*", default=())
    ap.add_argument("--fault_seeds", type=int, nargs="*", default=(),
                    help="training cells: the half-batch fault planted in the reference")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    kind = harness.load_module(cell.root / "benchmark" / "kinds" / f"{cell.traffic['kind']}.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    sink = open(args.out, "a") if args.out else None
    runs = [(s, "program", kind.readings) for s in args.seeds]
    runs += [(s, "control", kind.control) for s in args.control_seeds]
    runs += [(s, "fault", kind.fault) for s in args.fault_seeds]
    for seed, side, fn in runs:
        t = time.perf_counter()
        ctx = harness.Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                              device=torch.device("cuda:0"), t0=t)
        line = {"cell": cell.name, "seed": seed, "side": side, **fn(ctx),
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
