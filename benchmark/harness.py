"""Finding a cell's files by name, and what every run shares: the context
a kind's driver gets, the comparison of each checked number with its
limit, the look for JAX, and the result line.

Everything belonging to one configuration, traffic mix, cell or metric is
a file of its own that this module finds by the name in BENCHMARK.json:

  configs/<config>.json     widths, catalog, optimizer, precision
  traffic/<mix>.json        the kind (kinds/<kind>.py) and its parameters
  limits/<cell>.json        the limit of each number `correct` compares
  work/<config>.py          operations and bytes from valid lengths
  reference/<family>.py     the plain PyTorch reference
  metrics/<metric>.py       a per-layer metric's reader (+ <metric>.d/)
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

from benchmark import data

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tlsan_tpu")
LENGTHS = ("sl", "sl_new")  # the valid-length fields work/<config>.py reads


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: Optional[str] = None):
    """Import a file by its path (names may hold '.' and '-')."""
    spec = importlib.util.spec_from_file_location(
        name or "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(family: str):
    """`reference/<family>.py`, imported as a module of this package."""
    import importlib
    return importlib.import_module(f"benchmark.reference.{family}")


@dataclass
class Cell:
    """One entry of `workloads` with everything found by its names."""

    name: str
    chips: int
    config: dict
    config_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: list
    per_layer: list
    root: Path

    @property
    def work(self):
        return load_module(self.root / "benchmark" / "work" / f"{self.config_name}.py")

    @property
    def family(self) -> str:
        return self.config["family"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = BENCH.parent) -> Cell:
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r}; one of {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    return Cell(name=name, chips=w["chips"], config=data.sized(load_json(root / conf["file"])),
                config_name=w["config"],
                traffic=load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(root / "benchmark" / "limits" / f"{name}.json"),
                end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in manifest["per_layer"] if _applies(m, name)],
                root=root)


@dataclass
class Context:
    """What a kind's driver (`kinds/<kind>.py::run`) is given."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t0: float  # perf_counter at the process's start


@dataclass
class Outcome:
    """What a driver returns: its end-to-end readings (or the Reading of
    the traced span), the checked numbers, and the run's counts."""

    metrics: Dict[str, float] = field(default_factory=dict)
    checks: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    reading: object = None


def judge(checks: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and finite; a number with no limit fails."""
    table, ok = {}, True
    for name, value in checks.items():
        limit = limits.get(name)
        if limit is None or not math.isfinite(value) or value > limit:
            ok = False
        # JSON has no infinity: a number that is not finite reads 1e308
        table[name] = {"value": value if math.isfinite(value) else 1e308,
                       "limit": limit}
    return ok, table


def jax_loaded():
    """The loaded modules whose top-level name is JAX's or its package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def seed_bits(seed: int) -> int:
    """A non-negative seed for numpy and torch from any whole number."""
    return seed & ((1 << 63) - 1)


def model_dir_root() -> str:
    """Where the program may write (the Trainer's model_dir): under the
    run's TMPDIR."""
    import tempfile
    return tempfile.mkdtemp(prefix="tlsan_bench_", dir=os.environ.get("TMPDIR"))
