"""A copy of the benchmark with two tiny configurations and mixes added
as files, for runs on the CPU: what a later PR adding a configuration, a
mix or a cell does, done on a temporary copy."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_CATALOG = {"users": 240, "items": 160, "cates": 12, "reviews": 240 * 14 + 17,
                "min_rows": 10, "max_rows": 60, "tail_alpha": 2.0, "min_days": 4,
                "max_days": 90, "day_share": [0.3, 1.0], "groups": 4,
                "preference": 0.8, "min_item_rows": 8, "shape_seed": 0}

TRAIN = {"kind": "train", "batch": 32, "steps_per_chunk": 3}
SERVE = {"kind": "serve", "request_users": 96, "batch": 32, "k": 10}
TRAIN_LIMITS = {"loss_gap": 1e-5, "update_gap": 1e-4, "change_gap": 1e-4}
SERVE_LIMITS = {"score_gap": 1e-5, "rank_gap": 1e-5}


def tiny_copy(dest: Path) -> Path:
    """BENCHMARK.json and benchmark/ copied under `dest`, plus the configs
    tlsan-tiny and atrank-tiny, the mixes train.tiny and serve.tiny, the
    four cells `<family>.<train|serve>.tiny` and their limits: files added
    and entries appended, nothing edited.  Returns `dest`."""
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    b = dest / "benchmark"
    for family in ("tlsan", "atrank"):
        conf = json.loads((b / "configs" / f"{family}-electronics.json").read_text())
        conf["catalog"] = TINY_CATALOG
        (b / "configs" / f"{family}-tiny.json").write_text(json.dumps(conf))
        shutil.copy(b / "work" / f"{family}-electronics.py", b / "work" / f"{family}-tiny.py")
        manifest["configs"].append({"name": f"{family}-tiny", "source": "tiny",
                                    "file": f"benchmark/configs/{family}-tiny.json",
                                    "reduced": ["catalog"], "why": "tiny"})
        for kind, limits in (("train", TRAIN_LIMITS), ("serve", SERVE_LIMITS)):
            cell = f"{family}.{kind}.tiny"
            manifest["workloads"].append({"name": cell, "config": f"{family}-tiny",
                                          "traffic": f"{kind}.tiny", "chips": 1,
                                          "why": "tiny"})
            (b / "limits" / f"{cell}.json").write_text(json.dumps(limits))
            for m in manifest["end_to_end"] + manifest["per_layer"]:
                if any(w.startswith(f"{family}.{kind}.") for w in m.get("workloads", ())):
                    m["workloads"].append(cell)
    (b / "traffic" / "train.tiny.json").write_text(json.dumps(TRAIN))
    (b / "traffic" / "serve.tiny.json").write_text(json.dumps(SERVE))
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return dest
