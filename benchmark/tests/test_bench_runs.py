"""Whole runs of tiny cells on the CPU (the program's plain paths): the
reference agrees with the port, a broken timed path comes out not
correct, a metric, a kernel pattern, a configuration, a mix and a cell
are added as files, and the harness refuses to run without a card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness, run

REPO = Path(__file__).resolve().parents[2]
CELLS = ["tlsan.train.tiny", "atrank.train.tiny", "tlsan.serve.tiny", "atrank.serve.tiny"]


def _run(root, cell, trace=False, seed=2**31 + 3):
    return run.run_cell(harness.find_cell(cell, root), seed, 0.2, trace, "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_with_the_reference(tiny_root, cell):
    line = _run(tiny_root, cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) >= {"setup_s"}
    assert list(line)[-2:] == ["checks", "notes"]


@pytest.mark.parametrize("cell", ["tlsan.train.tiny", "tlsan.serve.tiny"])
def test_traced_run_reads_its_per_layer_metrics(tiny_root, cell):
    line = _run(tiny_root, cell, trace=True)
    assert line["correct"]
    kind = cell.split(".")[1]
    assert f"idle_share.{kind}" in line["metrics"]
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _fault_state_unchanged(monkeypatch):
    from tlsan_tpu_torch.train import state

    monkeypatch.setattr(state.Optimizer, "step", lambda self, params, st, *a, **k: st)


def _fault_half_batch(monkeypatch):
    from tlsan_tpu_torch.train.loop import Trainer

    step = Trainer._train_step
    monkeypatch.setattr(Trainer, "_train_step", lambda self, b: step(
        self, {k: v[: len(v) // 2] for k, v in b.items()}))


def _fault_answer_altered(monkeypatch):
    from tlsan_tpu_torch.serve.recommender import Recommender

    rec = Recommender._recommend

    def altered(self, batch):
        idx, vals = rec(self, batch)
        idx = idx.clone()
        idx[0, 0] = (idx[0, 0] + 1) % self.cfg.item_count
        return idx, vals

    monkeypatch.setattr(Recommender, "_recommend", altered)


def _fault_history_served(monkeypatch):
    from tlsan_tpu_torch.serve.recommender import Recommender

    init = Recommender.__init__

    def keep_history(self, *a, **k):
        init(self, *a, **k)
        self._exclude = False

    monkeypatch.setattr(Recommender, "__init__", keep_history)


FAULTS = [("tlsan.train.tiny", _fault_state_unchanged), ("atrank.train.tiny", _fault_state_unchanged),
          ("tlsan.train.tiny", _fault_half_batch), ("atrank.train.tiny", _fault_half_batch),
          ("tlsan.serve.tiny", _fault_answer_altered), ("atrank.serve.tiny", _fault_answer_altered),
          ("tlsan.serve.tiny", _fault_history_served), ("atrank.serve.tiny", _fault_history_served)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[7:]}" for c, f in FAULTS])
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    line = _run(tiny_root, cell, seed=99)
    assert not line["correct"], line["checks"]


def test_added_files_are_found_by_name(tmp_path):
    """A new metric with a kernel pattern file, a new mix and a new cell,
    added as files and entries: the harness runs them unedited."""
    from benchmark.tests.tiny import tiny_copy

    root = tiny_copy(tmp_path)
    b = root / "benchmark"
    (b / "metrics" / "host_ops.train.py").write_text(
        "def read(r):\n    return float(len(r.trace._host)) / r.units\n")
    (b / "metrics" / "fwa_roofline.train.d" / "k1_renamed.txt").write_text("fwa_fwd_v2_kernel\n")
    mix = json.loads((b / "traffic" / "train.tiny.json").read_text())
    mix["batch"] = 16
    (b / "traffic" / "train.tiny16.json").write_text(json.dumps(mix))
    (b / "limits" / "tlsan.train.tiny16.json").write_text(
        (b / "limits" / "tlsan.train.tiny.json").read_text())
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "tlsan.train.tiny16", "config": "tlsan-tiny",
                           "traffic": "train.tiny16", "chips": 1, "why": "tiny"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "tlsan.train.tiny" in e.get("workloads", ()):
            e["workloads"].append("tlsan.train.tiny16")
    m["per_layer"].append({"name": "host_ops.train", "unit": "ops/step", "better": "lower",
                           "source": "device_trace", "layer": "train.loop (host issue)",
                           "moves": "train_examples_per_s",
                           "workloads": ["tlsan.train.tiny16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    line = _run(root, "tlsan.train.tiny16", trace=True)
    assert line["correct"] and line["metrics"]["host_ops.train"]["value"] > 0
    from benchmark import trace
    pats = trace.Reading.patterns(str(b / "metrics" / "fwa_roofline.train.py"))
    assert any(p.search("void fwa_fwd_v2_kernel<8>") for p in pats)


def test_model_dir_under_tmpdir_is_removed(tiny_root, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    _run(tiny_root, "tlsan.train.tiny")
    assert list(tmp_path.iterdir()) == []


def _env():
    return {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "BENCH_RUN")}


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "tlsan.serve.bulk",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, env=_env(), timeout=300)
    assert p.returncode != 0 and "{" not in p.stdout


def test_alone_in_its_directory_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "tlsan.serve.bulk",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, env=_env(), timeout=300)
    assert p.returncode != 0 and "{" not in p.stdout


IMPORT_CHECK = """
import sys, json
from pathlib import Path
from benchmark import run, harness
root = Path(sys.argv[1])
for cell in {cells!r}:
    run.run_cell(harness.find_cell(cell, root), 5, 0.1, cell.endswith("train.tiny"), "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax(tiny_root):
    p = subprocess.run([sys.executable, "-c", IMPORT_CHECK.format(cells=CELLS), str(tiny_root)],
                       cwd=REPO, capture_output=True, text=True, env=_env(), timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not loaded & set(harness.FORBIDDEN), loaded & set(harness.FORBIDDEN)
    assert "tlsan_tpu_torch" in loaded


def test_references_load_nothing_of_the_program():
    code = ("import sys, json\n"
            "import benchmark.reference.tlsan, benchmark.reference.atrank\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, env=_env(), timeout=300)
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not loaded & {"tlsan_tpu_torch", *harness.FORBIDDEN}
