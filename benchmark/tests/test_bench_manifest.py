"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
M = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _cells(metric):
    return metric.get("workloads", [w["name"] for w in M["workloads"]])


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert len(json.dumps(M)) <= 64 * 1024
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24
    assert 1 <= len(M["end_to_end"]) <= 16 and 1 <= len(M["per_layer"]) <= 128
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    cells = 24
    assert (2 + 14 * cells) * (M["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


def test_command_and_paths():
    assert 1 <= len(M["command"]) <= 32
    assert all(TEXT.match(w) and not w.startswith("/") and ".." not in w
               for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.endswith("_torch")
        assert (REPO / p).is_dir()


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_just_their_keys(section):
    for e in M[section]:
        extra = set(e) - KEYS[section]
        assert set(e) >= KEYS[section] and extra <= ({"workloads"} if section in
                                                      ("end_to_end", "per_layer") else set())


def test_names_units_texts():
    seen = set()
    for section in KEYS:
        for e in M[section]:
            assert NAME.match(e["name"]), e["name"]
            assert (section, e["name"]) not in seen
            seen.add((section, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e and section in ("configs", "workloads", "per_layer"):
                    assert TEXT.match(e[key]), (e["name"], key)
    metric_names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_configs_have_files_and_cells():
    used = {w["config"] for w in M["workloads"]}
    files = set()
    for c in M["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert (REPO / "benchmark" / "work" / f"{c['name']}.py").is_file()
        assert (REPO / "benchmark" / "reference" / f"{conf['family']}.py").is_file()


def test_cells_find_their_files():
    pairs = set()
    for w in M["workloads"]:
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (REPO / "benchmark" / "kinds" / f"{traffic['kind']}.py").is_file()
        limits = json.loads((REPO / "benchmark" / "limits" / f"{w['name']}.json").read_text())
        assert limits and all(v > 0 for v in limits.values())


def test_bounds():
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in M["end_to_end"])


def test_every_cell_reports_setup_another_and_a_layer():
    for w in M["workloads"]:
        e2e = [m["name"] for m in M["end_to_end"] if w["name"] in _cells(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in _cells(m) for m in M["per_layer"])


def test_per_layer_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in _cells(m):
            assert cell in _cells(e2e[m["moves"]]), (m["name"], cell)
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in M["per_layer"]}
    assert all(TEXT.match(x) for x in layers)
    assert "ops.cuda (K1-K3b)" in layers
