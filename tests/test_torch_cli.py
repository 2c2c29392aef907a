"""The port's command lines against the JAX package's, on the CPU.

One seeded SNAP-format fixture (tlsan_tpu_torch/tools/snap_fixture.py,
60 users, 40 items, 5 categories) is remapped by each package into
``Data/Digital_Music.npz`` (the port's) and ``Data/Digital_Music.pkl``
(the JAX package's).  `prepare` must give byte-identical arrays and equal
shape fields for all nine families, with the native builder on and off;
`main` must resolve the same ModelConfig and TrainConfig as the JAX
`main` (both Trainers replaced by a recorder); the `file://` pipeline
from `download` to `prepare` must equal the JAX package's; a CPU epoch
of the train CLI must write the artifacts of tests/test_cli.py and
`--resume` must restore; the serve CLI's --out, --show and
--query_mode last; the unported flags raise naming their ROADMAP item;
``--dp 2 --mp 2 --dist_backend gloo`` matches one process; and
`serve.http.main` starts on an .npz with pandas blocked.
"""

import dataclasses
import gzip
import json
import os
import sys

import numpy as np
import pytest

from tlsan_tpu.core.config import ModelConfig as JaxModelConfig
from tlsan_tpu.data import cli as jax_data_cli
from tlsan_tpu.data import native as jax_native
from tlsan_tpu.data import remap as jax_remap
from tlsan_tpu.train import cli as jax_cli
from tlsan_tpu_torch.core.config import ModelConfig
from tlsan_tpu_torch.data import cli as data_cli
from tlsan_tpu_torch.data import native, remap
from tlsan_tpu_torch.serve import cli as serve_cli
from tlsan_tpu_torch.serve import http
from tlsan_tpu_torch.tools.snap_fixture import write_snap_fixture
from tlsan_tpu_torch.train import cli

CATEGORY = "Digital_Music"
FAMILIES = ["tlsan", "atrank", "shan", "csan", "lspm", "paca", "cnn",
            "bilstm", "bpr"]
MESH_TOL = 1e-5


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    out = tmp_path_factory.mktemp("snap")
    write_snap_fixture(str(out), CATEGORY, users=60, items=40, cates=5,
                       reviews=720, seed=5)
    return out


@pytest.fixture(scope="module")
def data_dir(snap, tmp_path_factory):
    """Data/ with the port's .npz and the JAX package's .pkl of the fixture."""
    with gzip.open(snap / f"reviews_{CATEGORY}_5.json.gz", "rt") as f:
        reviews = f.readlines()
    with gzip.open(snap / f"meta_{CATEGORY}.json.gz", "rt") as f:
        meta = f.readlines()
    out = tmp_path_factory.mktemp("Data")
    with pytest.warns(UserWarning, match="no metadata"):
        remap.save_category(str(out / f"{CATEGORY}.npz"),
                            *remap.remap_ids(*remap.convert_raw_lines(reviews, meta)))
    with pytest.warns(UserWarning, match="no metadata"):
        jax_remap.save_category(str(out / f"{CATEGORY}.pkl"),
                                *jax_remap.remap_ids(*jax_remap.convert_raw_lines(
                                    reviews, meta)))
    return str(out)


@pytest.fixture(scope="module", autouse=True)
def cache_dir(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TLSAN_DATA_CACHE", str(tmp_path_factory.mktemp("cache")))
        yield


def _assert_same_prepared(got, want):
    train_b, test_b, cate_list, cfg = want
    for a, b in ((got.train, train_b), (got.test, test_b)):
        assert a.n == b.n and set(a.arrays) == set(b.arrays)
        for k in b.arrays:
            assert a[k].dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(got.cate_list, cate_list)
    for f in ("user_count", "item_count", "cate_count", "catalog_items", "Ls",
              "Ts", "max_length"):
        assert getattr(got.cfg, f) == getattr(cfg, f), f


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", FAMILIES)
def test_prepare_matches_jax(data_dir, name, use_native, monkeypatch):
    if use_native and not native.available():
        pytest.skip("g++ is not available")
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    hidden = 32 if name == "csan" else 64
    got = cli.prepare(name, remap.category_path(data_dir, CATEGORY),
                      ModelConfig(model=name, hidden_units=hidden), use_cache=False)
    want = jax_cli.prepare(name, os.path.join(data_dir, f"{CATEGORY}.pkl"),
                           JaxModelConfig(model=name, hidden_units=hidden),
                           use_cache=False)
    assert got.builder == ("native" if use_native else "numpy")
    _assert_same_prepared(got, want)


class _Recorder:
    """Stands in for a Trainer: records the configs `main` resolved."""

    seen = []

    def __init__(self, model, cfg, tc, *args, **kwargs):
        self.seen.append((cfg, tc))

    def train(self):
        return {}

    def close(self):
        pass

    def profile_trace(self):
        raise AssertionError("not asked for")


@pytest.mark.parametrize("name", FAMILIES)
def test_main_resolves_the_jax_configs(data_dir, name, monkeypatch):
    monkeypatch.setattr(cli, "Trainer", _Recorder)
    monkeypatch.setattr(jax_cli, "Trainer", _Recorder)
    _Recorder.seen = []
    argv = ["--model", name, "--dataset", CATEGORY, "--data_dir", data_dir,
            "--eval_freq", "50"]
    cli.main(argv + ["--device", "cpu"])
    jax_cli.main(argv + ["--platform", "cpu", "--compile_cache", ""])
    (cfg, tc), (jcfg, jtc) = _Recorder.seen
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jtc)


def test_main_honours_data_cache_0(data_dir, monkeypatch, capsys):
    """TLSAN_DATA_CACHE=0 disables the cache for the CLI too (the JAX
    package's main passes use_cache=True, which ignores it: ROADMAP.md §3)."""
    monkeypatch.setattr(cli, "Trainer", _Recorder)
    argv = ["--dataset", CATEGORY, "--data_dir", data_dir, "--device", "cpu"]
    cli.main(argv)  # builds, or finds an earlier test's entry
    capsys.readouterr()
    cli.main(argv)
    assert "builder=cache" in capsys.readouterr().out
    monkeypatch.setenv("TLSAN_DATA_CACHE", "0")
    cli.main(argv)
    assert "builder=cache" not in capsys.readouterr().out


def test_auto_steps_per_call():
    # small dataset (Clothing: 9888/32 = 309 steps/epoch) -> 100
    assert cli.auto_steps_per_call(9_888, 32, 1000) == 100
    # Electronics scale (365k/32 = 11.4k steps/epoch) -> 500
    assert cli.auto_steps_per_call(365_668, 32, 1000) == 500
    # never exceeds eval_freq (eval cadence checks at chunk boundaries)
    assert cli.auto_steps_per_call(365_668, 32, 200) == 200
    assert cli.auto_steps_per_call(10, 32, 1000) == 100


def test_file_url_pipeline_matches_jax(snap, tmp_path):
    """download → convert → remap → prepare with the SNAP host swapped for
    file:// fixture dumps (no network), against the JAX package's CLI."""
    raw, jraw = tmp_path / "raw", tmp_path / "jraw"
    for mod, out in ((data_cli, raw), (jax_data_cli, jraw)):
        assert not mod.main(["download", "--category", CATEGORY, "--out", str(out),
                             "--base_url", snap.as_uri()])
        assert not mod.main(["convert",
                             "--reviews", str(out / f"reviews_{CATEGORY}_5.json.gz"),
                             "--meta", str(out / f"meta_{CATEGORY}.json.gz"),
                             "--out", str(out)])
    with pytest.warns(UserWarning, match="no metadata"):
        assert not data_cli.main(["remap", "--reviews", str(raw / "reviews.npz"),
                                  "--meta", str(raw / "meta.npz"),
                                  "--out", str(tmp_path / "Data" / f"{CATEGORY}.npz")])
    with pytest.warns(UserWarning, match="no metadata"):
        assert not jax_data_cli.main(["remap", "--reviews", str(jraw / "reviews.pkl"),
                                      "--meta", str(jraw / "meta.pkl"),
                                      "--out", str(tmp_path / f"{CATEGORY}.pkl")])
    got = cli.prepare("tlsan", str(tmp_path / "Data" / f"{CATEGORY}.npz"),
                      ModelConfig(model="tlsan"), use_cache=False)
    want = jax_cli.prepare("tlsan", str(tmp_path / f"{CATEGORY}.pkl"),
                           JaxModelConfig(model="tlsan"), use_cache=False)
    assert got.test.n == got.cfg.user_count == 60
    _assert_same_prepared(got, want)


def _train(data_dir, model_dir, name, *extra):
    return cli.main(["--model", name, "--dataset", CATEGORY, "--data_dir", data_dir,
                     "--max_epochs", "1", "--eval_freq", "5", "--best_after_step",
                     "0", "--save_auc_gate", "0", "--model_dir", model_dir,
                     "--device", "cpu", *extra])


def _evals(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k not in ("wall_s", "kind", "step")}
            for r in recs if r["kind"] in ("eval", "final")]


@pytest.fixture(scope="module")
def trained(data_dir, tmp_path_factory):
    """One CPU epoch of the train CLI a family: {name: model_dir}."""
    out = {}
    for name in ("tlsan", "bpr", "atrank"):
        out[name] = str(tmp_path_factory.mktemp(f"run_{name}"))
        _train(data_dir, out[name], name)
    return out


@pytest.mark.parametrize("name", ["bpr", "tlsan"])
def test_train_cli_artifacts_and_resume(trained, data_dir, name, capsys):
    model_dir = trained[name]
    files = os.listdir(model_dir)
    assert "latest" in files and "best" in files and "metrics.jsonl" in files
    assert any(f.endswith(".ckpt") for f in files)
    assert any(f.endswith(".json") for f in files)  # config sidecar
    assert os.path.isdir(os.path.join(model_dir, "train"))  # tfevents
    assert os.path.isdir(os.path.join(model_dir, "eval"))
    before = _evals(model_dir)
    assert before and all(0.0 <= e["auc"] <= 1.0 for e in before)
    capsys.readouterr()
    _train(data_dir, model_dir, name, "--resume")
    out = capsys.readouterr().out
    assert "restored from" in out and "builder=cache" in out
    # the resumed run's first evaluation is the saved weights' last one
    assert _evals(model_dir)[len(before)] == before[-1]


def _serve(model_dir, data_dir, *extra):
    return serve_cli.main(["--model_dir", model_dir, "--dataset", CATEGORY,
                           "--data_dir", data_dir, "--device", "cpu", *extra])


def test_serve_cli_out_and_show(trained, data_dir, tmp_path, capsys):
    out = tmp_path / "recs.jsonl"
    metric = _serve(trained["tlsan"], data_dir, "--k", "5", "--show", "2",
                    "--out", str(out))
    lines = capsys.readouterr().out.strip().splitlines()
    shown = [json.loads(line) for line in lines[-3:]]
    assert shown[2] == json.loads(json.dumps(metric))
    assert metric["metric"] == "serve_users_per_s" and metric["value"] > 0
    recs = [json.loads(line) for line in open(out)]
    assert len(recs) == 60  # one line a test user
    assert sorted(r["user"] for r in recs) == list(range(60))
    assert shown[:2] == recs[:2]
    for r in recs:
        assert len(r["items"]) == 5 and all(0 <= i < 40 for i in r["items"])
        assert r["scores"] == sorted(r["scores"], reverse=True)


def test_serve_cli_query_mode_last(trained, data_dir, tmp_path, capsys):
    label, last = tmp_path / "label.jsonl", tmp_path / "last.jsonl"
    _serve(trained["atrank"], data_dir, "--k", "5", "--show", "0", "--out", str(label))
    assert "WARNING: --query_mode=label" in capsys.readouterr().out
    _serve(trained["atrank"], data_dir, "--k", "5", "--show", "0", "--out", str(last),
           "--query_mode", "last")
    a = [json.loads(line) for line in open(label)]
    b = [json.loads(line) for line in open(last)]
    assert len(a) == len(b) == 60 and a != b  # the query item differs


@pytest.mark.parametrize("flags,item", [
    (["--optimizer", "adam"], "item 24"),
    (["--sparse"], "item 18"),
    (["--compute_dtype", "bf16"], "item 19"),
    (["--profile"], "item 26"),
])
def test_unported_flags_name_their_roadmap_item(data_dir, tmp_path, flags, item):
    """The flags of ROADMAP items 24, 18, 19 and 26 once raised naming
    their item; now each runs: a TLSAN epoch on the CPU that completes
    and reports finite metrics (--profile also writes its trace)."""
    model_dir = str(tmp_path / "m")
    best = cli.main(["--model", "tlsan", "--dataset", CATEGORY, "--data_dir",
                     data_dir, "--device", "cpu", "--model_dir", model_dir,
                     "--max_epochs", "1", "--train_batch_size", "64",
                     "--steps_per_call", "8", "--eval_freq", "1000",
                     "--no_histograms", "--learning_rate", "0.05", *flags])
    assert np.isfinite(best["auc"]) and 0.0 <= best["auc"] <= 1.0, item
    assert os.path.exists(os.path.join(model_dir, "latest"))
    if "--profile" in flags:
        assert os.path.exists(os.path.join(model_dir, "profile", "trace.json"))


def test_mesh_flags_are_checked(data_dir):
    with pytest.raises(SystemExit):  # no backend is guessed
        cli.main(["--data_dir", data_dir, "--device", "cpu", "--dp", "2"])
    with pytest.raises(SystemExit):  # a world of the wrong size
        cli.main(["--data_dir", data_dir, "--device", "cpu", "--dp", "2",
                  "--dist_backend", "gloo", "--rank", "0", "--world", "3",
                  "--init_method", "tcp://127.0.0.1:1"])


def test_mesh_cli_matches_one_process(data_dir, tmp_path):
    common = ["--model", "tlsan", "--dataset", CATEGORY, "--data_dir", data_dir,
              "--max_epochs", "1", "--eval_freq", "5", "--best_after_step", "0",
              "--device", "cpu"]
    one = cli.main(common + ["--model_dir", str(tmp_path / "one")])
    mesh = cli.main(common + ["--model_dir", str(tmp_path / "mesh"), "--dp", "2",
                              "--mp", "2", "--dist_backend", "gloo"])
    a, b = _evals(str(tmp_path / "one")), _evals(str(tmp_path / "mesh"))
    assert len(a) == len(b) > 2
    for x, y in zip(a + [one], b + [mesh]):
        assert x.keys() == y.keys()
        for k in x:
            assert abs(x[k] - y[k]) <= MESH_TOL, (k, x[k], y[k])


def test_http_main_reads_npz_without_pandas(trained, data_dir, monkeypatch):
    started = []

    def stop(service, stop=None):
        started.append(service.info())
        raise KeyboardInterrupt  # main shuts the server down and returns

    monkeypatch.setitem(sys.modules, "pandas", None)  # as on the card's machine
    monkeypatch.setattr(http.RecommendService, "run_worker", stop)
    http.main(["--model_dir", trained["tlsan"], "--dataset", CATEGORY,
               "--data_dir", data_dir, "--port", "0", "--host", "127.0.0.1",
               "--device", "cpu"])
    assert started == [{"status": "ok", "model": "tlsan", "catalog_items": 40,
                        "k": 10}]
