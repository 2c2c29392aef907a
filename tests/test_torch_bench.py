"""The port's benchmark entry points (tlsan_tpu_torch/bench/) on the CPU,
at small sizes: the packed cache against bench.py's reader, bench.train's
last line and its timed chunk against a Trainer and against the JAX
package's bench chunk, the bounds PERF.md records, the step byte model of
scripts/roofline.py worked by hand, and bench.kernels, bench.roofline and
bench.http end to end with ``--device cpu``.  Every entry point raises
without ``--device cpu`` when there is no GPU."""

import contextlib
import dataclasses
import io
import json
import math
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench as jax_bench
from tlsan_tpu.core.config import ModelConfig as JaxModelConfig
from tlsan_tpu.core.config import TrainConfig as JaxTrainConfig
from tlsan_tpu.models.tlsan import TLSAN as JaxTLSAN
from tlsan_tpu.train.state import make_optimizer as jax_make_optimizer
from tlsan_tpu_torch.bench import bounds, data
from tlsan_tpu_torch.bench import http as bench_http
from tlsan_tpu_torch.bench import kernels as bench_kernels
from tlsan_tpu_torch.bench import roofline as bench_roofline
from tlsan_tpu_torch.bench import train as bench_train
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.data.batcher import Batches
from tlsan_tpu_torch.models import tlsan as tlsan_module
from tlsan_tpu_torch.models.tlsan import TLSAN
from tlsan_tpu_torch.ops.feature_attention import feature_wise_attention
from tlsan_tpu_torch.tools.params import params_from_numpy, params_to_numpy
from tlsan_tpu_torch.train.loop import Trainer

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tlsan_tpu_torch" / "tools" / "fixtures" / "jax_tlsan"
PACKED_KEYS = {"u", "i", "y", "c", "hist_i", "hist_t", "hist_i_new", "sl", "sl_new"}
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "vs_reference_measured"}
ROOFLINE_KEYS = {"metric", "full_us_per_step", "gather_us", "fwd_delta_us",
                 "bwd_delta_us", "opt_delta_us", "sparse_us_per_step",
                 "dense_bytes_mb", "minimal_bytes_mb", "full_pct_hbm_sol",
                 "examples_per_s"}
HTTP_KEYS = {"metric", "value", "unit", "p50_single_request_ms", "batch", "k",
             "catalog"}
ROWS = 512


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the xdist workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tracked(monkeypatch):
    monkeypatch.chdir(REPO)
    return data.load_packed("Digital_Music", "no_data_dir")


@pytest.fixture
def small_cache(tmp_path, monkeypatch):
    """The working directory holds a Digital_Music cache of the tracked
    cache's first ROWS rows; returns its (arrays, cate_list)."""
    arrays, cate_list = _tracked(monkeypatch)
    arrays = {k: v[:ROWS] for k, v in arrays.items()}
    monkeypatch.chdir(tmp_path)
    np.savez(data.cache_path("Digital_Music"), cate_list=cate_list, **arrays)
    return arrays, cate_list


def _last_json(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv)
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[-1]), lines


# ---------------------------------------------------------------- the cache


def test_data_reads_the_tracked_cache_as_bench_py(monkeypatch):
    """The arrays and cate_list of bench.py:27-34 (its own load_packed on
    the tracked file), bench.py:75-79's counts and :80-83's configs."""
    got, cates = _tracked(monkeypatch)
    want, want_cates = jax_bench.load_packed("Digital_Music", "no_data_dir")
    assert got.keys() == want.keys() == PACKED_KEYS
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(cates, want_cates)
    counts = dict(user_count=int(want["u"].max()) + 1,
                  item_count=len(want_cates),
                  cate_count=int(want_cates.max()) + 1)
    assert data.counts(got, cates) == counts == dict(
        user_count=1659, item_count=1583, cate_count=53)
    cfg, tc = data.configs(got, cates, 32, 200)
    jcfg = JaxModelConfig(model="tlsan", Ls=want["hist_i"].shape[1],
                          Ts=want["hist_i_new"].shape[1], **counts)
    jtc = JaxTrainConfig(steps_per_call=200, train_batch_size=32)
    for name in ("model", "Ls", "Ts", "user_count", "item_count", "cate_count",
                 "itemid_embedding_size", "hidden_units", "num_heads"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    for name in ("steps_per_call", "train_batch_size", "learning_rate",
                 "max_gradient_norm", "optimizer"):
        assert getattr(tc, name) == getattr(jtc, name), name
    assert len(got["u"]) == 37_970 and (cfg.Ls, cfg.Ts) == (10, 24)


def test_data_builds_writes_and_rereads_the_cache(tmp_path, monkeypatch):
    """Without the file, prepare('tlsan', <data_dir>/Tiny.npz) builds the
    set and np.savez writes it in bench.py's format into the working
    directory; a second call reads it back without the category file."""
    from tlsan_tpu_torch.train.cli import prepare

    monkeypatch.chdir(tmp_path)
    cache = data.cache_path("Tiny")
    assert not os.path.exists(cache)
    arrays, cates = data.load_packed("Tiny", str(FIXTURE / "Data"))
    prep = prepare("tlsan", str(FIXTURE / "Data" / "Tiny.npz"),
                   ModelConfig(model="tlsan"), use_cache=False)
    assert arrays.keys() == prep.train.arrays.keys() == PACKED_KEYS
    with np.load(cache) as z:
        assert set(z.files) == PACKED_KEYS | {"cate_list"}
    again, cates_again = data.load_packed("Tiny", "no_data_dir")
    np.testing.assert_array_equal(cates_again, cates)
    np.testing.assert_array_equal(cates, prep.cate_list)
    for k in PACKED_KEYS:
        np.testing.assert_array_equal(arrays[k], prep.train.arrays[k])
        np.testing.assert_array_equal(again[k], arrays[k])
        assert again[k].dtype == arrays[k].dtype
    assert data.counts(again, cates_again)["item_count"] == 30


# -------------------------------------------------------------- bench.train


@pytest.mark.parametrize("extra, suffix", [([], ""), (["--compute_dtype", "bf16"], "_bf16"),
                                           (["--plain"], "_plain")])
def test_train_runs_end_to_end(small_cache, extra, suffix):
    line, _ = _last_json(bench_train.main, [
        "--device", "cpu", "--steps", "4", "--steps_per_call", "2",
        "--baseline_steps", "2", *extra])
    assert BENCH_KEYS | {"device", "launches"} == set(line)
    assert line["metric"] == "tlsan_train_examples_per_sec_Digital_Music_b32" + suffix
    assert line["unit"] == "examples/s" and line["device"] == "cpu"
    assert line["value"] > 0 and math.isfinite(line["value"])
    assert line["vs_baseline"] > 0 and line["vs_reference_measured"] is None
    # three repeats of 4 steps; no kernel on the CPU; --plain's swap of
    # TLSAN's FWA call counts its calls (two towers a step) and is undone
    plain = 2 * 12 if suffix == "_plain" else 0
    assert line["launches"] == {"fwa_fwd": 0, "fwa_bwd": 0, "fwa_plain": plain,
                                "steps": 12}
    assert tlsan_module.feature_wise_attention is feature_wise_attention


@pytest.mark.parametrize("dtype, rate", [(torch.float32, 0.0), (torch.float32, 0.5),
                                         (torch.bfloat16, 0.5)])
def test_plain_fwa_is_the_dispatchers_function(dtype, rate):
    """--plain's stand-in computes the dispatcher's function: the same
    values and gradients on the same generator state, bf16 between casts."""
    rng = np.random.default_rng(1)
    B, S, D, H = 4, 10, 16, 4
    x, w1, w2 = (torch.tensor(rng.standard_normal(s, dtype=np.float32))
                 for s in ((B, S, D), (D // H, D // H), (D // H, D // H)))
    b1, b2 = (torch.tensor(rng.standard_normal(D // H, dtype=np.float32))
              for _ in range(2))
    lengths = torch.tensor([1, 4, 10, 7])
    out = []
    for fn in (feature_wise_attention, bench_train.plain_fwa):
        xi = x.to(dtype).requires_grad_()
        ws = [t.clone().requires_grad_() for t in (w1, b1, w2, b2)]
        y = fn(xi, lengths, H, *ws, rate, torch.Generator().manual_seed(3))
        y.float().square().sum().backward()
        out.append([y, xi.grad, *(w.grad for w in ws)])
    for a, b in zip(*out, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _fixed_index(n, K, B=32):
    return torch.from_numpy(np.random.default_rng(0).integers(0, n, (K, B)).astype(np.int32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_timed_chunk_equals_a_trainer(small_cache, tmp_path, dtype):
    """bench.train's warm-up and three timed repeats (4 chunks of 2 steps)
    leave the parameters bit for bit as a Trainer built the usual way (a
    real test set, the config by hand) fed the same chunk 4 times."""
    arrays, cates = small_cache
    n = len(arrays["u"])
    cfg, tc = data.configs(arrays, cates, 32, 2, sparse_updates=False,
                           compute_dtype=dtype)
    tr = bench_train.make_trainer(
        arrays, cates, cfg, dataclasses.replace(tc, model_dir=str(tmp_path / "bench")),
        "cpu")
    idx = _fixed_index(n, 2)
    _, launches = bench_train.fused(tr, idx, 2)
    assert launches["steps"] == 6

    by_hand = ModelConfig(model="tlsan", user_count=int(arrays["u"].max()) + 1,
                          item_count=1583, cate_count=53, Ls=10, Ts=24)
    test = Batches({k: v[:40] for k, v in arrays.items()}, 40)
    ref = Trainer(TLSAN, by_hand, TrainConfig(
        steps_per_call=2, model_dir=str(tmp_path / "ref"), sparse_updates=False,
        compute_dtype=dtype), cates, Batches(arrays, n), test, device="cpu")
    for _ in range(4):
        ref._train_chunk(idx)
    got, want = tr.model.state_dict(), ref.model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert tr.opt_state.count == ref.opt_state.count == 8
    tr.close()
    ref.close()


def test_timed_chunk_matches_the_jax_bench_chunk(small_cache, tmp_path):
    """20 steps of the timed chunk from the JAX init (carried by
    tools/params.py) within 1e-4 of bench.py's train_chunk: TLSAN.loss,
    jax.value_and_grad and make_optimizer's update on the same batches."""
    arrays, cates = small_cache
    n, K = len(arrays["u"]), 20
    cfg, tc = data.configs(arrays, cates, 32, K, sparse_updates=False)
    jcfg = JaxModelConfig(model="tlsan", Ls=cfg.Ls, Ts=cfg.Ts,
                          **data.counts(arrays, cates))
    jparams = JaxTLSAN.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tr = bench_train.make_trainer(
        arrays, cates, cfg, dataclasses.replace(tc, model_dir=str(tmp_path / "bench")),
        "cpu")
    tr.model.load_state_dict(params_from_numpy(tree, cfg, "cpu").state_dict())
    idx = _fixed_index(n, K)
    losses = tr._train_chunk(idx).numpy()

    opt = jax_make_optimizer(JaxTrainConfig(steps_per_call=K, train_batch_size=32))
    jcates = jnp.asarray(cates)

    def step(carry, batch):
        params, opt_state = carry
        loss, grads = jax.value_and_grad(JaxTLSAN.loss)(params, batch, jcates, jcfg, False)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    xs = {k: jnp.asarray(v[idx.numpy()]) for k, v in arrays.items()}
    (jparams, _), jlosses = jax.lax.scan(step, (jparams, opt.init(jparams)), xs)
    np.testing.assert_allclose(losses, np.asarray(jlosses), rtol=1e-4, atol=1e-4)
    got = params_to_numpy(tr.model)
    want = jax.tree_util.tree_map(np.asarray, jparams)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(flat_got[path], leaf, rtol=1e-4, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    tr.close()


# ------------------------------------------------------------------- bounds


@pytest.mark.parametrize("fn, args, want", [
    (bounds.fwa_bound, (128, 10), 0.000108),
    (bounds.fwa_bound, (128, 25), 0.000255),
    (bounds.mha_bound, (128, 96, 96, True), 0.0090146),
    (bounds.mha_bound, (128, 1, 96, False), 0.0030675),
])
def test_bounds_are_perf_mds(fn, args, want):
    """PERF.md §6's bounds: K1 at B=128, S=10 / 25 (bytes), K3 at B=128,
    (96, 96) self-attention and the (1, 96) readout (operations)."""
    ms, by = bounds.bound_ms(fn(*args))
    digits = len(str(want).split(".")[1])
    assert round(ms, digits) == want
    assert by == ("bytes" if fn is bounds.fwa_bound else "operations")


def test_step_byte_model_is_roofline_py_by_hand(monkeypatch):
    """scripts/roofline.py:214-238 for Digital_Music at batch 32 (D = 32,
    Ls = 10, Ts = 24; 1,659 users, 1,583 items, 53 categories), worked by
    hand; the dense weights counted as roofline.py counts the JAX tree."""
    arrays, cates = _tracked(monkeypatch)
    cfg, _ = data.configs(arrays, cates, 32, 200)
    model = TLSAN(cfg, "cpu")
    dense_w = bounds.dense_weight_bytes(
        (n, p.numel()) for n, p in model.named_parameters())
    jparams = JaxTLSAN.init_params(jax.random.PRNGKey(0), JaxModelConfig(
        model="tlsan", Ls=10, Ts=24, **data.counts(arrays, cates)))
    assert dense_w == sum(
        x.size * 4 for pth, x in jax.tree_util.tree_leaves_with_path(jparams)
        if not any(t in jax.tree_util.keystr(pth) for t in bounds.TABLES))
    # gamma 1; long: w1, w2 8x8, b1, b2 8, proj_w 64x64, proj_b 64; short:
    # w1, w2, b1, b2 -> 1 + 4,304 + 144 = 4,449 floats
    assert dense_w == 4 * 4_449
    by = bounds.step_bytes(cfg, 32, 10, 24, dense_w)
    table = 4 * (1583 * 33 + 1659 * 64 + 53 * 32)          # 640,444
    touched = (32 * 35 + 32) * 33 * 4 + 32 * 32 * 2 * 4    # 160,256
    batch = 4 * 32 * (6 + 20 + 24)                          # 6,400
    act = 4 * 32 * 34 * 64 * 6                              # 1,671,168
    assert by == {"table": 640_444, "dense_weights": 17_796, "touched": 160_256,
                  "batch": 6_400, "act": 1_671_168,
                  "dense": 5 * table + 4 * 17_796 + touched + batch,
                  "minimal": 3 * touched + 4 * 17_796 + batch + act}
    assert (by["dense"], by["minimal"]) == (3_440_060, 2_229_520)


# -------------------------------------------------- kernels, roofline, http


def test_kernels_print_well_formed_rows(monkeypatch):
    """bench.kernels at tiny shapes on the CPU: every row checked against
    its plain version first, one JSON row a line, then the table."""
    monkeypatch.setattr(bench_kernels, "FWA_BATCHES", (4,))
    monkeypatch.setattr(bench_kernels, "FWA_BIG_S", 12)
    monkeypatch.setattr(bench_kernels, "MHA_BATCHES", (3,))
    monkeypatch.setattr(bench_kernels, "MHA_T", 17)
    monkeypatch.setattr(bench_kernels, "REPS", 2)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = bench_kernels.main(["--device", "cpu", "--big_batch", "8"])
    printed = [json.loads(line) for line in out.getvalue().splitlines()
               if line.startswith("{")]
    assert printed == json.loads(json.dumps(rows))
    assert [r["kernel"] for r in rows] == [
        f"{op}.{d}.{v}" for op, n in (("fwa", 3), ("mha", 1))
        for _ in range(n) for d in ("fwd", "bwd") for v in ("cuda", "plain")]
    assert [(r["B"], r.get("S", r.get("T"))) for r in rows[::4]] == [
        (4, 10), (8, 10), (8, 12), (3, 17)]
    for r in rows:
        assert r["device"] == "cpu" and r["D"] == 64
        for key in ("us", "raw_us", "gbps", "sol_frac", "bound_us"):
            assert r[key] > 0 and math.isfinite(r[key]), (r["kernel"], key)
        assert r["bound_by"] in ("bytes", "operations")
    assert "bound us" in out.getvalue()


def test_roofline_prints_its_stages(small_cache):
    line, lines = _last_json(bench_roofline.main, [
        "--device", "cpu", "--steps_per_call", "4", "--sparse"])
    assert ROOFLINE_KEYS | {"idle_share", "device"} == set(line)
    assert line["metric"] == "roofline_Digital_Music_b32"
    assert line["device"] == "cpu" and line["idle_share"] is None
    for key in ROOFLINE_KEYS - {"metric"}:
        assert math.isfinite(line[key]), key
    assert line["full_us_per_step"] > 0 and line["examples_per_s"] > 0
    assert any(row.startswith("| FULL sparse step |") for row in lines)
    # the byte model of the 512 rows' config
    cfg, _ = data.configs(*small_cache, 32, 4)
    by = bounds.step_bytes(cfg, 32, 10, 24, 4 * 4_449)
    assert line["dense_bytes_mb"] == by["dense"] / 1e6
    assert line["minimal_bytes_mb"] == by["minimal"] / 1e6


def test_http_serves_the_fixture():
    line, _ = _last_json(bench_http.main, [
        "--model_dir", str(FIXTURE / "model_dir"), "--dataset", "Tiny",
        "--data_dir", str(FIXTURE / "Data"), "--reqs", "256", "--device", "cpu"])
    assert HTTP_KEYS | {"device"} == set(line)
    assert line["metric"] == "serve_http_requests_per_sec"
    assert line["unit"] == "requests/s" and line["device"] == "cpu"
    assert line["value"] > 0 and line["p50_single_request_ms"] > 0
    assert (line["batch"], line["k"], line["catalog"]) == (128, 10, 30)


@pytest.mark.parametrize("main, argv", [
    (bench_train.main, []), (bench_kernels.main, []), (bench_roofline.main, []),
    (bench_http.main, ["--model_dir", str(FIXTURE / "model_dir")])],
    ids=["train", "kernels", "roofline", "http"])
def test_entry_points_raise_without_a_gpu(monkeypatch, main, argv):
    """With no GPU and no --device cpu each raises before loading anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
