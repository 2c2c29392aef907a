"""The port's spans (tlsan_tpu_torch/core/spans.py) on the CPU: nothing
is recorded and no hook is registered without a profiler; under
`torch.profiler` a TLSAN and an ATRank chunk record each phase once a
step under `train.step`, every gather and its backward, and names the
profiler sees too; serving records its spans once a request and once a
batch; losses, parameters and served answers are bit for bit those of a
run without the profiler; `take()` clears the record; and
`Trainer.profile_trace` writes the span table beside its trace."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tlsan_tpu_torch.core import spans
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.data.batcher import Batches
from tlsan_tpu_torch.models import get_model
from tlsan_tpu_torch.serve.recommender import Recommender
from tlsan_tpu_torch.train.loop import Trainer

USERS, ITEMS, CATES, N = 24, 40, 6, 96
K, B = 3, 16
CFG = {"tlsan": dict(model="tlsan", Ls=6, Ts=8),
       "atrank": dict(model="atrank", max_length=10)}
PHASES = ("train.forward", "train.backward", "train.optimizer")
# the gathers of one step's loss: (span, a step)
GATHERS = {"tlsan": {"nn.embedding": 4, "nn.embedding.item_cate": 3,
                     "nn.embedding.cate_list": 1},
           "atrank": {"nn.embedding": 1, "nn.embedding.item_cate": 3,
                      "nn.embedding.cate_list": 1}}
SERVE_BATCH = ("serve.logits", "serve.exclusion", "serve.topk",
               "models.catalog_logits")


@pytest.fixture(autouse=True)
def single_thread():
    """One intra-op thread: the CPU's scatter-add on several threads sums
    in no fixed order, and the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.take()
    yield
    torch.set_num_threads(n)


def _arrays(family, n, seed, train=True):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, USERS, n).astype(np.int32)
    a = dict(u=u, i=rng.integers(0, ITEMS, n).astype(np.int32))
    if train:
        a["y"] = rng.integers(0, 2, n).astype(np.float32)
    if family == "tlsan":
        L, T = CFG["tlsan"]["Ls"], CFG["tlsan"]["Ts"]
        a.update(c=rng.integers(0, CATES, n).astype(np.int32),
                 hist_i=rng.integers(0, ITEMS, (n, L)).astype(np.int32),
                 hist_t=rng.uniform(0.1, 1, (n, L)).astype(np.float32),
                 hist_i_new=rng.integers(0, ITEMS, (n, T)).astype(np.int32),
                 sl=rng.integers(1, L + 1, n).astype(np.int32),
                 sl_new=rng.integers(1, T + 1, n).astype(np.int32))
    else:
        T = CFG["atrank"]["max_length"]
        a.update(hist_i=rng.integers(0, ITEMS, (n, T)).astype(np.int32),
                 hist_t=rng.integers(0, 12, (n, T)).astype(np.int32),
                 sl=rng.integers(0, T + 1, n).astype(np.int32))
    return a


def _cfg(family):
    return ModelConfig(user_count=USERS, item_count=ITEMS, cate_count=CATES,
                       **CFG[family])


def _trainer(family, tmp_path, **over):
    arrays = _arrays(family, N, 1)
    test = dict(arrays)
    test["j"] = np.random.default_rng(2).integers(0, ITEMS, N).astype(np.int32)
    del test["y"]
    kw = dict(model_dir=str(tmp_path), train_batch_size=B, test_batch_size=32,
              steps_per_call=K, learning_rate=0.5, tb_histograms=False,
              sparse_updates=False)
    kw.update(over)
    cate_list = np.random.default_rng(3).integers(0, CATES, ITEMS).astype(np.int32)
    return Trainer(get_model(family), _cfg(family), TrainConfig(**kw), cate_list,
                   Batches(arrays, N), Batches(test, N), device="cpu")


def _chunk(trainer):
    idx = torch.from_numpy(trainer._epoch_index(0)[0])
    losses = trainer._train_chunk(idx)
    return losses, {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.mark.parametrize("family", ["tlsan", "atrank"])
def test_nothing_recorded_without_a_profiler(family, tmp_path, monkeypatch):
    """No span object is made, so no hook sits on any grad_fn: a hook
    registered by `backward_span` would make one when backward runs."""
    def refuse(*a, **k):
        raise AssertionError("a span was made with no profiler running")

    monkeypatch.setattr(spans, "_Span", refuse)
    trainer = _trainer(family, tmp_path)
    assert spans.span("train.step") is spans.NULL
    assert spans.inner("nn.embedding") is spans.NULL
    losses, _ = _chunk(trainer)
    assert torch.isfinite(losses).all()
    assert spans.take() == {}


@pytest.mark.parametrize("family", ["tlsan", "atrank"])
def test_chunk_records_each_phase_and_gather(family, tmp_path):
    trainer = _trainer(family, tmp_path)
    _, prof = _profiled(lambda: _chunk(trainer))
    table = spans.take()
    step = table["train.step"]
    assert (step["count"], step["parents"]) == (K, [])
    for name in PHASES:
        assert table[name]["count"] == K, name
        assert table[name]["parents"] == ["train.step"], name
    for name, a_step in GATHERS[family].items():
        assert table[name]["count"] == K * a_step, name
        assert table[name]["parents"] == ["train.forward"], name
        bwd = table[name + ".bwd"]
        assert bwd["count"] == K * a_step, name
        assert bwd["parents"] == ["train.backward"], name
    assert set(table) == ({"train.step", *PHASES} | set(GATHERS[family])
                          | {n + ".bwd" for n in GATHERS[family]})
    seen = {e.name for e in prof.events()}
    assert set(table) <= seen
    for name, r in table.items():
        assert r["device_ms"] == r["host_ms"] > 0.0, name  # the CPU: host time
    # a step's self time is what its phases leave of it
    inner = sum(table[n]["device_ms"] for n in PHASES)
    assert table["train.step"]["self_device_ms"] == pytest.approx(
        table["train.step"]["device_ms"] - inner)
    gathers = sum(table[n + ".bwd"]["device_ms"] for n in GATHERS[family])
    assert table["train.backward"]["self_device_ms"] == pytest.approx(
        table["train.backward"]["device_ms"] - gathers)


@pytest.mark.parametrize("family", ["tlsan", "atrank"])
def test_chunk_is_bit_for_bit_with_the_profiler_on(family, tmp_path):
    plain = _chunk(_trainer(family, tmp_path / "plain"))
    traced, _ = _profiled(lambda: _chunk(_trainer(family, tmp_path / "traced")))
    assert spans.take()
    assert torch.equal(plain[0], traced[0])
    assert plain[1].keys() == traced[1].keys()
    for name, v in plain[1].items():
        assert torch.equal(v, traced[1][name]), name


@pytest.mark.parametrize("family", ["tlsan", "atrank"])
def test_serving_records_a_request_and_its_batches(family):
    model = get_model(family)(_cfg(family), "cpu").init_params(
        torch.Generator().manual_seed(5))
    cate_list = np.random.default_rng(3).integers(0, CATES, ITEMS).astype(np.int32)
    rec = Recommender(model, cate_list, k=5, exclude_history=True, batch_size=16,
                      device="cpu")
    requests = [_arrays(family, n, 10 + n, train=False) for n in (40, 48)]
    plain = [rec.recommend(r) for r in requests]
    traced, _ = _profiled(lambda: [rec.recommend(r) for r in requests])
    for (ids, vals), (t_ids, t_vals) in zip(plain, traced):
        np.testing.assert_array_equal(ids, t_ids)
        np.testing.assert_array_equal(vals, t_vals)
    table = spans.take()
    batches = 3 + 3  # 40 and 48 users in batches of 16
    for name in ("serve.request", "serve.h2d", "serve.d2h"):
        assert table[name]["count"] == 2, name
    for name in ("serve.h2d", "serve.d2h", "serve.logits", "serve.exclusion",
                 "serve.topk"):
        assert table[name]["parents"] == ["serve.request"], name
    for name in SERVE_BATCH:
        assert table[name]["count"] == batches, name
    assert table["models.catalog_logits"]["parents"] == ["serve.logits"]
    # the user tower's gathers record no span in serving
    assert set(table) == {"serve.request", "serve.h2d", "serve.d2h", *SERVE_BATCH}


def test_evaluation_and_the_sparse_step_record_no_inner_span(tmp_path):
    trainer = _trainer("tlsan", tmp_path / "dense")
    _profiled(trainer.evaluate)
    assert spans.take() == {}
    sparse = _trainer("tlsan", tmp_path / "sparse", sparse_updates=True)
    assert sparse._use_sparse
    _profiled(lambda: _chunk(sparse))
    assert spans.take() == {}


def test_take_clears_the_record(tmp_path):
    trainer = _trainer("tlsan", tmp_path)
    _profiled(lambda: _chunk(trainer))
    assert spans.take()["train.step"]["count"] == K
    assert spans.take() == {}
    _profiled(lambda: _chunk(trainer))
    assert spans.take()["train.step"]["count"] == K


def test_folding_keeps_the_totals(monkeypatch):
    """Past FOLD_AT closed spans the kept ones are folded into totals; the
    table equals the one kept whole."""
    def run():
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(40):
                with spans.span("outer", inner="leaf"):
                    with spans.inner("leaf"):
                        pass
        return spans.take()

    whole = run()
    monkeypatch.setattr(spans, "FOLD_AT", 7)
    folded = run()
    assert folded.keys() == whole.keys() == {"outer", "leaf"}
    for name in whole:
        assert folded[name]["count"] == whole[name]["count"] == 40
    assert folded["leaf"]["parents"] == ["outer"]


class _FakeEvent:
    """A timing event whose device has passed it once `passed` is set;
    waiting on it before `take` is refused."""
    made = 0
    passed = False
    may_wait = False

    def __init__(self, enable_timing):
        assert enable_timing
        type(self).made += 1

    def record(self, stream):
        self.recorded = True

    def query(self):
        return type(self).passed

    def synchronize(self):
        assert type(self).may_wait, "a fold waited on the device"

    def elapsed_time(self, end):
        return 0.25


@pytest.mark.parametrize("passed", [True, False])
def test_a_fold_never_waits_on_the_device(monkeypatch, passed):
    """Spans on a CUDA device (events stood in for on the CPU): past
    FOLD_AT a fold takes only spans whose end event the device has passed
    and never waits; their events are recorded again by later spans; take
    waits for the rest."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(spans.Recorder, "_stream", lambda self, device: None)
    monkeypatch.setattr(spans, "FOLD_AT", 7)
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(_FakeEvent, "passed", passed)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(40):
            with spans.span("outer", device="cuda:0", inner="leaf"):
                with spans.inner("leaf"):
                    pass
    # passed: each fold frees the events of the spans it took
    assert _FakeEvent.made <= (2 * (7 + 2) if passed else 2 * 80)
    monkeypatch.setattr(_FakeEvent, "may_wait", True)
    table = spans.take()
    assert {n: r["count"] for n, r in table.items()} == {"outer": 40, "leaf": 40}
    assert table["leaf"]["device_ms"] == pytest.approx(40 * 0.25)
    assert table["outer"]["self_device_ms"] == pytest.approx(0.0)
    assert table["leaf"]["parents"] == ["outer"]


def test_cpu_work_in_a_process_with_cuda_takes_the_host_clock(tmp_path, monkeypatch):
    """A span's clock follows the device of its work, not the process's
    CUDA state: a CPU chunk after CUDA has been initialised (stood in for
    where the process has no card) records no CUDA event."""
    if torch.cuda.is_available():
        torch.zeros(1, device="cuda")
    else:
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)

    def refuse(*a, **k):
        raise AssertionError("a CUDA event for work on the CPU")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    trainer = _trainer("atrank", tmp_path)
    _profiled(lambda: _chunk(trainer))
    table = spans.take()
    assert table["train.step"]["count"] == K
    for name, r in table.items():
        assert r["device_ms"] == r["host_ms"] > 0.0, name


def test_profile_trace_writes_the_span_table(tmp_path):
    trainer = _trainer("tlsan", tmp_path)
    out = trainer.profile_trace(n_chunks=2)
    with open(f"{out}/spans.json") as f:
        table = json.load(f)
    assert table["train.step"]["count"] == 2 * K
    assert table["nn.embedding.item_cate.bwd"]["count"] == 2 * K * 3
    assert spans.take() == {}
