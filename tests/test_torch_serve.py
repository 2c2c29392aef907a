"""Serving in the PyTorch port against the JAX package: featurize_many
(bitwise), Recommender.recommend (padding, catalog_items, exclude_history),
the HTTP service on localhost, the checkpoint round trip, and the rule that
an entry point with no device asks for CUDA and raises without it."""

import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from tlsan_tpu.core.config import ModelConfig as JaxModelConfig
from tlsan_tpu.models.tlsan import TLSAN as JaxTLSAN
from tlsan_tpu.serve import http as jax_http
from tlsan_tpu.serve.featurize import featurize_many as jax_featurize_many
from tlsan_tpu.serve.recommender import Recommender as JaxRecommender
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.serve import http as torch_http
from tlsan_tpu_torch.serve.featurize import featurize_many
from tlsan_tpu_torch.serve.recommender import Recommender
from tlsan_tpu_torch.tools.params import params_from_numpy
from tlsan_tpu_torch.train import checkpoint

USERS, ITEMS, CATES, LS, TS = 24, 48, 6, 10, 8
CFG = dict(model="tlsan", user_count=USERS, item_count=ITEMS,
           cate_count=CATES, Ls=LS, Ts=TS, catalog_items=40)
TOL = 1e-5


def assert_topk_match(ids_a, sc_a, ids_b, sc_b, atol):
    """Scores agree to `atol` position by position; ids agree except inside
    groups of scores equal to `atol` (top-k may order ties either way, and
    a tie at the k-th score may pick an id beyond the other's cut)."""
    np.testing.assert_allclose(sc_a, sc_b, rtol=0, atol=atol)
    for r in range(len(ids_a)):
        for j in np.flatnonzero(ids_a[r] != ids_b[r]):
            tied = np.isclose(sc_a[r], sc_a[r, j], rtol=0, atol=atol)
            assert ids_b[r, j] in set(ids_a[r][tied]) or tied[-1], (r, j)


def _requests(seed, n):
    """Numpy-seeded raw event streams: multi-day histories longer than Ls,
    sessions longer than Ts, single-day histories, explicit `now`."""
    rng = np.random.default_rng(seed)
    reqs = []
    for r in range(n):
        n_days = int(rng.integers(1, 7))
        days = np.sort(rng.choice(np.arange(100, 400), n_days, replace=False))
        events = [[int(rng.integers(0, CFG["catalog_items"])), int(d)]
                  for d in days for _ in range(int(rng.integers(1, 12)))]
        req = {"user": int(rng.integers(0, USERS)), "events": events}
        if r % 5 == 4:
            req["now"] = int(days[-1]) + int(rng.integers(0, 30))
        reqs.append(req)
    return reqs


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxModelConfig(**CFG)
    jparams = JaxTLSAN.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = ModelConfig(**CFG)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, "cpu")
    cate_list = np.random.default_rng(0).integers(0, CATES, ITEMS).astype(np.int32)
    return jcfg, jparams, cfg, model, cate_list


def test_featurize_many_bitwise_equal_to_jax(setup):
    jcfg, _, cfg, _, cate_list = setup
    reqs = _requests(1, 40)
    want = jax_featurize_many("tlsan", jcfg, reqs, cate_list=cate_list)
    got = featurize_many("tlsan", cfg, reqs, cate_list=cate_list)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert np.isfinite(got["hist_t"]).all()  # same-day events are clamped


def test_featurize_unported_family_raises(setup):
    """Every family featurizes now; an unknown name raises ValueError, as
    in the JAX package."""
    jcfg, _, cfg, _, cate_list = setup
    with pytest.raises(ValueError, match="unknown model family"):
        jax_featurize_many("nope", jcfg, _requests(1, 2), cate_list=cate_list)
    with pytest.raises(ValueError, match="unknown model family"):
        featurize_many("nope", cfg, _requests(1, 2), cate_list=cate_list)


@pytest.mark.parametrize("exclude", [False, True])
def test_recommend_matches_jax(setup, exclude):
    jcfg, jparams, cfg, model, cate_list = setup
    # 21 users through 8-wide batches: the last batch is zero-padded, so
    # rows with sl = sl_new = 0 run through the towers
    batch = featurize_many("tlsan", cfg, _requests(2, 21), cate_list=cate_list)
    k = 12
    want_ids, want_sc = JaxRecommender(
        JaxTLSAN, jparams, cate_list, jcfg, k=k, use_pallas=False,
        exclude_history=exclude, batch_size=8).recommend(batch)
    rec = Recommender(model, cate_list, k=k, exclude_history=exclude,
                      batch_size=8, device="cpu")
    ids, sc = rec.recommend(batch)
    assert ids.shape == (21, k) and ids.dtype == np.int32
    assert not np.isnan(sc).any()
    assert ids.max() < CFG["catalog_items"]
    assert_topk_match(want_ids, want_sc, ids, sc, TOL)
    if exclude:
        for r in range(21):
            hist = set(batch["hist_i"][r, :batch["sl"][r]].tolist())
            hist |= set(batch["hist_i_new"][r, :batch["sl_new"][r]].tolist())
            ranked = {i for i, s in zip(ids[r], sc[r]) if np.isfinite(s)}
            assert not hist & ranked


def test_exclude_history_duplicate_ids_give_minus_inf(setup):
    _, _, cfg, model, cate_list = setup
    batch = featurize_many("tlsan", cfg, [
        {"user": 1, "events": [[5, 10], [5, 10], [7, 11], [5, 12], [5, 12]]}],
        cate_list=cate_list)
    rec = Recommender(model, cate_list, k=40, exclude_history=True,
                      batch_size=4, device="cpu")
    ids, sc = rec.recommend(batch)
    assert not np.isnan(sc).any()
    assert np.isneginf(sc[0][np.isin(ids[0], [5, 7])]).all()


def test_checkpoint_round_trip_is_bit_exact(setup, tmp_path):
    _, _, cfg, model, cate_list = setup
    path = checkpoint.save(str(tmp_path), "tlsan", 123, model, None, cfg,
                           TrainConfig(), best=True)
    assert path.endswith("tlsan-123.ckpt")
    assert checkpoint.best_checkpoint(str(tmp_path)) == path
    assert checkpoint.latest_checkpoint(str(tmp_path)) == path
    sidecar = json.loads((tmp_path / "tlsan-123.json").read_text())
    assert sidecar["ModelConfig"]["catalog_items"] == 40
    batch = featurize_many("tlsan", cfg, _requests(3, 9), cate_list=cate_list)
    loaded = Recommender.from_model_dir(str(tmp_path), cate_list, device="cpu",
                                        k=5, batch_size=16)
    for name, p in model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[name], p), name
    direct = Recommender(model, cate_list, k=5, batch_size=16, device="cpu")
    ids_a, sc_a = loaded.recommend(batch)
    ids_b, sc_b = direct.recommend(batch)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(sc_a, sc_b)
    step, _, opt_state = checkpoint.restore(path, loaded.model)
    assert step == 123 and opt_state is None


def test_no_device_means_cuda_and_raises_without_it(setup, monkeypatch):
    _, _, _, model, cate_list = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Recommender(model, cate_list)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_http.main(["--model_dir", "unused", "--data_dir", "unused"])


def _start(http_module, service):
    stop = threading.Event()
    if http_module is torch_http:
        service.start_worker_thread(stop)
    else:  # the JAX worker runs until the process ends
        service.start_worker_thread()
    httpd = http_module.serve(service, port=0, host="127.0.0.1")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, stop, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, payload):
    req = urllib.request.Request(
        url + "/v1/recommend", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


@pytest.fixture(scope="module")
def servers(setup):
    jcfg, jparams, cfg, model, cate_list = setup
    jrec = JaxRecommender(JaxTLSAN, jparams, cate_list, jcfg, k=6,
                          use_pallas=False, batch_size=8)
    rec = Recommender(model, cate_list, k=6, batch_size=8, device="cpu")
    started = [
        _start(jax_http, jax_http.RecommendService(jrec, "tlsan", jcfg, cate_list)),
        _start(torch_http, torch_http.RecommendService(rec, "tlsan", cfg, cate_list)),
    ]
    yield [url for _, _, url in started]
    for httpd, stop, _ in started:
        httpd.shutdown()
        httpd.server_close()
        stop.set()


def test_http_service_gives_the_jax_answers(servers):
    jax_url, torch_url = servers
    with urllib.request.urlopen(torch_url + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    with urllib.request.urlopen(jax_url + "/healthz", timeout=30) as r:
        assert health == json.loads(r.read())
    reqs = _requests(4, 11)
    payloads = [reqs[0], {"requests": reqs, "k": 4},
                {"user": 2, "events": [[3, 100], [7, 100], [11, 100]]}]
    for payload in payloads:
        status_j, body_j = _post(jax_url, payload)
        status_t, body_t = _post(torch_url, payload)
        assert status_j == status_t == 200
        assert len(body_t["results"]) == len(body_j["results"])
        for rj, rt in zip(body_j["results"], body_t["results"]):
            # scores travel rounded to 4 decimals
            assert_topk_match(np.array([rj["items"]]), np.array([rj["scores"]]),
                              np.array([rt["items"]]), np.array([rt["scores"]]),
                              atol=1.5e-4)
    for bad in ({"user": 3, "events": []}, {"requests": [], "k": 3}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(torch_url, bad)
        assert e.value.code == 400
