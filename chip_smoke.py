#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

  1. card    the GPU's name and power limit, as nvidia-smi gives them;
  2. build   every CUDA kernel from the sources in tlsan_tpu_torch/csrc/,
             one nvcc per source, all started together;
  3. kernel  each kernel against its plain PyTorch version on the card
             (TF32 off), with lengths 0, 1 and S: K1 (fwa_fwd) at the
             serving shapes B=128, S=10 and S=25, and B=37, S=17; K2
             (fwa_bwd) at the training shapes B=32, S=10 and S=25, and
             B=37, S=17, also against autograd of the plain forward, twice
             for bitwise repeatability, and through FWAFunction (K1 forward,
             K2 backward); times of each, and the card's bound;
  4. path    TLSAN at the reference widths (D=64, H=8, 32-wide embeddings,
             Ls=10, Ts=24, one block) and the Electronics catalog (39,991
             users, 22,048 items, 673 categories; SURVEY.md dataset table),
             seeded random weights: checkpoint.save, Recommender.from_model_dir
             on cuda, the HTTP service on 127.0.0.1 (healthz, a single and an
             8-request POST, 1,000 timed single-user POSTs), then bulk
             recommends of 4,000 featurized users over a window of at
             least 5 s.
             The kernel launch counts must rise by exactly 2 per request
             batch (the long and the short tower), and the answers must match
             the same checkpoint served on the CPU through the plain versions;
  5. train   the same model and catalog trained by `Trainer.train()` on the
             card: 9,600 seeded rows with the planted structure of
             tests/test_train.py (a tenth with an empty long history),
             4,096 test users, TrainConfig defaults (sgd, lr 1.0, clip 5.0,
             batch 32, test batch 128) but 100 steps a chunk, eval and
             histogram summaries every 100 steps, a save gate of 0 and one
             epoch.  K1 must launch 2 times a train step, 4 times an eval
             batch (AUC and top-k) and 2 times a summary, K2 2 times a train
             step; the loss must fall and the AUC end above 0.5; a second
             Trainer must restore the step and schedule count and evaluate
             bit for bit as the last save did; 20 steps from the same start
             must agree with the CPU plain path.  Then train examples/s over
             a window of at least 5 s, eval users/s, and one profiled chunk;
  6. summary one JSON line of per-kernel numbers, then the device line last.

It needs the repository's tlsan_tpu_torch package beside it and CUDA; it
imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.data.batcher import Batches
from tlsan_tpu_torch.models.tlsan import TLSAN
from tlsan_tpu_torch.ops.cuda import build
from tlsan_tpu_torch.ops.cuda import fwa as cuda_fwa
from tlsan_tpu_torch.ops.feature_attention import (
    feature_wise_attention_reference,
    fwa_backward_error_scale,
    fwa_backward_reference,
)
from tlsan_tpu_torch.serve.featurize import featurize_many
from tlsan_tpu_torch.serve.http import RecommendService, serve
from tlsan_tpu_torch.serve.recommender import Recommender
from tlsan_tpu_torch.train import checkpoint
from tlsan_tpu_torch.train.loop import Trainer

SEED = 1234
KERNEL_TOL = 1e-5    # f32 parity, the bar of tests/test_pallas_fwa.py
# K2 against its plain version and autograd: the bars of the JAX backward
# test (tests/test_pallas_fwa.py:58-61), rtol taken of the magnitude of the
# terms each entry sums, since the sums run in another order (_max_err)
BWD_RTOL, BWD_ATOL = 1e-5, 1e-6
SCORE_TOL = 1e-4     # kernel path vs CPU plain path, after a 64-wide product
HTTP_SCORE_TOL = 1.5e-4  # HTTP scores travel rounded to 4 decimals
# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s and
# f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# Electronics after preprocessing (SURVEY.md dataset statistics)
USERS, ITEMS, CATES = 39_991, 22_048, 673
LS, TS, BATCH, K = 10, 24, 128, 50
D, H = 64, 8
# main-path FWA shapes per request batch: long tower S=Ls, short tower S=Ts+1
MAIN_SHAPES = [(BATCH, LS), (BATCH, TS + 1)]
KERNEL_SHAPES = MAIN_SHAPES + [(37, 17)]
BULK_USERS = 4_000   # not a multiple of 128: the last batch has 0-length rows
LATENCY_REQUESTS = 1_000  # p99 is the 10th slowest, not the maximum
BULK_WINDOW_S = 5.0  # bulk users/s: every user served over one window

# training (TrainConfig defaults: batch 32, test batch 128)
TRAIN_B, TEST_B = 32, 128
# main-path FWA shapes per train step: long tower S=Ls, short tower S=Ts+1
TRAIN_SHAPES = [(TRAIN_B, LS), (TRAIN_B, TS + 1)]
BWD_SHAPES = TRAIN_SHAPES + [(37, 17)]
TRAIN_ROWS, TEST_USERS, STEPS_PER_CALL = 9_600, 4_096, 100
EMPTY_HISTORY_SHARE = 0.1  # rows with sl = 0
PLANTED_CATES = 128  # categories the seeded rows use, of the catalog's 673
PARITY_STEPS = 20
# GPU (K1/K2, atomics in the gathers' backward) against the CPU plain path
# after 20 steps of lr 1.0: f32 sums in other orders, amplified by training
PARITY_TOL = 1e-4
TRAIN_WINDOW_S = 5.0
EVAL_WINDOW_S = 2.0

KERNELS = [{"name": "fwa_fwd", "route": "cuda",
            "source": "tlsan_tpu_torch/csrc/fwa_fwd.cu",
            "replaces": "tlsan_tpu/ops/pallas/fwa.py:40"},
           {"name": "fwa_bwd", "route": "cuda",
            "source": "tlsan_tpu_torch/csrc/fwa_bwd.cu",
            "replaces": "tlsan_tpu/ops/pallas/fwa.py:125"}]


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_card() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return line


def phase_build() -> None:
    t0 = time.perf_counter()
    reports = build.build([cuda_fwa.SOURCE, cuda_fwa.BWD_SOURCE])
    log(f"build: {sorted(reports) or 'all cached'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "ptxas" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def _fwa_inputs(B: int, S: int, seed: int):
    rng = np.random.default_rng(seed)
    dh = D // H
    lengths = rng.integers(0, S + 1, B).astype(np.int32)
    lengths[:3] = [0, 1, S]
    arrays = [rng.normal(size=(B, S, D)), lengths,
              rng.normal(size=(dh, dh)) * 0.3, rng.normal(size=(dh,)) * 0.1,
              rng.normal(size=(dh, dh)) * 0.3, rng.normal(size=(dh,)) * 0.1]
    return [torch.from_numpy(a.astype(np.int32 if i == 1 else np.float32)).cuda()
            for i, a in enumerate(arrays)]


def _cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profile(fn):
    """Run fn once under torch.profiler.  Returns (wall ms, {kernel name:
    (launches, device µs)}) for the kernels that ran on the card.  The
    profiler's own cost inflates the wall time a little."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {e.key: (e.count, e.self_device_time_total)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    return wall_ms, kernels


def _fwa_bound(B: int, S: int):
    """(bytes time, operations time) in ms, the least the H100 could take:
    each input read once and the output written once over HBM, and
    4·dh+9 f32 operations per (b, t, d) (two dh-wide maps, mask, max, exp,
    sum, divide, weighted sum) at the f32 peak."""
    dh = D // H
    nbytes = 4 * (B * S * D + B + 2 * dh * dh + 2 * dh + B * D)
    flops = B * S * D * (4 * dh + 9)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS_PER_S


def phase_kernel() -> dict:
    """K1 against its plain version at every shape.  The returned times are
    per request batch: the sum over the two main-path launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = 0.0
    main = {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    for i, (B, S) in enumerate(KERNEL_SHAPES):
        x, lengths, w1, b1, w2, b2 = _fwa_inputs(B, S, SEED + i)
        got = cuda_fwa.fwa_forward(x, lengths, H, w1, b1, w2, b2)
        want = feature_wise_attention_reference(x, lengths, H, w1, b1, w2, b2)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"fwa_fwd B={B} S={S}: non-finite output")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        if not err <= KERNEL_TOL:
            raise AssertionError(f"fwa_fwd B={B} S={S}: max abs err {err:.3e}")
        kernel_ms = _cuda_ms(lambda: cuda_fwa.fwa_forward(x, lengths, H, w1, b1, w2, b2))
        plain_ms = _cuda_ms(lambda: feature_wise_attention_reference(
            x, lengths, H, w1, b1, w2, b2))
        bytes_ms, ops_ms = _fwa_bound(B, S)
        _, prof = _profile(lambda: [cuda_fwa.fwa_forward(x, lengths, H, w1, b1, w2, b2)
                                    for _ in range(50)])
        dev = [(n, us) for key, (n, us) in prof.items() if "fwa_fwd_kernel" in key]
        device_ms = (f"{1e-3 * dev[0][1] / dev[0][0]:.6f}" if dev
                     else "not measured (no device events)")
        log(f"kernel fwa_fwd B={B} S={S}: max_abs_err={err:.3e} "
            f"kernel_ms={kernel_ms:.6f} device_ms={device_ms} plain_ms={plain_ms:.6f} "
            f"bound_us={1e3 * max(bytes_ms, ops_ms):.4f} "
            f"(bytes {1e3 * bytes_ms:.4f} us, operations {1e3 * ops_ms:.4f} us)")
        if (B, S) in MAIN_SHAPES:
            for key, v in (("ms", kernel_ms), ("plain_ms", plain_ms),
                           ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                main[key] += v
    bytes_ms, ops_ms = main.pop("bytes_ms"), main.pop("ops_ms")
    return dict(main, max_abs_err=worst, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def _fwa_bwd_bound(B: int, S: int):
    """(bytes time, operations time) in ms, the least the H100 could take
    for K2: x, g, lengths and the weights read once, dx and the weight
    gradients written once, over HBM; and 12·dh+18 f32 operations per
    (b, t, d), counted from csrc/fwa_bwd.cu (the recomputed forward's
    4·dh+9, then dm1 and dx at 2·dh each, dW1 and dW2 at 2·dh each, and
    the softmax backward, mask and bias sums), at the f32 peak."""
    dh = D // H
    weights = 2 * dh * dh + 2 * dh
    nbytes = 4 * (2 * B * S * D + B * D + B + 2 * weights)
    flops = B * S * D * (12 * dh + 18)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS_PER_S


def _max_err(got, want, scale, what: str) -> float:
    """Max abs error over the gradient tuples; raises where an entry is off
    by more than atol + rtol · (Σ of its terms' magnitudes), the error
    bound of an f32 sum (fwa_backward_error_scale: db2 sums terms that
    cancel to 0, so a bar relative to its value would test noise)."""
    worst = 0.0
    for name, a, b, sc in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want, scale):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: non-finite {name}")
        err = (a - b).abs()
        if not bool((err <= BWD_ATOL + BWD_RTOL * sc).all()):
            raise AssertionError(
                f"{what}: {name} max abs err {float(err.max()):.3e} beyond "
                f"atol {BWD_ATOL} + rtol {BWD_RTOL} of its terms' magnitudes")
        worst = max(worst, float(err.max()))
    return worst


def phase_kernel_bwd() -> dict:
    """K2 against its plain version, autograd of the plain forward and
    itself, and FWAFunction against autograd.  The returned times are per
    train step: the sum over the two main-path launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = 0.0
    main = {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    for i, (B, S) in enumerate(BWD_SHAPES):
        x, lengths, w1, b1, w2, b2 = _fwa_inputs(B, S, SEED + 10 + i)
        g = torch.from_numpy(np.random.default_rng(SEED + 20 + i).normal(
            size=(B, D)).astype(np.float32)).cuda()
        args = (x, lengths, H, w1, b1, w2, b2, g)
        got = cuda_fwa.fwa_backward(*args)
        again = cuda_fwa.fwa_backward(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, again):
            if not torch.equal(a, b):
                raise AssertionError(f"fwa_bwd B={B} S={S}: two calls differ")
        what = f"fwa_bwd B={B} S={S}"
        scale = fwa_backward_error_scale(*args)
        worst = max(worst, _max_err(got, fwa_backward_reference(*args), scale,
                                    what + " vs fwa_backward_reference"))
        leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        out = feature_wise_attention_reference(leaves[0], lengths, H, *leaves[1:])
        auto = torch.autograd.grad(out, leaves, g)
        worst = max(worst, _max_err(got, auto, scale, what + " vs autograd"))
        # a length-0 row (row 0) still gets a gradient through the mask's add
        if not bool(got[0][0].abs().max() > 0):
            raise AssertionError(f"{what}: the length-0 row got no gradient")
        # FWAFunction (K1 forward, K2 backward) on a non-contiguous g
        leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        out_fn = cuda_fwa.FWAFunction.apply(leaves[0], lengths, H, *leaves[1:])
        if not float((out_fn - out).detach().abs().max()) <= KERNEL_TOL:
            raise AssertionError(f"{what}: FWAFunction forward differs")
        g_nc = g.t().contiguous().t()
        worst = max(worst, _max_err(torch.autograd.grad(out_fn, leaves, g_nc),
                                    auto, scale, what + " FWAFunction vs autograd"))

        kernel_ms = _cuda_ms(lambda: cuda_fwa.fwa_backward(*args))
        plain_ms = _cuda_ms(lambda: fwa_backward_reference(*args))
        bytes_ms, ops_ms = _fwa_bwd_bound(B, S)
        _, prof = _profile(lambda: [cuda_fwa.fwa_backward(*args) for _ in range(50)])
        main_k = [n for key, (n, _) in prof.items() if "fwa_bwd_kernel" in key]
        dev_us = sum(us for key, (_, us) in prof.items() if "fwa_bwd" in key)
        device_ms = (f"{1e-3 * dev_us / main_k[0]:.6f}" if main_k
                     else "not measured (no device events)")
        log(f"kernel fwa_bwd B={B} S={S}: max_abs_err={worst:.3e} "
            f"kernel_ms={kernel_ms:.6f} device_ms={device_ms} plain_ms={plain_ms:.6f} "
            f"bound_us={1e3 * max(bytes_ms, ops_ms):.4f} "
            f"(bytes {1e3 * bytes_ms:.4f} us, operations {1e3 * ops_ms:.4f} us); "
            f"bitwise repeatable")
        if (B, S) in TRAIN_SHAPES:
            for key, v in (("ms", kernel_ms), ("plain_ms", plain_ms),
                           ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                main[key] += v
    bytes_ms, ops_ms = main.pop("bytes_ms"), main.pop("ops_ms")
    return dict(main, max_abs_err=worst, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def _requests(rng: np.random.Generator, n: int):
    """Raw (item, day) event streams over several days; some users have a
    single day, some a last session longer than Ts."""
    reqs = []
    for u in rng.integers(0, USERS, n):
        n_days = int(rng.integers(1, 9))
        days = np.sort(rng.choice(np.arange(15_000, 16_500), n_days, replace=False))
        per_day = rng.integers(1, 8, n_days)
        if rng.random() < 0.1:
            per_day[-1] = 30
        events = [[int(i), int(d)] for d, m in zip(days, per_day)
                  for i in rng.integers(0, ITEMS, m)]
        reqs.append({"user": int(u), "events": events})
    return reqs


def assert_topk_match(ids_a, sc_a, ids_b, sc_b, atol):
    """Scores agree to `atol` position by position; ids agree except inside
    groups of scores equal to `atol` (top-k may order ties either way)."""
    np.testing.assert_allclose(sc_a, sc_b, rtol=0, atol=atol)
    for r in range(len(ids_a)):
        for j in np.flatnonzero(ids_a[r] != ids_b[r]):
            tied = np.isclose(sc_a[r], sc_a[r, j], rtol=0, atol=atol)
            if not (ids_b[r, j] in set(ids_a[r][tied]) or tied[-1]):
                raise AssertionError(f"top-k ids differ at row {r}, rank {j}")


def _http(url: str, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        if r.status != 200:
            raise AssertionError(f"{url}: HTTP {r.status}")
        return json.loads(r.read())


def _expect_launches(before: int, batches: int, what: str) -> int:
    now = cuda_fwa.launches
    if now - before != 2 * batches:
        raise AssertionError(f"{what}: fwa_fwd launched {now - before} times "
                             f"for {batches} request batches, expected {2 * batches}")
    return now


def phase_path(tmp: str) -> dict:
    cfg = ModelConfig(model="tlsan", user_count=USERS, item_count=ITEMS,
                      cate_count=CATES, Ls=LS, Ts=TS, hidden_units=D,
                      num_heads=H, num_blocks=1)
    model = TLSAN(cfg, "cpu").init_params(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    cate_list = rng.integers(0, CATES, ITEMS).astype(np.int32)
    checkpoint.save(tmp, "tlsan", 0, model, None, cfg, best=True)
    rec = Recommender.from_model_dir(tmp, cate_list, device="cuda",
                                     batch_size=BATCH, k=K)
    cpu_rec = Recommender.from_model_dir(tmp, cate_list, device="cpu",
                                         batch_size=BATCH, k=K)
    single = _requests(rng, 1)[0]
    several = _requests(rng, 8)
    timed = _requests(rng, LATENCY_REQUESTS)
    bulk = featurize_many("tlsan", cfg, _requests(rng, BULK_USERS),
                          cate_list=cate_list)

    service = RecommendService(rec, "tlsan", rec.cfg, cate_list)
    stop = threading.Event()
    worker = service.start_worker_thread(stop)
    httpd = serve(service, port=0, host="127.0.0.1")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        cuda_fwa.launches = cuda_fwa.bwd_launches = 0  # the serving path starts here
        health = _http(url + "/healthz")
        if health.get("status") != "ok" or health.get("catalog_items") != ITEMS:
            raise AssertionError(f"healthz: {health}")
        n = _expect_launches(0, 0, "healthz")
        answers = [(_http(url + "/v1/recommend", single), [single])]
        n = _expect_launches(n, 1, "single request")
        answers.append((_http(url + "/v1/recommend", {"requests": several}), several))
        n = _expect_launches(n, 1, "8 requests")
        latency_ms = []
        for req in timed:
            t0 = time.perf_counter()
            _http(url + "/v1/recommend", req)
            latency_ms.append(1e3 * (time.perf_counter() - t0))
        n = _expect_launches(n, LATENCY_REQUESTS, "timed single requests")
        n_batches = -(-BULK_USERS // BATCH)
        ids, scores = rec.recommend(bulk)  # warm-up, checked below
        n = _expect_launches(n, n_batches, "bulk recommend")
        calls, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < BULK_WINDOW_S:
            rec.recommend(bulk)
            calls += 1
        window_s = time.perf_counter() - t0
        n = _expect_launches(n, calls * n_batches, "bulk recommend window")
        wall_ms, prof = _profile(lambda: rec.recommend(bulk))
        n = _expect_launches(n, n_batches, "profiled bulk recommend")
        launches = cuda_fwa.launches  # the serving path ends here
        if cuda_fwa.bwd_launches:
            raise AssertionError(f"serving launched fwa_bwd {cuda_fwa.bwd_launches} times")
    finally:
        httpd.shutdown()
        httpd.server_close()
        stop.set()
        worker.join(timeout=30)
        server.join(timeout=30)
    users_per_s = calls * BULK_USERS / window_s
    p50, p99 = np.percentile(latency_ms, [50, 99])
    log(f"path: HTTP latency of {LATENCY_REQUESTS} sequential single-user "
        f"requests: p50 {p50:.3f} ms, p99 {p99:.3f} ms, max {max(latency_ms):.3f} ms")
    log(f"path: bulk recommend of {BULK_USERS} users in {n_batches} batches of "
        f"{BATCH}, {calls} calls in {window_s:.3f} s: {users_per_s:.1f} users/s")

    busy_ms = 1e-3 * sum(us for _, us in prof.values())
    log(f"path: profiled bulk recommend: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for key, (cnt, us) in sorted(prof.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"  {1e-3 * us:9.3f} ms {cnt:5d}x  {key[:110]}")

    # the same checkpoint on the CPU, through the plain versions
    if ids.shape != (BULK_USERS, K) or not np.isfinite(scores).all():
        raise AssertionError(f"bulk: shape {ids.shape} or non-finite scores")
    want_ids, want_scores = cpu_rec.recommend(bulk)
    assert_topk_match(want_ids, want_scores, ids, scores, SCORE_TOL)
    for body, reqs in answers:
        want_ids, want_scores = cpu_rec.recommend(
            featurize_many("tlsan", cfg, reqs, cate_list=cate_list))
        got = body["results"]
        if len(got) != len(reqs):
            raise AssertionError(f"HTTP gave {len(got)} results for {len(reqs)}")
        assert_topk_match(want_ids, want_scores,
                          np.array([r["items"] for r in got]),
                          np.array([r["scores"] for r in got]), HTTP_SCORE_TOL)
    log(f"path: {launches} fwa_fwd launches; GPU answers match the CPU plain "
        f"path (scores to {SCORE_TOL}, ids up to ties)")
    return {"launches": launches, "users_per_s": users_per_s}


def train_data(rng: np.random.Generator, users: int, items: int,
               n_train: int, n_test: int):
    """Seeded TLSAN train and test sets with the planted structure of
    tests/test_train.py:18-39: whether a row's label is 1 decides whether
    its item has the parity the user likes.  Histories, the user's dominant
    category and each item's category carry that parity too (category
    parity = item parity), so the user tower can learn it.  The rows belong
    to `n_test` users, the test set's, as in a leave-last-out split; a
    share of the rows has an empty long-term history (sl = 0).  Items and
    users fall in the first `PLANTED_CATES` categories of the catalog's, so
    each category is seen often enough in 300 steps to learn the parity."""
    cate_list = (2 * rng.integers(0, PLANTED_CATES // 2, items)
                 + np.arange(items) % 2).astype(np.int32)

    def of_parity(parity, shape):
        return (2 * rng.integers(0, items // 2, shape)
                + parity.reshape(parity.shape + (1,) * (len(shape) - 1))
                ).astype(np.int32)

    def rows(u):
        n = len(u)
        liked = (1 - u % 2).astype(np.int32)  # tests/test_train.py's rule
        sl = rng.integers(1, LS + 1, n).astype(np.int32)
        sl[rng.random(n) < EMPTY_HISTORY_SHARE] = 0
        return dict(u=u.astype(np.int32),
                    c=(2 * rng.integers(0, PLANTED_CATES // 2, n) + liked).astype(np.int32),
                    hist_i=of_parity(liked, (n, LS)),
                    hist_t=rng.uniform(0.1, 1.0, (n, LS)).astype(np.float32),
                    hist_i_new=of_parity(liked, (n, TS)),
                    sl=sl, sl_new=rng.integers(1, TS + 1, n).astype(np.int32)), liked

    test_users = rng.choice(users, n_test, replace=False)
    train, liked = rows(test_users[rng.integers(0, n_test, n_train)])
    y = rng.integers(0, 2, n_train)
    train["y"] = y.astype(np.float32)
    train["i"] = of_parity(np.where(y == 1, liked, 1 - liked), (n_train,))
    test, liked = rows(test_users)
    test["i"] = of_parity(liked, (n_test,))
    test["j"] = of_parity(1 - liked, (n_test,))
    return Batches(train, n_train), Batches(test, n_test), cate_list


def _records(model_dir: str):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _expect_train_launches(fwd0: int, bwd0: int, steps: int, eval_batches: int,
                           summaries: int, what: str):
    """K1: 2 a train step, 2 a batch of each of the AUC and top-k passes of
    an evaluation, 2 a histogram summary; K2: 2 a train step."""
    fwd = cuda_fwa.launches - fwd0
    bwd = cuda_fwa.bwd_launches - bwd0
    want_fwd = 2 * steps + 4 * eval_batches + 2 * summaries
    if fwd != want_fwd or bwd != 2 * steps:
        raise AssertionError(
            f"{what}: fwa_fwd {fwd} (expected {want_fwd}), fwa_bwd {bwd} "
            f"(expected {2 * steps}) for {steps} train steps, {eval_batches} "
            f"eval batches and {summaries} summaries")
    return cuda_fwa.launches, cuda_fwa.bwd_launches


def phase_train(tmp: str) -> dict:
    cfg = ModelConfig(model="tlsan", user_count=USERS, item_count=ITEMS,
                      cate_count=CATES, Ls=LS, Ts=TS, hidden_units=D,
                      num_heads=H, num_blocks=1)
    tc = TrainConfig(model_dir=os.path.join(tmp, "train"), max_epochs=1,
                     steps_per_call=STEPS_PER_CALL, eval_freq=STEPS_PER_CALL,
                     summary_freq=STEPS_PER_CALL, best_after_step=0,
                     save_auc_gate=0.0, seed=SEED)
    assert (tc.train_batch_size, tc.test_batch_size) == (TRAIN_B, TEST_B)
    train, test, cate_list = train_data(np.random.default_rng(SEED + 1), USERS,
                                        ITEMS, TRAIN_ROWS, TEST_USERS)
    eval_batches = -(-TEST_USERS // TEST_B)

    cuda_fwa.launches = cuda_fwa.bwd_launches = 0  # the train path starts here
    t0 = time.perf_counter()
    trainer = Trainer(TLSAN, cfg, tc, cate_list, train, test, device="cuda")
    trainer.train()
    train_s = time.perf_counter() - t0
    recs = _records(tc.model_dir)
    evals = [r for r in recs if r["kind"] in ("eval", "final")]
    losses = [r["loss"] for r in recs if r["kind"] == "train"]
    steps = trainer.step
    summaries = len(losses)  # display and summaries share the 100-step cadence
    n = _expect_train_launches(0, 0, steps, eval_batches * len(evals),
                               summaries, "Trainer.train")
    if steps != TRAIN_ROWS // TRAIN_B or trainer.opt_state.count != steps:
        raise AssertionError(f"step {steps}, schedule count {trainer.opt_state.count}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"chunk losses {losses} are not finite and falling")
    final = evals[-1]
    if not final["auc"] > max(0.5, evals[0]["auc"]):
        raise AssertionError(f"AUC after training {final['auc']} is not above "
                             f"0.5 and the initial {evals[0]['auc']}")
    if not os.path.exists(os.path.join(tc.model_dir, checkpoint.BEST)):
        raise AssertionError("no best save happened")
    log(f"train: Trainer.train() of {steps} steps and {len(evals)} evaluations "
        f"in {train_s:.3f} s; chunk losses {losses}; AUC "
        f"{[round(r['auc'], 6) for r in evals]}; final {json.dumps(final)}")

    # eval users/s over whole evaluations (each ends in a read to the host)
    evals_done, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < EVAL_WINDOW_S:
        trainer.evaluate()
        evals_done += 1
    eval_s = time.perf_counter() - t0
    n = _expect_train_launches(*n, 0, evals_done * eval_batches, 0, "evaluate")

    # train examples/s over a window of whole chunks, after a warm-up chunk
    chunks = torch.from_numpy(trainer._epoch_index(1)).cuda()
    trainer._train_chunk(chunks[0])
    torch.cuda.synchronize()
    done, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < TRAIN_WINDOW_S:
        trainer._train_chunk(chunks[done % len(chunks)])
        done += 1
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    n = _expect_train_launches(*n, (done + 1) * STEPS_PER_CALL, 0, 0, "train window")
    wall_ms, prof = _profile(lambda: trainer._train_chunk(chunks[0]))
    n = _expect_train_launches(*n, STEPS_PER_CALL, 0, 0, "profiled chunk")

    # resume: a second Trainer on the same model_dir
    resumed = Trainer(TLSAN, cfg, dataclasses.replace(tc, from_scratch=False),
                      cate_list, train, test, device="cuda")
    if resumed.step != steps or resumed.opt_state.count != steps:
        raise AssertionError(f"resumed at step {resumed.step}, count "
                             f"{resumed.opt_state.count}; saved at {steps}")
    again = resumed.evaluate()
    if again != {k: v for k, v in final.items() if k not in ("kind", "step", "wall_s")}:
        raise AssertionError(f"resumed evaluation {again} differs from the saved {final}")
    n = _expect_train_launches(*n, 0, eval_batches, 0, "resumed evaluate")
    launches = {"fwa_fwd": cuda_fwa.launches, "fwa_bwd": cuda_fwa.bwd_launches}
    trainer.close()
    resumed.close()  # the train path ends here

    examples_per_s = done * STEPS_PER_CALL * TRAIN_B / window_s
    log(f"train: {done} chunks of {STEPS_PER_CALL} steps of {TRAIN_B} in "
        f"{window_s:.3f} s: {examples_per_s:.1f} train examples/s")
    eval_users_per_s = evals_done * TEST_USERS / eval_s
    log(f"train: {evals_done} evaluate() of {TEST_USERS} users (AUC and top-50 "
        f"over {ITEMS} items) in {eval_s:.3f} s: {eval_users_per_s:.1f} eval users/s")
    busy_ms = 1e-3 * sum(us for _, us in prof.values())
    log(f"train: profiled chunk of {STEPS_PER_CALL} steps: wall {wall_ms:.3f} ms, "
        f"device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for key, (cnt, us) in sorted(prof.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"  {1e-3 * us:9.3f} ms {cnt:5d}x  {key[:110]}")
    log(f"train: resumed at step {steps} (count {steps}); its evaluation equals "
        f"the last save's bit for bit; {launches['fwa_fwd']} fwa_fwd and "
        f"{launches['fwa_bwd']} fwa_bwd launches")

    # the same start trained on the CPU through the plain versions
    parity = dataclasses.replace(tc, tb_histograms=False)
    idx = trainer._epoch_index(0)[0][:PARITY_STEPS]
    out = {}
    for device in ("cuda", "cpu"):
        tr = Trainer(TLSAN, cfg, dataclasses.replace(
            parity, model_dir=os.path.join(tmp, f"parity_{device}")),
            cate_list, train, test, device=device)
        losses_d = tr._train_chunk(torch.from_numpy(idx).to(device))
        out[device] = (losses_d.cpu(), {k: v.detach().cpu() for k, v in
                                        tr.model.state_dict().items()})
        tr.close()
    (lg, pg), (lc, pc) = out["cuda"], out["cpu"]
    worst = float((lg - lc).abs().max())
    if not torch.allclose(lg, lc, rtol=PARITY_TOL, atol=PARITY_TOL):
        raise AssertionError(f"parity: losses differ by {worst:.3e}: {lg} vs {lc}")
    for name in pg:
        diff = float((pg[name] - pc[name]).abs().max())
        worst = max(worst, diff)
        if not torch.allclose(pg[name], pc[name], rtol=PARITY_TOL, atol=PARITY_TOL):
            raise AssertionError(f"parity: {name} differs by {diff:.3e}")
    log(f"train: {PARITY_STEPS} steps on the card (K1/K2) and on the CPU (plain) "
        f"agree: max abs diff {worst:.3e} over losses and every parameter "
        f"(rtol = atol = {PARITY_TOL})")
    return {"launches": launches, "examples_per_s": examples_per_s,
            "eval_users_per_s": eval_users_per_s}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_card()
    phase_build()
    k1 = phase_kernel()
    k2 = phase_kernel_bwd()
    with tempfile.TemporaryDirectory() as tmp:
        path = phase_path(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        trained = phase_train(tmp)
    # K1 runs on both paths; its times are at the serving shapes (B=128),
    # K2's at the training shapes (B=32), each per batch (both towers)
    launches = {"fwa_fwd": path["launches"] + trained["launches"]["fwa_fwd"],
                "fwa_bwd": trained["launches"]["fwa_bwd"]}
    kernels = [dict(meta, launches=launches[meta["name"]],
                    max_abs_err=k["max_abs_err"], ms=k["ms"],
                    plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
                    bound_by=k["bound_by"], library_ms=None)
               for meta, k in zip(KERNELS, (k1, k2))]
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
