#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

  1. card    the GPU's name and power limit, as nvidia-smi gives them;
  2. build   every CUDA kernel from the sources in tlsan_tpu_torch/csrc/,
             one nvcc per source, all started together;
  3. kernel  each kernel against its plain PyTorch version on the card
             (TF32 off), at the serving shapes and at ragged ones, with
             lengths 0, 1 and S; times of both, and the card's bound;
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
  5. summary one JSON line of per-kernel numbers, then the device line last.

It needs the repository's tlsan_tpu_torch package beside it and CUDA; it
imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from tlsan_tpu_torch.core.config import ModelConfig
from tlsan_tpu_torch.models.tlsan import TLSAN
from tlsan_tpu_torch.ops.cuda import build
from tlsan_tpu_torch.ops.cuda import fwa as cuda_fwa
from tlsan_tpu_torch.ops.feature_attention import feature_wise_attention_reference
from tlsan_tpu_torch.serve.featurize import featurize_many
from tlsan_tpu_torch.serve.http import RecommendService, serve
from tlsan_tpu_torch.serve.recommender import Recommender
from tlsan_tpu_torch.train import checkpoint

SEED = 1234
KERNEL_TOL = 1e-5    # f32 parity, the bar of tests/test_pallas_fwa.py
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

KERNELS = [{"name": "fwa_fwd", "route": "cuda",
            "source": "tlsan_tpu_torch/csrc/fwa_fwd.cu",
            "replaces": "tlsan_tpu/ops/pallas/fwa.py:40"}]


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
    reports = build.build([cuda_fwa.SOURCE])
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
        cuda_fwa.launches = 0  # the main path starts here
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
        launches = cuda_fwa.launches  # the main path ends here
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_card()
    phase_build()
    k1 = phase_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        path = phase_path(tmp)
    kernels = [dict(KERNELS[0], launches=path["launches"],
                    max_abs_err=k1["max_abs_err"], ms=k1["ms"],
                    plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
                    bound_by=k1["bound_by"], library_ms=None)]
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
