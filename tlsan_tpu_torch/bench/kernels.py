"""Kernel microbenchmarks: K1/K2 and K3 against their plain versions, with
the HBM speed of light and the bound beside each row.

    python -m tlsan_tpu_torch.bench.kernels [--sol_gbps 3350] [--big_batch 8192]
        [--device cpu]

The counterpart of the JAX package's ``scripts/bench_kernels.py``, at its
shapes: the feature-wise attention at D=64, H=8 with B in {32, 512, 2048,
--big_batch} at S=10 and --big_batch at S=90; ATRank's self-attention at
T=90, D=64, H=8 with B in {32, 512, 2048}.  Rows:

  fwa.fwd.cuda   K1 (`ops/cuda/fwa.py::fwa_forward`)
  fwa.fwd.plain  `feature_wise_attention_reference`
  fwa.bwd.cuda   the gradient of the summed output with respect to x
                 through `FWAFunction` (K1 forward, K2 backward)
  fwa.bwd.plain  the same through autograd of the plain version
  mha.fwd.cuda   K3 (`ops/cuda/mha.py::mha_forward`, queries as keys)
  mha.fwd.plain  `multihead_attention_reference`
  mha.bwd.cuda   the gradients of the summed output with respect to the
                 queries and the eight weights through `MHAFunction` (K3
                 forward, K3b backward)
  mha.bwd.plain  the same through autograd of the plain version

Before any timing each kernel row's output is checked against its plain
row's at bench_kernels.py's tolerances (FWA 2e-5, MHA 3e-5; the weights'
gradients, sums over every row, to the tolerance times their largest
entry).  Timing keeps
bench_kernels.py's semantics: `REPS` (64) calls chained, each call's input made
from the last one's output so that no two overlap, the chain alone timed
the same way and subtracted, the best of 3 runs; on the card the runs are
timed with CUDA events, on the CPU with the host clock.  Bytes are
bench_kernels.py's (forward: x read and the output written; backward
three times that), `--sol_gbps` the card's HBM rate (3350 GB/s, the H100
SXM's), and each row also carries its bound from `bench/bounds.py`.  One
JSON row per line, then the table.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tlsan_tpu_torch.bench import bounds
from tlsan_tpu_torch.ops.feature_attention import (
    feature_wise_attention,
    feature_wise_attention_reference,
)
from tlsan_tpu_torch.ops.multihead_attention import (
    multihead_attention,
    multihead_attention_reference,
)
from tlsan_tpu_torch.serve.recommender import resolve_device

FWA_TOL, MHA_TOL = 2e-5, 3e-5
D, H = 64, 8
FWA_BATCHES, FWA_S, FWA_BIG_S = (32, 512, 2048), 10, 90  # and --big_batch
MHA_BATCHES, MHA_T = (32, 512, 2048), 90
REPS = 64  # chained calls a timed run


def _run_ms(fn, device: torch.device) -> float:
    """ms of one fn() call, ending when the device is done."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def chained_us(fn, x, chain, ident, device: torch.device):
    """(µs a call with the chain's floor subtracted, µs a call with it):
    REPS calls of fn chained through chain(c, fn(c)), against the same
    chain with ident(c) (an output-shaped slice of c) in place of fn."""
    def per_call_ms(f):
        def many():
            c = x
            for _ in range(REPS):
                c = chain(c, f(c))
            return c

        chain(x, f(x))  # load the kernel and warm
        return min(_run_ms(many, device) for _ in range(3)) / REPS

    raw = per_call_ms(fn)
    floor = per_call_ms(ident)
    return 1e3 * max(raw - floor, 1e-6), 1e3 * raw


def grad_of(f):
    """c → d(sum f(c))/dc."""
    def g(c):
        c = c.detach().requires_grad_(True)
        return torch.autograd.grad(f(c).sum(), c)[0]
    return g


def _tensor(a, device, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(device=device, dtype=dtype)


def _row(tag, B, seq_key, S, D, us, raw_us, nbytes, sol_gbps, bound, device):
    ms, by = bounds.bound_ms(bound)
    return {"kernel": tag, "B": B, seq_key: S, "D": D, "us": us, "raw_us": raw_us,
            "gbps": nbytes / us / 1e3, "sol_frac": nbytes / us / 1e3 / sol_gbps,
            "bound_us": 1e3 * ms, "bound_by": by, "device": device}


def _check(tag, got, want, tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), want.detach().cpu().numpy(),
                               atol=tol, rtol=tol, err_msg=tag)


def bench_fwa(B, S, sol_gbps, device, label):
    rng = np.random.default_rng(0)
    x = _tensor(rng.standard_normal((B, S, D)), device)
    lengths = _tensor(rng.integers(1, S + 1, B), device, torch.int32)
    dh = D // H
    w1 = _tensor(rng.standard_normal((dh, dh)) * 0.1, device)
    w2 = _tensor(rng.standard_normal((dh, dh)) * 0.1, device)
    b1 = torch.zeros(dh, device=device)
    b2 = torch.zeros(dh, device=device)

    def plain_f(x):
        return feature_wise_attention_reference(x, lengths, H, w1, b1, w2, b2)

    def cuda_f(x):  # FWAFunction on the card, the plain version on the CPU
        return feature_wise_attention(x, lengths, H, w1, b1, w2, b2)
    cuda_g, plain_g = grad_of(cuda_f), grad_of(plain_f)
    _check(f"fwa.fwd B={B} S={S}", cuda_f(x), plain_f(x), FWA_TOL)
    _check(f"fwa.bwd B={B} S={S}", cuda_g(x), plain_g(x), FWA_TOL)

    # fwd traffic: read x [B,S,D] + write out [B,D] (weights negligible)
    bytes_fwd = 4 * (B * S * D + B * D)
    fwd_bound = bounds.fwa_bound(B, S, D, H)
    bwd_bound = bounds.plus(fwd_bound, bounds.fwa_bwd_bound(B, S, D, H))

    # fwd chains out [B,D] back into x [B,S,D]; bwd's grad is x-shaped
    def chain_f(c, out):
        return c * 0.5 + 1e-3 * out[:, None, :]

    def chain_g(c, g):
        return c * 0.5 + 1e-3 * g

    def ident_f(c):
        return c[:, 0, :]  # out-shaped, negligible traffic

    def ident_g(c):
        return c * 1.0

    rows = []
    with torch.no_grad():
        for tag, fn, ch, idf, nbytes, bnd in (
                ("fwa.fwd.cuda", cuda_f, chain_f, ident_f, bytes_fwd, fwd_bound),
                ("fwa.fwd.plain", plain_f, chain_f, ident_f, bytes_fwd, fwd_bound)):
            us, raw = chained_us(fn, x, ch, idf, device)
            rows.append(_row(tag, B, "S", S, D, us, raw, nbytes, sol_gbps, bnd, label))
    for tag, fn in (("fwa.bwd.cuda", cuda_g), ("fwa.bwd.plain", plain_g)):
        us, raw = chained_us(fn, x, chain_g, ident_g, device)
        rows.append(_row(tag, B, "S", S, D, us, raw, 3 * bytes_fwd, sol_gbps,
                         bwd_bound, label))
    return rows


def bench_mha(B, T, sol_gbps, device, label):
    rng = np.random.default_rng(0)
    q = _tensor(rng.standard_normal((B, T, D)), device)
    ql = _tensor(rng.integers(1, T + 1, B), device, torch.int32)
    p = {}
    for nm in ("wq", "wk", "wv"):
        p[nm] = _tensor(rng.standard_normal((D, D)) * 0.1, device)
        p["b" + nm[1]] = torch.zeros(D, device=device)
    p["ln_gamma"], p["ln_beta"] = torch.ones(D, device=device), torch.zeros(D, device=device)

    def plain_f(q, w=p):
        return multihead_attention_reference(q, ql, q, ql, H, w)[0]

    def cuda_f(q, w=p):  # MHAFunction on the card, the plain version on the CPU
        return multihead_attention(q, ql, q, ql, H, w)

    def grads_of(f):
        """c → the gradients of sum f(c) with respect to c and every weight,
        all computed; the chain takes c's, or all of them with `every`."""
        def grads(c, every=False):
            c = c.detach().requires_grad_(True)
            w = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            out = torch.autograd.grad(f(c, w).sum(), [c, *w.values()])
            return out if every else out[0]
        return grads

    cuda_g, plain_g = grads_of(cuda_f), grads_of(plain_f)
    _check(f"mha.fwd B={B} T={T}", cuda_f(q), plain_f(q), MHA_TOL)
    got, want = cuda_g(q, every=True), plain_g(q, every=True)
    _check(f"mha.bwd B={B} T={T}", got[0], want[0], MHA_TOL)
    for name, a, b in zip(p, got[1:], want[1:]):
        np.testing.assert_allclose(
            a.detach().cpu().numpy(), b.detach().cpu().numpy(), rtol=MHA_TOL,
            atol=MHA_TOL * (1.0 + float(b.abs().max())), err_msg=f"mha.bwd B={B} T={T} {name}")

    bytes_fwd = 4 * (B * T * D * 2 + 3 * D * D)

    def chain(c, out):  # out and the gradient are q-shaped
        return c * 0.5 + 1e-3 * out

    def ident(c):
        return c * 1.0

    rows = []
    for tag, fn, nbytes, bnd in (
            ("mha.fwd.cuda", cuda_f, bytes_fwd, bounds.mha_bound(B, T, T, True, D)),
            ("mha.fwd.plain", plain_f, bytes_fwd, bounds.mha_bound(B, T, T, True, D)),
            ("mha.bwd.cuda", cuda_g, 3 * bytes_fwd, bounds.mha_grad_bound(B, T, D)),
            ("mha.bwd.plain", plain_g, 3 * bytes_fwd, bounds.mha_grad_bound(B, T, D))):
        with torch.set_grad_enabled(tag.startswith("mha.bwd")):
            us, raw = chained_us(fn, q, chain, ident, device)
        rows.append(_row(tag, B, "T", T, D, us, raw, nbytes, sol_gbps, bnd, label))
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sol_gbps", type=float, default=1e-9 * bounds.HBM_BYTES_PER_S,
                    help="HBM speed of light, GB/s (default: the H100 SXM's)")
    ap.add_argument("--big_batch", type=int, default=8192)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    torch.set_float32_matmul_precision("highest")  # TF32 off: the f32 contract
    label = bounds.device_label(device)
    print(f"device={label}", flush=True)
    rows = []
    # TLSAN's long-term window at the train batch and the large batches,
    # forward and backward
    for b in (*FWA_BATCHES, args.big_batch):
        rows += bench_fwa(b, FWA_S, args.sol_gbps, device, label)
    rows += bench_fwa(args.big_batch, FWA_BIG_S, args.sol_gbps, device, label)
    # ATRank's self-attention over the behaviour sequence
    for b in MHA_BATCHES:
        rows += bench_mha(b, MHA_T, args.sol_gbps, device, label)
    for r in rows:
        print(json.dumps(r), flush=True)
    hdr = (f"{'kernel':14s} {'shape':>16s} {'us':>9s} {'GB/s':>8s} {'SoL':>6s} "
           f"{'bound us':>9s}")
    print("\n" + hdr)
    for r in rows:
        shape = f"B{r['B']}xS{r.get('S', r.get('T'))}xD{r['D']}"
        print(f"{r['kernel']:14s} {shape:>16s} {r['us']:9.1f} {r['gbps']:8.1f} "
              f"{r['sol_frac']:6.1%} {r['bound_us']:9.3f} ({r['bound_by']})")
    return rows


if __name__ == "__main__":
    main()
