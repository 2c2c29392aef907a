"""Whole-step roofline of the TLSAN train step on the card.

    python -m tlsan_tpu_torch.bench.roofline [--dataset Digital_Music] [--batch 32]
        [--steps_per_call 200] [--sparse] [--compute_dtype f32|bf16] [--device cpu]

The counterpart of the JAX package's ``scripts/roofline.py``: it splits
the port's train step into stages, times each as a chunk of K steps on
the packed set (``bench/data.py``), and compares the step's time with its
algorithmic HBM bytes (``bench/bounds.py::step_bytes``) at the card's
rate.  Stages, each a chunk of the Trainer's own calls:

  gathers    the batch gathers and the embedding-row lookups only
  fwd        TLSAN.loss (K1) without autograd
  fwd+bwd    the loss and its backward (K1, K2), the gradients summed
  full       `Trainer._train_chunk`: the step with the optimizer
  sparse     with ``--sparse``: the touched-row chunk (train/sparse.py)

Each stage's cost a step is the slope between chunks of K and 3K steps,
(t(3K) − t(K)) / 2K, the best of 3 runs each (after a warm-up chunk of K)
on the host clock ending in a device sync: the fixed cost of a chunk
cancels.  The last line is one JSON
object with the JAX script's keys, ``idle_share`` (one full chunk under
`torch.profiler`: 1 − the device's kernel time over the wall time; null
on the CPU) and ``device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time

import numpy as np
import torch

from tlsan_tpu_torch.bench.bounds import (
    HBM_BYTES_PER_S,
    dense_weight_bytes,
    device_label,
    device_profile,
    idle_share,
    step_bytes,
)
from tlsan_tpu_torch.bench.data import configs, load_packed
from tlsan_tpu_torch.bench.train import make_trainer, sync
from tlsan_tpu_torch.nn.embedding import lookup
from tlsan_tpu_torch.serve.recommender import resolve_device


def best_s(fn, device: torch.device, reps: int = 3) -> float:
    """Best-of-reps wall seconds of fn(), each ending in a device sync."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _batch(tr, ib):
    return {k: v[ib] for k, v in tr.train_data.items()}


@torch.no_grad()
def chunk_gather(tr, idx):
    m, acc = tr.model, torch.zeros((), device=tr.device)
    for ib in idx:
        b = _batch(tr, ib)
        acc = acc + (lookup(m.item_emb, b["hist_i"]).sum()
                     + lookup(m.item_emb, b["hist_i_new"]).sum()
                     + lookup(m.item_emb, b["i"]).sum()
                     + lookup(m.user_emb, b["u"]).sum()
                     + lookup(m.usert_emb, b["u"]).sum()
                     + lookup(m.cate_emb, tr.cate_list[b["hist_i"]]).sum())
    return acc


@torch.no_grad()
def chunk_fwd(tr, idx):
    acc = torch.zeros((), device=tr.device)
    for ib in idx:
        acc = acc + tr._forward("loss", _batch(tr, ib), tr._masks)
    return acc


def chunk_fwd_bwd(tr, idx):
    loss_acc = grad_acc = torch.zeros((), device=tr.device)
    for ib in idx:
        for p in tr.params:
            p.grad = None
        loss = tr._forward("loss", _batch(tr, ib), tr._masks)
        loss.backward()
        loss_acc = loss_acc + loss.detach()
        grad_acc = grad_acc + sum(p.grad.sum() for p in tr.params if p.grad is not None)
    return loss_acc, grad_acc


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="Digital_Music")
    p.add_argument("--data_dir", default="Data",
                   help="holds <dataset>.npz, read when the cache is absent")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps_per_call", type=int, default=200)
    p.add_argument("--sparse", action="store_true",
                   help="also time the touched-row chunk")
    p.add_argument("--compute_dtype", choices=["f32", "bf16"], default="f32")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    arrays, cate_list = load_packed(args.dataset, args.data_dir)
    n = len(arrays["u"])
    K, B = args.steps_per_call, args.batch
    cfg, tc = configs(arrays, cate_list, B, K, sparse_updates=False,
                      compute_dtype=args.compute_dtype)
    label = device_label(device)
    print(f"# roofline: {args.dataset} b{B} K={K} device={label} "
          f"users={cfg.user_count} items={cfg.item_count} cates={cfg.cate_count}",
          flush=True)
    rng = np.random.default_rng(0)
    idx1, idx2 = (torch.from_numpy(rng.integers(0, n, (k, B)).astype(np.int32)).to(device)
                  for k in (K, 3 * K))

    def slope(run):
        """(s a step, s fixed a chunk) from t(K) = fixed + K·step, after a
        warm-up chunk."""
        run(idx1)
        sync(device)
        t1, t2 = best_s(lambda: run(idx1), device), best_s(lambda: run(idx2), device)
        b = (t2 - t1) / (2 * K)
        return b, t1 - b * K

    with tempfile.TemporaryDirectory() as tmp:
        tr = make_trainer(arrays, cate_list, cfg,
                          dataclasses.replace(tc, model_dir=f"{tmp}/dense"), device)
        t_gather, fix_g = slope(lambda i: chunk_gather(tr, i))
        t_fwd, _ = slope(lambda i: chunk_fwd(tr, i))
        t_fwdbwd, _ = slope(lambda i: chunk_fwd_bwd(tr, i))
        t_full, fix_full = slope(tr._train_chunk)
        idle = None
        if device.type == "cuda":
            idle = idle_share(*device_profile(lambda: tr._train_chunk(idx1)))
        tr.close()
        t_sparse = None
        if args.sparse:
            sp = make_trainer(arrays, cate_list, cfg, dataclasses.replace(
                tc, model_dir=f"{tmp}/sparse", sparse_updates=True), device)
            t_sparse, _ = slope(sp._train_chunk)
            sp.close()
    print(f"# fixed per-chunk overhead: {fix_full * 1e3:.1f} ms full / "
          f"{fix_g * 1e3:.1f} ms gather-only", flush=True)

    by = step_bytes(cfg, B, cfg.Ls, cfg.Ts, dense_weight_bytes(
        (name, p.numel()) for name, p in tr.model.named_parameters()))

    def pct_sol(nbytes, t_step):
        return nbytes / t_step / HBM_BYTES_PER_S * 100

    def row(name, t_step, nbytes=None):
        out = f"| {name} | {t_step * 1e6:8.1f} |"
        if nbytes is None:
            return out + " — | — |"
        return out + f" {nbytes / 1e6:7.3f} | {pct_sol(nbytes, t_step):5.1f}% |"

    eps = B / t_full
    print(f"\n## whole-step roofline — {args.dataset} b{B} ({eps:,.0f} ex/s full "
          f"step; {label})\n")
    print("| stage | µs/step | MB/step (algorithmic) | % HBM SoL |")
    print("|---|---|---|---|")
    print(row("embedding gathers", t_gather, by["touched"] + by["batch"]))
    print(row("attention + logits fwd (Δ)", t_fwd - t_gather))
    print(row("backward (Δ)", t_fwdbwd - t_fwd))
    print(row("optimizer + dense table grads (Δ)", t_full - t_fwdbwd,
              5 * by["table"] + 4 * by["dense_weights"]))
    print(row("FULL dense step", t_full, by["dense"]))
    if t_sparse is not None:
        print(row("FULL sparse step", t_sparse, by["minimal"]))
    sol_s = by["minimal"] / HBM_BYTES_PER_S
    print(f"\nminimal algorithmic bytes/step (sparse floor): {by['minimal'] / 1e6:.3f} "
          f"MB -> speed of light {sol_s * 1e6:.2f} µs/step ({B / sol_s:,.0f} ex/s)")
    line = {
        "metric": f"roofline_{args.dataset}_b{B}",
        "full_us_per_step": t_full * 1e6,
        "gather_us": t_gather * 1e6,
        "fwd_delta_us": (t_fwd - t_gather) * 1e6,
        "bwd_delta_us": (t_fwdbwd - t_fwd) * 1e6,
        "opt_delta_us": (t_full - t_fwdbwd) * 1e6,
        "sparse_us_per_step": None if t_sparse is None else t_sparse * 1e6,
        "dense_bytes_mb": by["dense"] / 1e6,
        "minimal_bytes_mb": by["minimal"] / 1e6,
        "full_pct_hbm_sol": pct_sol(by["dense"], t_full),
        "examples_per_s": eps,
        "idle_share": idle,
        "device": label,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
