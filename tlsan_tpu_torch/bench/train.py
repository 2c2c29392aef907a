"""Benchmark: TLSAN training throughput (examples/s) of the port.

    python -m tlsan_tpu_torch.bench.train [--dataset Digital_Music] [--batch 32]
        [--steps 2000] [--steps_per_call 200] [--baseline_steps 200]
        [--compute_dtype f32|bf16] [--plain] [--device cpu]

The counterpart of the JAX package's ``bench.py``.  It prints per-repeat
lines to stderr and one JSON line last on stdout, with bench.py's keys
(``metric``, ``value``, ``unit``, ``vs_baseline``,
``vs_reference_measured``) and two more: ``device``, the card's name and
power limit, and ``launches``, the K1/K2 launches of the timed repeats
(with ``fwa_plain``, the calls of ``--plain``'s plain FWA, and
``steps``).

The fused path is the port's Trainer: the packed set lives on the device,
a fixed [K, B] index from ``np.random.default_rng(0)`` feeds
`Trainer._train_chunk` (each step TLSAN.loss through K1 and, under
autograd, K2, then the Trainer's optimizer step; ``--compute_dtype bf16``
runs the loss on bf16 copies), a warm-up chunk, then three repeats of
``--steps`` steps on the host clock, each ending in a device sync; the
best of the three counts.  The baseline emulates the reference's
``feed_dict``: the Trainer's step on the CPU, one step a call, each
batch sliced from the host arrays and made tensors at its step;
``vs_baseline`` is fused / baseline.  ``vs_reference_measured`` is null:
bench.py's anchor is the reference TF program's rate in another
environment, and the port states no rate it did not take.

``--plain`` runs the plain FWA (autograd for the backward) on the card in
place of K1/K2, the A/B that bench.py's ``--pallas`` gives, and adds
``_plain`` to the metric: for the timed chunks only, this process swaps
TLSAN's FWA call for `plain_fwa`, which counts its calls; the shared
dispatcher is not touched.  bench.py's ``--unroll`` has no counterpart:
the port's chunk is a Python loop, not a ``lax.scan``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from tlsan_tpu_torch.bench.bounds import device_label
from tlsan_tpu_torch.bench.data import configs, load_packed
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.data.batcher import Batches
from tlsan_tpu_torch.models import tlsan
from tlsan_tpu_torch.models.tlsan import TLSAN
from tlsan_tpu_torch.ops.feature_attention import (
    draw_masks,
    feature_wise_attention_reference,
)
from tlsan_tpu_torch.ops.cuda import fwa as cuda_fwa
from tlsan_tpu_torch.serve.recommender import resolve_device
from tlsan_tpu_torch.train.loop import Trainer


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_trainer(arrays: Dict[str, np.ndarray], cate_list: np.ndarray,
                 cfg: ModelConfig, tc: TrainConfig, device) -> Trainer:
    """A TLSAN Trainer on the packed set, with an empty test set (the
    benchmarks never evaluate).  tc.model_dir must be a directory the
    Trainer may write into."""
    n = len(arrays["u"])
    empty = Batches({k: v[:0] for k, v in arrays.items()}, 0)
    return Trainer(TLSAN, cfg, tc, cate_list, Batches(arrays, n), empty,
                   device=device)


# calls of `plain_fwa`, the --plain stand-in for K1/K2
plain_calls = 0


def plain_fwa(x, lengths, num_heads: int, w1, b1, w2, b2,
              dropout_rate: float = 0.0, generator=None):
    """`feature_wise_attention`'s function through its plain version on
    any device (autograd for the backward): f32 between casts, the masks
    drawn as the dispatcher draws them."""
    global plain_calls
    plain_calls += 1
    dtype = x.dtype
    x, w1, b1, w2, b2 = (t.float() for t in (x, w1, b1, w2, b2))
    masks = draw_masks(x, num_heads, dropout_rate, generator)
    return feature_wise_attention_reference(
        x, lengths, num_heads, w1, b1, w2, b2, dropout_rate=dropout_rate,
        keep_masks=masks).to(dtype)


@contextlib.contextmanager
def plain_tlsan():
    """TLSAN's FWA calls go to `plain_fwa` in the enclosed code."""
    kernel = tlsan.feature_wise_attention
    tlsan.feature_wise_attention = plain_fwa
    try:
        yield
    finally:
        tlsan.feature_wise_attention = kernel


def launch_counts() -> Dict[str, int]:
    return {"fwa_fwd": cuda_fwa.launches, "fwa_bwd": cuda_fwa.bwd_launches,
            "fwa_plain": plain_calls}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fused(tr: Trainer, idx: torch.Tensor, steps: int):
    """examples/s of the best of three repeats of `steps` steps (whole
    chunks of idx) after a warm-up chunk, and the launches of the
    repeats."""
    K, B = idx.shape
    tr._train_chunk(idx)
    sync(tr.device)
    before = launch_counts()
    rates, done_all = [], 0
    for rep in range(3):
        t0 = time.perf_counter()
        done = 0
        while done < steps:
            losses = tr._train_chunk(idx)
            done += K
        sync(tr.device)
        dt = time.perf_counter() - t0
        rates.append(done * B / dt)
        done_all += done
        log(f"fused rep{rep}: {done} steps in {dt:.3f}s -> "
            f"{rates[-1]:,.0f} examples/s (loss {float(losses[-1]):.4f})")
    after = launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    launches["steps"] = done_all
    return max(rates), launches


def baseline(tr: Trainer, arrays: Dict[str, np.ndarray], steps: int) -> float:
    """examples/s of one CPU step a call, each batch sliced from the host
    arrays and made tensors at its step (the reference's feed_dict)."""
    n, B = len(arrays["u"]), tr.tc.train_batch_size

    def feed(step_i):
        lo = (step_i * B) % (n - B)
        return {k: torch.tensor(v[lo:lo + B]) for k, v in arrays.items()}

    tr._train_step(feed(0))
    t0 = time.perf_counter()
    for s in range(steps):
        tr._train_step(feed(s))
    dt = time.perf_counter() - t0
    eps = steps * B / dt
    log(f"baseline (per-step CPU): {steps} steps in {dt:.3f}s "
        f"-> {eps:,.0f} examples/s")
    return eps


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="Digital_Music")
    p.add_argument("--data_dir", default="Data",
                   help="holds <dataset>.npz, read when the cache is absent")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--steps_per_call", type=int, default=200)
    p.add_argument("--baseline_steps", type=int, default=200)
    p.add_argument("--compute_dtype", choices=["f32", "bf16"], default="f32")
    p.add_argument("--plain", action="store_true",
                   help="A/B: the plain FWA on the card in place of K1/K2")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    device = resolve_device(args.device)  # raise before loading anything
    arrays, cate_list = load_packed(args.dataset, args.data_dir)
    n = len(arrays["u"])
    K, B = args.steps_per_call, args.batch
    cfg, tc = configs(arrays, cate_list, B, K, sparse_updates=False,
                      compute_dtype=args.compute_dtype)
    log(f"dataset={args.dataset} n={n} users={cfg.user_count} "
        f"items={cfg.item_count} cates={cfg.cate_count} device={device}")
    idx = torch.from_numpy(
        np.random.default_rng(0).integers(0, n, (K, B)).astype(np.int32)).to(device)
    plain = plain_tlsan() if args.plain else contextlib.nullcontext()
    with tempfile.TemporaryDirectory() as tmp:
        tr = make_trainer(arrays, cate_list, cfg,
                          dataclasses.replace(tc, model_dir=f"{tmp}/fused"), device)
        with plain:
            fused_eps, launches = fused(tr, idx, args.steps)
        tr.close()
        base = make_trainer(arrays, cate_list, cfg, dataclasses.replace(
            tc, model_dir=f"{tmp}/baseline", compute_dtype="f32"), "cpu")
        base_eps = baseline(base, arrays, args.baseline_steps)
        base.close()
    metric = (f"tlsan_train_examples_per_sec_{args.dataset}_b{B}"
              + ("_bf16" if args.compute_dtype == "bf16" else "")
              + ("_plain" if args.plain else ""))
    line = {"metric": metric, "value": round(fused_eps, 1), "unit": "examples/s",
            "vs_baseline": round(fused_eps / base_eps, 2),
            "vs_reference_measured": None, "device": device_label(device),
            "launches": launches}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
