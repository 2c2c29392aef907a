"""The card's published peaks, the kernels' bounds, the train step's
byte model and the device-time reading (`device_profile`, `idle_share`).

A bound is the least time the H100 could take for a function: the larger
of the bytes it must move (each input read once, each output written once)
over the HBM rate and the operations it does over the f32 peak (TF32 is
off).  `chip_smoke.py` and the benchmark entry points both read them from
here.  The step's byte model is that of the JAX package's
``scripts/roofline.py:214-238``, written once as a function of the
configuration, the batch and the dense weights' bytes.
"""

from __future__ import annotations

import subprocess
import time
from typing import Dict, Iterable, Tuple

import torch

# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s and
# f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

D, H = 64, 8  # the reference widths: hidden units and heads

# TLSAN's vocab tables: what the roofline's byte model counts as tables,
# everything else as dense weights
TABLES = ("item_emb", "item_b", "user_emb", "usert_emb", "cate_emb")


def card_line(index: int = 0) -> str:
    """Card `index`'s name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def device_label(device: torch.device) -> str:
    """What a result ran on: the card's nvidia-smi line, or "cpu"."""
    if device.type != "cuda":
        return device.type
    return card_line(device.index if device.index is not None
                     else torch.cuda.current_device())


def device_profile(fn):
    """Run fn once under torch.profiler.  Returns (wall ms, {kernel name:
    (launches, device µs)}) for the kernels (and copies) that ran on the
    card.  The profiler's own cost inflates the wall time a little."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # summed from the raw device events: key_averages() builds the whole
    # host-and-device event tree first, some 30 s for a 70,000-launch chunk
    kernels = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            count, us = kernels.get(e.name(), (0, 0.0))
            kernels[e.name()] = (count + 1, us + 1e-3 * e.duration_ns())
    return wall_ms, kernels


def idle_share(wall_ms: float, kernels: dict) -> float:
    """1 − the device's kernel time over the wall time."""
    return 1.0 - 1e-3 * sum(us for _, us in kernels.values()) / wall_ms


def bound(nbytes: float, flops: float) -> Tuple[float, float]:
    """(bytes time, operations time) in ms, the least the H100 could take."""
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS_PER_S


def fwa_bound(B: int, S: int, d: int = D, h: int = H) -> Tuple[float, float]:
    """K1: each input read once and the output written once over HBM, and
    4·dh+9 f32 operations per (b, t, d) (two dh-wide maps, mask, max, exp,
    sum, divide, weighted sum) at the f32 peak."""
    dh = d // h
    nbytes = 4 * (B * S * d + B + 2 * dh * dh + 2 * dh + B * d)
    return bound(nbytes, B * S * d * (4 * dh + 9))


def fwa_bwd_bound(B: int, S: int, d: int = D, h: int = H) -> Tuple[float, float]:
    """K2: x, g, lengths and the weights read once, dx and the weight
    gradients written once, over HBM; and 12·dh+18 f32 operations per
    (b, t, d), counted from csrc/fwa_bwd.cu (the recomputed forward's
    4·dh+9, then dm1 and dx at 2·dh each, dW1 and dW2 at 2·dh each, and
    the softmax backward, mask and bias sums), at the f32 peak."""
    dh = d // h
    weights = 2 * dh * dh + 2 * dh
    nbytes = 4 * (2 * B * S * d + B * d + B + 2 * weights)
    return bound(nbytes, B * S * d * (12 * dh + 18))


def _mha_flops(B: int, Tq: int, Tk: int, d: int) -> int:
    """The multiply-adds of the three projections, (Tq + 2·Tk)·d² a row,
    and of the scores and the weighted sum, 2·Tq·Tk·d a row (for any
    number of heads), at two operations each."""
    return 2 * B * ((Tq + 2 * Tk) * d * d + 2 * Tq * Tk * d)


def mha_bound(B: int, Tq: int, Tk: int, self_attention: bool,
              d: int = D) -> Tuple[float, float]:
    """K3 at width d: queries (and keys, when they differ), the lengths and
    the weights read once and the output written once over HBM; and
    `_mha_flops` at the f32 peak."""
    inputs = B * Tq * d + (0 if self_attention else B * Tk * d)
    nbytes = 4 * (inputs + 2 * B + 3 * d * d + 5 * d + B * Tq * d)
    return bound(nbytes, _mha_flops(B, Tq, Tk, d))


def mha_grad_bound(B: int, T: int, d: int = D) -> Tuple[float, float]:
    """The gradient of self-attention's summed output with respect to its
    queries (K3's forward, then the plain recompute's backward): the
    queries, lengths, weights and the output's gradient read once and the
    queries' gradient written once; three times the forward's operations
    (a backward does two products for each of the forward's)."""
    nbytes = 4 * (3 * B * T * d + 2 * B + 3 * d * d + 5 * d)
    return bound(nbytes, 3 * _mha_flops(B, T, T, d))


def plus(*bounds: Tuple[float, float]) -> Tuple[float, float]:
    """The bound of functions run one after another: times summed."""
    return tuple(sum(b[i] for b in bounds) for i in range(2))


def bound_ms(b: Tuple[float, float]) -> Tuple[float, str]:
    """(the bound in ms, "bytes" or "operations": which of the two sets it)."""
    return max(b), "bytes" if b[0] >= b[1] else "operations"


# ------------------------------------------------------------ the train step


def dense_weight_bytes(named_sizes: Iterable[Tuple[str, int]]) -> int:
    """f32 bytes of the weights that are not vocab tables, from (name,
    number of entries) pairs, as the roofline counts them."""
    return sum(4 * n for name, n in named_sizes
               if not any(t in name for t in TABLES))


def step_bytes(cfg, B: int, Ls: int, Ts: int, dense_w_bytes: int) -> Dict[str, int]:
    """The algorithmic HBM bytes of one TLSAN train step of batch B
    (``scripts/roofline.py:214-238``):

      table     the vocab tables: item_emb and item_b, user_emb and
                usert_emb, cate_emb;
      touched   the rows a step gathers: B·(Ls + Ts + 1) item slots and B
                user slots of D + 1 floats, and two user rows of D;
      batch     the packed batch: u, i, y, c, sl, sl_new, hist_i and
                hist_t [Ls], hist_i_new [Ts], four bytes each;
      act       six [B, Ls + Ts, 2·D] activations;
      dense     the dense step: the table gradients' scatter writes [V, D],
                the clip reads it and the update reads gradient and table
                and writes the table (5 table passes), the dense weights 4
                times, the touched rows and the batch;
      minimal   the touched-row floor: touched rows read, written and
                their gradients, the dense weights 4 times, the batch and
                the activations."""
    D = cfg.itemid_embedding_size
    table = 4 * (cfg.item_count * (D + 1) + cfg.user_count * D * 2
                 + cfg.cate_count * D)
    touched_slots = B * (Ls + Ts + 1) + B
    touched = touched_slots * (D + 1) * 4 + B * D * 2 * 4
    batch = 4 * B * (6 + 2 * Ls + Ts)
    act = 4 * B * (Ls + Ts) * (2 * D) * 6
    return {"table": table, "dense_weights": dense_w_bytes,
            "touched": touched, "batch": batch, "act": act,
            "dense": 5 * table + 4 * dense_w_bytes + touched + batch,
            "minimal": 3 * touched + 4 * dense_w_bytes + batch + act}
