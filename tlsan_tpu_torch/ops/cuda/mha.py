"""PyTorch wrapper of the CUDA multi-head attention kernel.

K3 (``csrc/mha_fwd.cu``, `mha_forward`) replaces
``tlsan_tpu/ops/pallas/mha.py::_mha_kernel``.  Its plain version is
``ops/multihead_attention.py::multihead_attention_reference``.
`MHAFunction` puts it under autograd as ``jax.custom_vjp`` puts
``_mha_forward``: the forward is K3, and the backward recomputes the plain
version and differentiates it, as ``_mha_bwd`` re-runs the jnp reference
through ``jax.vjp`` (the JAX package has no backward kernel).  The wrapper
checks what the kernel takes and raises on anything else; it never falls
back to the plain version, nor to another cluster size when the card
refuses a launch.  ``launches`` counts the kernel's launches in this
process.

A thread-block cluster of `launch_plan`'s cs CTAs shares each batch row
(pure Python, so the CPU tests hold it): the largest cluster size whose B
clusters the card runs at once, by `ACTIVE_CLUSTERS`.  The kernel takes
heads of up to
`MAX_HEAD_WIDTH` features, D up to `MAX_D` and a multiple of 4, up to
`MAX_KEYS` keys, and as many query rows as one CTA's shared memory holds
(at D = 64: Tq and Tk up to 256, and past it for Tq); anything else raises
ValueError naming the limit.

K3 takes a leading replica axis of weights: R parameter sets, each with
its own rows (queries [R, B, Tq, D], ..., wq [R, D, D], bq [R, D]), in one
launch whatever R is; the R·B rows share one launch plan.  Under
``torch.func.vmap`` (the replica fan-out, train/ensemble.py)
`MHAFunction`'s vmap rule moves the replica axis to the front, expands
what is shared and applies `MHAFunction` itself to the replica axis: one
K3 launch forward, and a backward that recomputes the plain version under
vmap and differentiates it.  A CUDA tensor under
vmap launches the replica kernel or raises; nothing loops over the
replicas.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from tlsan_tpu_torch.ops.cuda import build
from tlsan_tpu_torch.ops.cuda.common import (
    SMEM_LIMIT,
    check_tensor,
    launch,
    replica_first,
)

SOURCE = "mha_fwd"
# the weight arguments of `mha_forward`, in order, by their JAX names
WEIGHTS = ("wq", "bq", "wk", "bk", "wv", "bv", "ln_gamma", "ln_beta")

CLUSTER_SIZES = (1, 2, 4, 8)  # the portable cluster sizes
THREADS = 256                 # kThreads in csrc/mha_fwd.cu
PER_LANE = 8                  # kPerLane: scores a lane holds
PAD = 4                       # kPad: floats after each Q, K, V row
W_CHUNK = 12_288              # kWChunk: floats of weights staged at once
MAX_HEAD_WIDTH = 32           # kMaxDh
MAX_D = 256                   # kMaxLnPerLane · 32: LayerNorm's lanes
MAX_KEYS = 32 * PER_LANE      # a group of a warp's lanes
# an SM holds two CTAs by registers (128 a thread, __launch_bounds__(256,
# 2)) and as many as fit its 233,472 bytes of shared memory, 1,024 of them
# reserved a CTA
SM_SMEM, CTA_RESERVED, CTAS_BY_REGISTERS = 233_472, 1_024, 2
# the clusters of cs CTAs the H100 runs at once, by CTAs an SM holds:
# cudaOccupancyMaxActiveClusters on the card (csrc/mha_fwd.cu's
# mha_fwd_active_clusters; chip_smoke.py checks this table against it).
# A cluster's CTAs share one GPC, so 8-CTA clusters leave SMs idle
ACTIVE_CLUSTERS = {(1, 1): 132, (2, 1): 66, (4, 1): 30, (8, 1): 15,
                   (1, 2): 264, (2, 2): 132, (4, 2): 62, (8, 2): 30}

launches = 0

_F32 = torch.float32
_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: `grid` = B·`cs` CTAs of `threads` threads in clusters of
    `cs`, one cluster a batch row; `group` lanes take a (query row, head)
    (for Tq = 1, a head over the CTA's keys); `smem` bytes of dynamic
    shared memory a CTA."""
    dh: int
    cs: int
    grid: int
    threads: int
    group: int
    smem: int


def _weight_chunk(D: int) -> int:
    """Rows of the weights K3 stages at once (weight_chunk in the source):
    all D up to 64, else a multiple of 4 filling W_CHUNK floats."""
    return min(D, W_CHUNK // (3 * D) // 4 * 4)


def _smem(Tq: int, Tk: int, D: int, num_heads: int, cs: int,
          self_attention: bool = False) -> int:
    """Bytes of csrc/mha_fwd.cu's layout: biases, γ and β, the CTA's q and
    k slices (one for self-attention), its Q, K and V rows; then for Tq > 1
    the full copies of K and V (holding the staged weights before them),
    for Tq = 1 the cluster's exchange, the CTA's scores and the staged
    weights."""
    split = Tq == 1
    nq, nk = (1 if split else -(-Tq // cs)), -(-Tk // cs)
    ld = D + PAD
    weights = 3 * _weight_chunk(D) * D
    alias = self_attention and Tq == Tk and not split
    floats = 5 * D + (nq + (0 if alias else nk)) * D + nq * ld + 2 * nk * ld
    if split:
        floats += -(-(2 * num_heads + D + num_heads * nk) // 4) * 4 + weights
    else:
        floats += max(2 * Tk * ld, weights)
    return 4 * floats


def ctas_per_sm(smem: int) -> int:
    return min(CTAS_BY_REGISTERS, SM_SMEM // (smem + CTA_RESERVED))


@functools.lru_cache(maxsize=512)
def launch_plan(B: int, Tq: int, Tk: int, D: int, num_heads: int,
                self_attention: bool = False) -> Plan:
    """The geometry of K3 for queries [B, Tq, D] and keys [B, Tk, D] in
    `num_heads` heads (`self_attention`: keys is queries, one slice of
    shared memory for both): the largest cluster size whose CTA fits in
    shared memory and whose B clusters the card runs at once
    (ACTIVE_CLUSTERS), or, when B is too large for one wave, the smallest
    that fits.  Raises ValueError for what the kernel refuses."""
    if B < 1 or Tq < 1 or Tk < 1 or num_heads < 1 or D % num_heads:
        raise ValueError(
            f"K3 needs B, Tq, Tk >= 1 and D % num_heads == 0; got B={B}, "
            f"Tq={Tq}, Tk={Tk}, D={D}, num_heads={num_heads}")
    dh = D // num_heads
    if dh > MAX_HEAD_WIDTH:
        raise ValueError(
            f"K3 takes heads of at most {MAX_HEAD_WIDTH} features; got D={D}, "
            f"num_heads={num_heads} (dh={dh})")
    if D > MAX_D or D % 4:
        raise ValueError(
            f"K3 takes D of at most {MAX_D} and a multiple of 4; got D={D}")
    if Tk > MAX_KEYS:
        raise ValueError(f"K3 takes at most {MAX_KEYS} keys; got Tk={Tk}")
    smem = {cs: _smem(Tq, Tk, D, num_heads, cs, self_attention)
            for cs in CLUSTER_SIZES}
    fits = [cs for cs in CLUSTER_SIZES if smem[cs] <= SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"K3 at Tq={Tq}, Tk={Tk}, D={D} needs {smem[CLUSTER_SIZES[-1]]} "
            f"bytes of shared memory a CTA at the largest cluster "
            f"({CLUSTER_SIZES[-1]}), above the card's {SMEM_LIMIT} (at D=64 "
            "it takes Tq and Tk up to 256)")
    one_wave = [cs for cs in fits
                if B <= ACTIVE_CLUSTERS[cs, ctas_per_sm(smem[cs])]]
    cs = max(one_wave) if one_wave else fits[0]
    keys = -(-Tk // cs) if Tq == 1 else Tk
    group = 1
    while group * PER_LANE < keys:
        group *= 2
    return Plan(dh, cs, B * cs, THREADS, group, smem[cs])


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if lib.mha_fwd_launch.argtypes is None:
        lib.mha_fwd_launch.argtypes = (
            [ctypes.c_void_p] * 13 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        lib.mha_fwd_launch.restype = ctypes.c_int
        lib.mha_fwd_active_clusters.argtypes = [ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p]
        lib.mha_fwd_active_clusters.restype = ctypes.c_int
        lib.mha_error_string.argtypes = [ctypes.c_int]
        lib.mha_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(fn: str, queries, keys, q_len, k_len, weights):
    """One pass over the tensors: device, dtype, shape, contiguity and the
    16-byte alignment of the float rows the kernel reads as float4.
    Returns (lead, B, Tq, Tk, D), `lead` () for one replica or (R,) for a
    replica axis that every tensor leads with."""
    if queries.device.type != "cuda":
        raise ValueError(f"{fn} runs on CUDA tensors, queries is on {queries.device}")
    if queries.dim() not in (3, 4) or keys.dim() != queries.dim():
        raise ValueError(f"{fn}: queries and keys must be [B, T, D] or "
                         f"[R, B, T, D], got {tuple(queries.shape)} and "
                         f"{tuple(keys.shape)}")
    lead = tuple(queries.shape[:-3])
    B, Tq, D = queries.shape[-3:]
    Tk = keys.shape[-2]
    index = queries.get_device()
    todo = [("queries", queries, _F32, lead + (B, Tq, D)),
            ("keys", keys, _F32, lead + (B, Tk, D)),
            ("q_len", q_len, _I32, lead + (B,)), ("k_len", k_len, _I32, lead + (B,))]
    todo += [(name, w, _F32, lead + ((D, D) if name.startswith("w") else (D,)))
             for name, w in zip(WEIGHTS, weights)]
    for name, t, dtype, shape in todo:
        if (t.get_device() != index or t.dtype is not dtype or t.shape != shape
                or not t.is_contiguous()):
            check_tensor(fn, name, t, dtype, shape, queries.device)
        if dtype is _F32 and t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must start on a 16-byte boundary")
    return lead, B, Tq, Tk, D


def mha_forward(queries: torch.Tensor, keys: torch.Tensor, q_len: torch.Tensor,
                k_len: torch.Tensor, num_heads: int, wq, bq, wk, bk, wv, bv,
                ln_gamma, ln_beta) -> torch.Tensor:
    """K3.  queries f32 [B, Tq, D], keys f32 [B, Tk, D] (the same tensor
    for self-attention), q_len and k_len i32 [B], wq/wk/wv f32 [D, D],
    bq/bk/bv/ln_gamma/ln_beta f32 [D], all contiguous on one CUDA device →
    out f32 [B, Tq, D]; or every tensor with a leading replica axis R
    (queries [R, B, Tq, D], ..., wq [R, D, D], out [R, B, Tq, D]), R
    replicas in one launch of R·B rows.  Records no gradient:
    `MHAFunction` does."""
    global launches
    weights = (wq, bq, wk, bk, wv, bv, ln_gamma, ln_beta)
    lead, B, Tq, Tk, D = _check_inputs("mha_forward", queries, keys, q_len, k_len,
                                       weights)
    out = queries.new_empty(lead + (B, Tq, D))
    rows = math.prod(lead) * B  # R·B
    if rows == 0:
        return out
    # the kernel shares one slice for queries and keys when they are one
    # tensor, as here
    plan = launch_plan(rows, Tq, Tk, D, num_heads, queries.data_ptr() == keys.data_ptr())
    lib = _library()
    err = launch(queries.get_device(), lambda stream: lib.mha_fwd_launch(
        queries.data_ptr(), keys.data_ptr(), q_len.data_ptr(), k_len.data_ptr(),
        *(t.data_ptr() for t in weights), out.data_ptr(), Tq, Tk, D, num_heads,
        plan.dh, plan.cs, plan.group, B, plan.grid, plan.threads, plan.smem, stream))
    if err != 0:
        raise RuntimeError(
            f"mha_fwd launch failed (cluster of {plan.cs}, {plan.smem} bytes of "
            f"shared memory a CTA): {lib.mha_error_string(err).decode()}")
    launches += 1
    return out


class MHAFunction(torch.autograd.Function):
    """Multi-head attention with K3 forward.  Like the JAX custom_vjp, it
    saves only the inputs and recomputes in the backward, through the
    plain version under autograd.  Arguments are those of `mha_forward`;
    q_len, k_len and num_heads get no gradient; with or without the
    replica axis.  For self-attention (queries is keys) the two gradients
    are summed by autograd.  Under ``torch.func.vmap`` its vmap rule
    applies it to the replica axis."""

    @staticmethod
    def forward(queries, keys, q_len, k_len, num_heads, *weights):
        return mha_forward(queries, keys, q_len, k_len, num_heads, *weights)

    @staticmethod
    def setup_context(ctx, inputs, output):
        queries, keys, q_len, k_len, num_heads, *weights = inputs
        ctx.num_heads = num_heads
        ctx.save_for_backward(queries, keys, q_len, k_len, *weights)

    @staticmethod
    def backward(ctx, g):
        # imported here: ops/multihead_attention.py imports this module
        from tlsan_tpu_torch.ops.multihead_attention import (
            multihead_attention_reference,
        )

        def plain(q, k, ql, kl, *ws):
            return multihead_attention_reference(q, ql, k, kl, ctx.num_heads,
                                                 dict(zip(WEIGHTS, ws)))[0]

        queries, keys, q_len, k_len, *weights = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in (queries, keys, *weights)]
            # the replica axis, where there is one, under vmap
            fn = torch.func.vmap(plain) if queries.dim() == 4 else plain
            grads = torch.autograd.grad(
                fn(leaves[0], leaves[1], q_len, k_len, *leaves[2:]), leaves, g)
        return (grads[0], grads[1], None, None, None, *grads[2:])

    @staticmethod
    def vmap(info, in_dims, queries, keys, q_len, k_len, num_heads, *weights):
        R = info.batch_size
        # self-attention passes one tensor as queries and keys: the kernel
        # (and its plan) read that from the pointers, so it stays one tensor
        same = (in_dims[0] == in_dims[1] and queries.shape == keys.shape
                and queries.stride() == keys.stride()
                and queries.data_ptr() == keys.data_ptr())
        queries = replica_first(queries, in_dims[0], R)
        keys = queries if same else replica_first(keys, in_dims[1], R)
        q_len, k_len, *weights = (
            replica_first(t, d, R) for t, d in zip((q_len, k_len, *weights),
                                              in_dims[2:4] + in_dims[5:]))
        return MHAFunction.apply(queries, keys, q_len, k_len, num_heads, *weights), 0
