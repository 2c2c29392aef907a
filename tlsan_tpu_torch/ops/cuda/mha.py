"""PyTorch wrappers of the CUDA multi-head attention kernels.

K3 (``csrc/mha_fwd.cu``, `mha_forward`) replaces
``tlsan_tpu/ops/pallas/mha.py::_mha_kernel``; K3b (``csrc/mha_bwd.cu``,
`mha_backward`) replaces ``_mha_bwd``, which is ``jax.vjp`` of the jnp
reference (the JAX package has no backward kernel).  Their plain versions
are ``ops/multihead_attention.py``'s ``multihead_attention_reference`` and
``multihead_attention_backward_reference``.  `MHAFunction` ties them
together for autograd, as ``jax.custom_vjp`` ties ``_mha_fwd`` and
``_mha_bwd``: it saves only the inputs, and K3b recomputes the forward.
The wrappers check what the kernels take and raise on anything else; they
never fall back to the plain versions, nor to another cluster size when
the card refuses a launch.  ``launches`` and ``bwd_launches`` count each
kernel's launches in this process.

A thread-block cluster of `launch_plan`'s cs CTAs shares each batch row
of K3 (pure Python, so the CPU tests hold it): the largest cluster size
whose B clusters the card runs at once, by `ACTIVE_CLUSTERS`.  K3's
row-split variants take heads of up to `MAX_HEAD_WIDTH` features, D up to
`MAX_D` and as many query rows as one CTA's shared memory holds (at D =
64: Tq and Tk up to 256, and past it for Tq); its wide variant takes the
rest (a cluster a row split by heads, the arrays in shared memory where
they fit and in device memory past it): D up to `WIDE_MAX_D` and a
multiple of 4, any head width, up to `MAX_KEYS` keys; anything else
raises ValueError naming the limit.  K3b
(`backward_plan`) takes every shape K3 takes: a cluster of cs CTAs a row,
split by heads, as many clusters as the card holds at once (at most B),
each taking rows in order; a CTA's arrays in shared memory where they fit
at some cluster size and in device memory past it (one CTA a row then);
the weight gradients summed across clusters through scratch memory that
this module keeps per device and reuses, so K3b calls on one device run on
one stream at a time.

Dropout (train time) is a variant of both kernels: a keep mask on the
attention probabilities after the query mask, bool [B, H, Tq, Tk] (with
the replica axis [R, B, H, Tq, Tk]), drawn by the dispatcher
(ops/multihead_attention.py) with the same generator call as the plain
version, and keep = 1 − rate.  `MHAFunction` saves it for K3b.  The launch
plans do not change: the kernels read the mask from device memory.

Both kernels take a leading replica axis of weights: R parameter sets,
each with its own rows (queries [R, B, Tq, D], ..., wq [R, D, D], bq [R,
D]), in one launch whatever R is.  Under ``torch.func.vmap`` (the replica
fan-out, train/ensemble.py) `MHAFunction`'s vmap rule moves the replica
axis to the front, expands what is shared and applies `MHAFunction` itself
to the replica axis: one K3 launch forward and one K3b launch backward for
all R replicas.  A CUDA tensor under vmap launches the replica kernels or
raises; nothing loops over the replicas.
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
BWD_SOURCE = "mha_bwd"
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
# the wide variants of K3 and K3b (kWideMaxD in csrc/mha_fwd.cu and
# csrc/mha_bwd.cu) and K3's rows of a LayerNorm exchange (kWideLnRows)
WIDE_MAX_D, WIDE_LN_ROWS = 512, 64
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

# K3b: the CTAs of its device-memory fallback (one an SM), slots summed
# together at each level of its cross-CTA tree (kGroup in csrc/mha_bwd.cu)
SMS, BWD_GROUP = 132, 16
# where K3b keeps a row's x rows (kXRegion, kXGlobal in csrc/mha_bwd.cu):
# in the region that holds the query block's probabilities, reloaded there
# for the weight gradients; in device memory, read where they lie (the plan
# of last resort, whose layout lies in device memory too)
X_REGION, X_GLOBAL = 0, 1
STATIC_SMEM = 64  # bytes K3b keeps for its static flag

launches = 0
bwd_launches = 0

_F32 = torch.float32
_I32 = torch.int32
_BOOL = torch.bool
# K3b's scratch per device index: (slots f32, tickets i32 all 0, workspace f32)
_scratch: dict = {}
# the workspace of K3's wide variant per device index (f32)
_fwd_scratch: dict = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: `grid` = B·`cs` CTAs of `threads` threads in clusters of
    `cs`, one cluster a batch row; `group` lanes take a (query row, head)
    (for Tq = 1, a head over the CTA's keys); `smem` bytes of dynamic
    shared memory a CTA.  The wide variant (`wide`): `clusters` clusters
    (`grid` = clusters·cs), cluster i taking the rows i, i + clusters, ...;
    CTA c owning heads c·H/cs .. (c+1)·H/cs − 1; a warp a (query row,
    head); its Q, K and V columns, `arrays` floats a CTA, in shared memory
    or, with `work` > 0, in `work` floats of device memory."""
    dh: int
    cs: int
    grid: int
    threads: int
    group: int
    smem: int
    wide: bool = False
    clusters: int = 0
    arrays: int = 0
    work: int = 0


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


def _wide_plan(B: int, Tq: int, Tk: int, D: int, num_heads: int) -> Plan:
    """K3's wide variant: the largest cluster size that divides the heads
    with columns on 16-byte boundaries (it depends on D and H alone, so a
    row's arithmetic does not depend on B); a layout of the warps'
    probabilities, LayerNorm's exchange and, where they fit, the CTA's
    columns of Q, K and V (csrc/mha_fwd.cu's mha_fwd_wide_kernel); as many
    clusters as the card runs at once, at most B."""
    cs = max(c for c in CLUSTER_SIZES if num_heads % c == 0 and (D // c) % 4 == 0)
    arrays = (Tq + 2 * Tk) * (D // cs + PAD)
    fixed = 4 * (THREADS // 32 * _r4(Tk) + 3 * WIDE_LN_ROWS)
    in_smem = fixed + 4 * arrays <= SMEM_LIMIT
    smem = fixed + 4 * arrays if in_smem else fixed
    clusters = min(B, ACTIVE_CLUSTERS[cs, ctas_per_sm(smem)])
    return Plan(D // num_heads, cs, clusters * cs, THREADS, 32, smem, True, clusters,
                arrays, 0 if in_smem else clusters * cs * arrays)


@functools.lru_cache(maxsize=512)
def launch_plan(B: int, Tq: int, Tk: int, D: int, num_heads: int,
                self_attention: bool = False) -> Plan:
    """The geometry of K3 for queries [B, Tq, D] and keys [B, Tk, D] in
    `num_heads` heads (`self_attention`: keys is queries, one slice of
    shared memory for both): the largest cluster size whose CTA fits in
    shared memory and whose B clusters the card runs at once
    (ACTIVE_CLUSTERS), or, when B is too large for one wave, the smallest
    that fits.  Where no row-split variant takes the shape (heads past
    MAX_HEAD_WIDTH features, D past MAX_D, or no cluster's CTA fits), the
    wide variant (`_wide_plan`).  Raises ValueError for what the kernel
    refuses."""
    if B < 1 or Tq < 1 or Tk < 1 or num_heads < 1 or D % num_heads:
        raise ValueError(
            f"K3 needs B, Tq, Tk >= 1 and D % num_heads == 0; got B={B}, "
            f"Tq={Tq}, Tk={Tk}, D={D}, num_heads={num_heads}")
    dh = D // num_heads
    if D > WIDE_MAX_D or D % 4:
        raise ValueError(
            f"K3 takes D of at most {WIDE_MAX_D} and a multiple of 4; got D={D}")
    if Tk > MAX_KEYS:
        raise ValueError(f"K3 takes at most {MAX_KEYS} keys; got Tk={Tk}")
    if dh > MAX_HEAD_WIDTH or D > MAX_D:
        return _wide_plan(B, Tq, Tk, D, num_heads)
    smem = {cs: _smem(Tq, Tk, D, num_heads, cs, self_attention)
            for cs in CLUSTER_SIZES}
    fits = [cs for cs in CLUSTER_SIZES if smem[cs] <= SMEM_LIMIT]
    if not fits:
        return _wide_plan(B, Tq, Tk, D, num_heads)
    one_wave = [cs for cs in fits
                if B <= ACTIVE_CLUSTERS[cs, ctas_per_sm(smem[cs])]]
    cs = max(one_wave) if one_wave else fits[0]
    keys = -(-Tk // cs) if Tq == 1 else Tk
    group = 1
    while group * PER_LANE < keys:
        group *= 2
    return Plan(dh, cs, B * cs, THREADS, group, smem[cs])


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """One K3b launch: `clusters` clusters of `cs` CTAs (`grid` = clusters ·
    cs) of `threads` threads for each of `replicas` replicas, cluster i
    taking the rows i, i + clusters, ... of its replica; CTA c of a cluster
    owns heads c·H/cs .. (c+1)·H/cs − 1.  Query blocks of `qb` rows; the x
    rows where `xmode` says (X_REGION or X_GLOBAL), one copy for
    both when `alias` (self-attention).  A CTA's layout of `per_cta` floats
    lies in `smem` bytes of dynamic shared memory or, with `smem` 0, in
    `work` floats of device memory a replica.  Per replica and rank a tree
    of `slots` weight-gradient slots of `weights` floats (the rank's
    columns) and `tickets` integers."""
    dh: int
    cs: int
    clusters: int
    grid: int
    replicas: int
    threads: int
    qb: int
    xmode: int
    alias: bool
    smem: int
    per_cta: int
    weights: int
    slots: int
    tickets: int
    work: int


def _r4(n: int) -> int:
    return -(-n // 4) * 4


def _bwd_layout(Tq: int, Tk: int, D: int, num_heads: int, cs: int, qb: int, xmode: int,
                alias: bool) -> int:
    """Floats of a K3b CTA's layout (make_layout in csrc/mha_bwd.cu): the
    column slices of the three weights, the biases and γ; Q, O, dy and the
    own columns of xq and g; K, V, dK and dV (the own heads' columns, each
    padded to a multiple of 4, rows 4 floats longer); the query block's
    statistics and LayerNorm's exchange (two buffers, by the block's
    parity); dγ and dβ; the region, which holds the block's probabilities,
    the x rows (X_REGION) and the partial input gradients in turn."""
    hc, dhp = num_heads // cs, _r4(D // num_heads)
    dcp, dc = hc * dhp, hc * (D // num_heads)
    ldc, ldx, ldp = dcp + PAD, D + PAD, _r4(Tk) + PAD
    xrows = Tq + (0 if alias else Tk)
    floats = (3 * D * ldc + 4 * dcp + 5 * _r4(Tq) * ldc + 4 * _r4(Tk) * ldc
              + _r4(qb * hc) + _r4(2 * qb) + 2 * 4 * qb + _r4(2 * dc))
    region = max(hc * qb * ldp, max(Tq, Tk) * ldx)
    if xmode == X_REGION:
        region = max(region, xrows * ldx)
    return floats + region


def _query_blocks(Tq: int):
    """Query-block sizes to try, largest first: Tq split into 1 .. 8 equal
    blocks, then 32, 16, ... rows."""
    sizes = {-(-Tq // n) for n in range(1, 9)} | {q for q in (32, 16, 8, 4, 2, 1) if q <= Tq}
    return sorted(sizes, reverse=True)


def _tree(n: int):
    """(slots, tickets) of a cross-CTA tree over n slots."""
    slots, tickets = n, 0
    while n > 1:
        n = -(-n // BWD_GROUP)
        slots += n
        tickets += n
    return slots, tickets


@functools.lru_cache(maxsize=512)
def backward_plan(B: int, Tq: int, Tk: int, D: int, num_heads: int,
                  replicas: int = 1, self_attention: bool = False) -> BwdPlan:
    """The geometry of K3b for queries [B, Tq, D] and keys [B, Tk, D] in
    `num_heads` heads (`self_attention`: keys is queries, one copy of x),
    for each of `replicas` replicas.  Among the cluster sizes that divide
    the heads (with columns on 16-byte boundaries) and the query blocks
    whose layout fits a CTA's shared memory: the largest cluster whose
    clusters hold the B rows in one wave (ACTIVE_CLUSTERS at the CTAs an SM
    holds), else the one with the most CTAs resident; then the fewest query
    blocks.  The grid is that
    wave, at most B clusters, so the scratch does not grow with B.  Where
    nothing fits, one CTA a row (132 at most) with its layout in device
    memory.  It depends on the shape alone, so two calls agree bit for bit,
    and a replica's CTAs are those of its own launch.  Raises ValueError for
    what the kernel refuses, which K3 refuses too."""
    if B < 1 or Tq < 1 or Tk < 1 or num_heads < 1 or replicas < 1 or D % num_heads:
        raise ValueError(
            f"K3b needs B, Tq, Tk, replicas >= 1 and D % num_heads == 0; got "
            f"B={B}, Tq={Tq}, Tk={Tk}, D={D}, num_heads={num_heads}, "
            f"replicas={replicas}")
    dh = D // num_heads
    if D > WIDE_MAX_D or D % 4:
        raise ValueError(
            f"K3b takes D of at most {WIDE_MAX_D} and a multiple of 4; got D={D}")
    alias = bool(self_attention) and Tq == Tk
    best = None
    for cs in CLUSTER_SIZES:
        if num_heads % cs or (D // cs) % 4:
            continue
        for qb in _query_blocks(Tq):
            floats = _bwd_layout(Tq, Tk, D, num_heads, cs, qb, X_REGION, alias)
            if 4 * floats > SMEM_LIMIT - STATIC_SMEM:
                continue
            active = ACTIVE_CLUSTERS[cs, ctas_per_sm(4 * floats)]
            wave = B <= active
            key = (wave, cs if wave else cs * active, qb)
            if best is None or key > best[0]:
                best = key, cs, qb, floats, active
    if best is None:
        cs, xmode, qb = 1, X_GLOBAL, min(Tq, 64)
        floats = _bwd_layout(Tq, Tk, D, num_heads, cs, qb, xmode, alias)
        clusters, smem = min(B, SMS), 0
    else:
        _, cs, qb, floats, active = best
        xmode, clusters, smem = X_REGION, min(B, active), 4 * floats
    slots, tickets = _tree(clusters)
    dc = D // cs
    return BwdPlan(dh, cs, clusters, clusters * cs, replicas, THREADS, qb, xmode, alias,
                   smem, floats, 3 * D * dc + 5 * dc, slots, tickets,
                   0 if smem else clusters * floats)


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if lib.mha_fwd_launch.argtypes is None:
        lib.mha_fwd_launch.argtypes = (
            [ctypes.c_void_p] * 13 + [ctypes.c_int] * 11
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
        lib.mha_fwd_launch.restype = ctypes.c_int
        lib.mha_fwd_wide_launch.argtypes = (
            [ctypes.c_void_p] * 14 + [ctypes.c_int] * 12
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
        lib.mha_fwd_wide_launch.restype = ctypes.c_int
        lib.mha_fwd_active_clusters.argtypes = [ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p]
        lib.mha_fwd_active_clusters.restype = ctypes.c_int
        lib.mha_error_string.argtypes = [ctypes.c_int]
        lib.mha_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = build.load(BWD_SOURCE)
    if lib.mha_bwd_launch.argtypes is None:
        lib.mha_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 27 + [ctypes.c_int] * 17
            + [ctypes.c_float, ctypes.c_void_p])
        lib.mha_bwd_launch.restype = ctypes.c_int
        lib.mha_bwd_layout_floats.argtypes = [ctypes.c_int] * 9
        lib.mha_bwd_layout_floats.restype = ctypes.c_int
        lib.mha_bwd_active_clusters.argtypes = [ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p]
        lib.mha_bwd_active_clusters.restype = ctypes.c_int
        lib.mha_bwd_error_string.argtypes = [ctypes.c_int]
        lib.mha_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(fn: str, queries, keys, q_len, k_len, weights, num_heads,
                  keep_mask=None, keep=1.0, g=None):
    """One pass over the tensors, the dropout mask and K3b's incoming
    gradient `g` among them: device, dtype, shape, contiguity, and the
    16-byte alignment of the float rows the kernels read as float4.
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
    if keep_mask is not None:
        if not 0.0 < keep <= 1.0:
            raise ValueError(f"{fn}: keep must lie in (0, 1], got {keep}")
        todo.append(("keep_mask", keep_mask, _BOOL, lead + (B, num_heads, Tq, Tk)))
    if g is not None:
        todo.append(("g", g, _F32, lead + (B, Tq, D)))
    for name, t, dtype, shape in todo:
        if (t.get_device() != index or t.dtype is not dtype or t.shape != shape
                or not t.is_contiguous()):
            check_tensor(fn, name, t, dtype, shape, queries.device)
        # K3b reads g a float at a time; every other float row goes as float4
        if dtype is _F32 and name != "g" and t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must start on a 16-byte boundary")
    return lead, B, Tq, Tk, D


def mha_forward(queries: torch.Tensor, keys: torch.Tensor, q_len: torch.Tensor,
                k_len: torch.Tensor, num_heads: int, wq, bq, wk, bk, wv, bv,
                ln_gamma, ln_beta, keep_mask=None, keep: float = 1.0) -> torch.Tensor:
    """K3.  queries f32 [B, Tq, D], keys f32 [B, Tk, D] (the same tensor
    for self-attention), q_len and k_len i32 [B], wq/wk/wv f32 [D, D],
    bq/bk/bv/ln_gamma/ln_beta f32 [D], all contiguous on one CUDA device →
    out f32 [B, Tq, D]; or every tensor with a leading replica axis R
    (queries [R, B, Tq, D], ..., wq [R, D, D], out [R, B, Tq, D]), R
    replicas in one launch of R·B rows.  Dropout: `keep_mask`, bool [B,
    num_heads, Tq, Tk] (R first with the replica axis), keeps the attention
    probabilities it flags, each divided by `keep`.  Records no gradient:
    `MHAFunction` does."""
    global launches
    weights = (wq, bq, wk, bk, wv, bv, ln_gamma, ln_beta)
    lead, B, Tq, Tk, D = _check_inputs("mha_forward", queries, keys, q_len, k_len,
                                       weights, num_heads, keep_mask, keep)
    out = queries.new_empty(lead + (B, Tq, D))
    rows = math.prod(lead) * B  # R·B
    if rows == 0:
        return out
    # the kernel shares one slice for queries and keys when they are one
    # tensor, as here
    plan = launch_plan(rows, Tq, Tk, D, num_heads, queries.data_ptr() == keys.data_ptr())
    lib = _library()
    ptrs = (queries.data_ptr(), keys.data_ptr(), q_len.data_ptr(), k_len.data_ptr(),
            *(t.data_ptr() for t in weights), out.data_ptr())
    mask = None if keep_mask is None else keep_mask.data_ptr()
    if plan.wide:
        work = _fwd_work(queries, plan)
        err = launch(queries.get_device(), lambda stream: lib.mha_fwd_wide_launch(
            *ptrs, work, Tq, Tk, D, num_heads, plan.dh, plan.cs, plan.clusters, B, rows,
            plan.arrays, plan.threads, plan.smem, mask, keep, stream))
    else:
        err = launch(queries.get_device(), lambda stream: lib.mha_fwd_launch(
            *ptrs, Tq, Tk, D, num_heads, plan.dh, plan.cs, plan.group, B, plan.grid,
            plan.threads, plan.smem, mask, keep, stream))
    if err != 0:
        raise RuntimeError(
            f"mha_fwd launch failed (cluster of {plan.cs}, {plan.smem} bytes of "
            f"shared memory a CTA): {lib.mha_error_string(err).decode()}")
    launches += 1
    return out


def _fwd_work(queries: torch.Tensor, plan: Plan):
    """The address of queries' device's workspace for K3's wide variant,
    grown to the plan's size, or None for a plan in shared memory."""
    if not plan.work:
        return None
    index = queries.get_device()
    work = _fwd_scratch.get(index)
    if work is None or work.numel() < plan.work:
        work = _fwd_scratch[index] = queries.new_empty(plan.work)
    return work.data_ptr()


def _bwd_scratch(queries: torch.Tensor, plan: BwdPlan):
    """queries' device's K3b scratch, grown to the plan's size: (slots,
    tickets, workspace or None), a tree a replica and rank and a workspace
    a replica.  The kernel leaves every ticket at 0 again."""
    index = queries.get_device()
    trees = plan.replicas * plan.cs
    need = (trees * plan.slots * plan.weights, trees * plan.tickets,
            plan.replicas * plan.work)
    have = list(_scratch.get(index, (None, None, None)))
    for i, make in enumerate((queries.new_empty,
                              lambda n: queries.new_zeros(n, dtype=_I32),
                              queries.new_empty)):
        if have[i] is None or have[i].numel() < need[i]:
            have[i] = make(max(need[i], 1))
    _scratch[index] = tuple(have)
    return have[0], have[1], have[2] if plan.work else None


def mha_backward(queries: torch.Tensor, keys: torch.Tensor, q_len: torch.Tensor,
                 k_len: torch.Tensor, num_heads: int, wq, bq, wk, bk, wv, bv,
                 ln_gamma, ln_beta, g: torch.Tensor, keep_mask=None,
                 keep: float = 1.0):
    """K3b.  The inputs of `mha_forward` plus g = dL/dout f32 [B, Tq, D],
    all contiguous on one CUDA device → (d_queries [B, Tq, D], d_keys [B,
    Tk, D], dwq, dbq, dwk, dbk, dwv, dbv, d_gamma, d_beta), the gradients of
    K3's function; for self-attention (queries is keys) the caller adds
    d_queries and d_keys.  With a leading replica axis R on every tensor,
    each replica's gradients are its own, in one launch.  With the
    forward's dropout mask and keep, the gradients of the dropped forward.
    The weight gradients are summed without float atomics, so two calls on
    the same inputs agree bit for bit."""
    global bwd_launches
    weights = (wq, bq, wk, bk, wv, bv, ln_gamma, ln_beta)
    lead, B, Tq, Tk, D = _check_inputs("mha_backward", queries, keys, q_len, k_len,
                                       weights, num_heads, keep_mask, keep, g)
    R = math.prod(lead)
    # the kernel writes every entry; an empty batch gives zero gradients
    new = queries.new_empty if B and R else queries.new_zeros
    d_queries, d_keys = new(lead + (B, Tq, D)), new(lead + (B, Tk, D))
    grads = [new(lead + tuple(w.shape[len(lead):])) for w in weights]
    if B == 0 or R == 0:
        return (d_queries, d_keys, *grads)
    # one copy of x when queries and keys are one tensor, as for self-attention
    plan = backward_plan(B, Tq, Tk, D, num_heads, R, queries.data_ptr() == keys.data_ptr())
    lib = _bwd_library()
    slots, tickets, work = _bwd_scratch(queries, plan)
    err = launch(queries.get_device(), lambda stream: lib.mha_bwd_launch(
        queries.data_ptr(), keys.data_ptr(), q_len.data_ptr(), k_len.data_ptr(),
        *(t.data_ptr() for t in weights), g.data_ptr(),
        None if keep_mask is None else keep_mask.data_ptr(),
        d_queries.data_ptr(), d_keys.data_ptr(), *(t.data_ptr() for t in grads),
        slots.data_ptr(), tickets.data_ptr(), None if work is None else work.data_ptr(),
        Tq, Tk, D, num_heads, plan.dh, B, plan.cs, plan.clusters, R, plan.qb, plan.xmode,
        int(plan.alias), plan.slots, plan.tickets, plan.per_cta, plan.threads, plan.smem,
        keep, stream))
    if err != 0:
        raise RuntimeError(
            f"mha_bwd launch failed ({plan.clusters} x {R} clusters of {plan.cs}, "
            f"{plan.smem} bytes of shared memory a CTA): "
            f"{lib.mha_bwd_error_string(err).decode()}")
    bwd_launches += 1
    return (d_queries, d_keys, *grads)


class MHAFunction(torch.autograd.Function):
    """Multi-head attention with K3 forward and K3b backward.  Like the JAX
    custom_vjp, it saves only the inputs (and the dropout mask); K3b
    recomputes the forward.  Arguments are those of `mha_forward`: the
    eight weights, then, under dropout, the keep mask and the rate (keep =
    1 − rate); q_len, k_len, num_heads and the mask get no gradient; with
    or without the replica axis.  For self-attention (queries is keys)
    autograd adds the two gradients K3b returns.  Under
    ``torch.func.vmap`` its vmap rule applies it to the replica axis."""

    @staticmethod
    def forward(queries, keys, q_len, k_len, num_heads, *rest):
        weights, drop = rest[:len(WEIGHTS)], rest[len(WEIGHTS):]
        if drop:  # (keep_mask, rate)
            drop = (drop[0], 1.0 - drop[1])
        return mha_forward(queries, keys, q_len, k_len, num_heads, *weights, *drop)

    @staticmethod
    def setup_context(ctx, inputs, output):
        queries, keys, q_len, k_len, num_heads, *rest = inputs
        weights, drop = rest[:len(WEIGHTS)], rest[len(WEIGHTS):]
        ctx.num_heads, ctx.rate = num_heads, drop[1] if drop else 0.0
        ctx.save_for_backward(queries, keys, q_len, k_len, *weights, *drop[:1])

    @staticmethod
    def backward(ctx, g):
        queries, keys, q_len, k_len, *rest = ctx.saved_tensors
        weights, mask = rest[:len(WEIGHTS)], rest[len(WEIGHTS):]
        drop = (mask[0], 1.0 - ctx.rate) if mask else ()
        # g arrives from the feedforward's residual, possibly expanded
        grads = mha_backward(queries, keys, q_len, k_len, ctx.num_heads, *weights,
                             g.contiguous(), *drop)
        return (grads[0], grads[1], None, None, None, *grads[2:]) + (None, None) * len(mask)

    @staticmethod
    def vmap(info, in_dims, queries, keys, q_len, k_len, num_heads, *rest):
        R = info.batch_size
        # self-attention passes one tensor as queries and keys: the kernel
        # (and its plan) read that from the pointers, so it stays one tensor
        same = (in_dims[0] == in_dims[1] and queries.shape == keys.shape
                and queries.stride() == keys.stride()
                and queries.data_ptr() == keys.data_ptr())
        queries = replica_first(queries, in_dims[0], R)
        keys = queries if same else replica_first(keys, in_dims[1], R)
        tensors = rest[:len(WEIGHTS) + 1]  # the weights and the mask
        q_len, k_len, *tensors = (
            replica_first(t, d, R) for t, d in zip((q_len, k_len, *tensors),
                                              in_dims[2:4] + in_dims[5:]))
        return MHAFunction.apply(queries, keys, q_len, k_len, num_heads, *tensors,
                                 *rest[len(WEIGHTS) + 1:]), 0
