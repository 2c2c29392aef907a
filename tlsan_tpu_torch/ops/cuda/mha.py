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
they fit and in device memory past it): any D (one float at a time where
D is not a multiple of 4), any head width, any number of keys; only what
memory forces raises ValueError, naming the limit (a warp's
probabilities over the keys past a CTA's shared memory, a cluster's
arrays past `WORK_LIMIT` floats), besides no rows and heads that do not
divide D.  K3b (`backward_plan`) takes every shape K3 takes: its resident
design (a cluster of cs CTAs a row split by heads, each CTA's weight
columns in shared memory) where that fits, else its streamed one (the
weights read where they lie, a row split over a cluster by heads or by
rows, in shared memory or past it in device memory); as many clusters as
the card holds at once (at most B), each taking rows in order; the weight
gradients summed across clusters through scratch memory that this module
keeps per device and reuses, so K3b calls on one device run on one stream
at a time.

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
import fractions
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
# K3's wide variant: its rows of a LayerNorm exchange (kWideLnRows in
# csrc/mha_fwd.cu)
WIDE_LN_ROWS = 64
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

# K3b: slots summed together at each level of its cross-CTA tree (kGroup
# in csrc/mha_bwd.cu)
BWD_GROUP = 16
# K3b's designs (kResident, kHeads, kRows in csrc/mha_bwd.cu): the weights'
# columns resident in shared memory; streamed, a row split over a cluster
# by heads; streamed, split by rows
RESIDENT, HEADS, ROWS = 0, 1, 2
# the streamed design's tiles: k-columns staged at once, output columns and
# rows (or features of x) at a time, and the weight gradients' steps staged
# at once (kTileK, kTileN, kTileRows, kStepK)
TILE_K, TILE_N, TILE_ROWS, STEP_K = 8, 64, 128, 16
STATIC_SMEM = 64  # bytes K3b keeps for its static flag
# the most floats a cluster's streamed layout may take in device memory
# (its CTAs' slices), and the most a replica's workspace (and its dpre
# rows) takes: clusters past it wait for a later wave
WORK_LIMIT, WORK_CAP = 1 << 30, 1 << 27

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
    (for D a multiple of 4, with columns on 16-byte boundaries; else its
    single-float variant); a layout of the warps' probabilities (Tk floats
    each), LayerNorm's exchange and, where they fit, the CTA's columns of Q,
    K and V (csrc/mha_fwd.cu's mha_fwd_wide_kernel); as many clusters as the
    card runs at once, at most B, and as many as WORK_CAP floats of device
    memory hold where the columns lie there.  Raises ValueError where the
    probabilities pass a CTA's shared memory or a cluster's columns
    WORK_LIMIT."""
    vec = D % 4 == 0
    cs = max(c for c in CLUSTER_SIZES
             if num_heads % c == 0 and (not vec or (D // c) % 4 == 0))
    arrays = (Tq + 2 * Tk) * (_r4(D // cs) + PAD)
    fixed = 4 * (THREADS // 32 * _r4(Tk) + 3 * WIDE_LN_ROWS)
    if fixed > SMEM_LIMIT:
        raise ValueError(
            f"K3 keeps a warp's probabilities over the Tk keys in shared memory: "
            f"{fixed} bytes a CTA at Tk={Tk}, above its {SMEM_LIMIT}")
    if cs * arrays > WORK_LIMIT:
        raise ValueError(
            f"K3's columns of Q, K and V take {cs * arrays} floats a cluster at "
            f"(Tq, Tk, D) = ({Tq}, {Tk}, {D}), above the {WORK_LIMIT} it places in "
            "device memory")
    in_smem = fixed + 4 * arrays <= SMEM_LIMIT
    smem = fixed + 4 * arrays if in_smem else fixed
    clusters = min(B, ACTIVE_CLUSTERS[cs, ctas_per_sm(smem)])
    if not in_smem:
        clusters = min(clusters, max(1, WORK_CAP // (cs * arrays)))
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
    MAX_HEAD_WIDTH features, D past MAX_D or not a multiple of 4, more than
    MAX_KEYS keys, or no cluster's CTA fits), the wide variant
    (`_wide_plan`).  Raises ValueError for what the kernel refuses: no
    rows, heads that do not divide D, and the memory limits of
    `_wide_plan`."""
    if B < 1 or Tq < 1 or Tk < 1 or num_heads < 1 or D % num_heads:
        raise ValueError(
            f"K3 needs B, Tq, Tk >= 1 and D % num_heads == 0; got B={B}, "
            f"Tq={Tq}, Tk={Tk}, D={D}, num_heads={num_heads}")
    dh = D // num_heads
    if dh > MAX_HEAD_WIDTH or D > MAX_D or D % 4 or Tk > MAX_KEYS:
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
    taking the rows i, i + clusters, ... of its replica.  `mode` the
    design: RESIDENT (the weights' own columns in shared memory, CTA c of a
    cluster owning heads c·H/cs .. (c+1)·H/cs − 1, one copy of x for both
    when `alias`, self-attention), HEADS (streamed: the weights read where
    they lie, the same split) or ROWS (streamed, CTA c owning all heads and
    query and key rows c·⌈T/cs⌉ ..).  Query blocks of `qb` rows.  A CTA's
    layout of `per_cta` floats and, streamed, its `stage` floats lie in
    `smem` bytes of dynamic shared memory; or, with `work` > 0, the layout
    lies in `work` floats of device memory a replica and `smem` holds the
    stage.  Per replica and tree (one a rank, one under ROWS) `slots`
    weight-gradient slots of `weights` floats (a rank's columns, all under
    ROWS) and `tickets` integers."""
    dh: int
    cs: int
    clusters: int
    grid: int
    replicas: int
    threads: int
    qb: int
    mode: int
    alias: bool
    smem: int
    per_cta: int
    stage: int
    weights: int
    slots: int
    tickets: int
    work: int

    @property
    def trees(self) -> int:
        """Weight-gradient trees a replica."""
        return 1 if self.mode == ROWS else self.cs


def _r4(n: int) -> int:
    return -(-n // 4) * 4


def _bwd_layout(Tq: int, Tk: int, D: int, num_heads: int, cs: int, qb: int,
                alias: bool) -> int:
    """Floats of a resident K3b CTA's layout (make_layout in
    csrc/mha_bwd.cu): the column slices of the three weights, the biases and
    γ; Q, O, dy and the own columns of xq and g; K, V, dK and dV (the own
    heads' columns, each padded to a multiple of 4, rows 4 floats longer);
    the query block's statistics and LayerNorm's exchange (two buffers, by
    the block's parity); dγ and dβ; the region, which holds the block's
    probabilities, the x rows and the partial input gradients in turn."""
    hc, dhp = num_heads // cs, _r4(D // num_heads)
    dcp, dc = hc * dhp, hc * (D // num_heads)
    ldc, ldx, ldp = dcp + PAD, D + PAD, _r4(Tk) + PAD
    xrows = Tq + (0 if alias else Tk)
    floats = (3 * D * ldc + 4 * dcp + 5 * _r4(Tq) * ldc + 4 * _r4(Tk) * ldc
              + _r4(qb * hc) + _r4(2 * qb) + 2 * 4 * qb + _r4(2 * dc))
    return floats + max(hc * qb * ldp, max(Tq, Tk) * ldx, xrows * ldx)


def _stream_layout(Tq: int, Tk: int, D: int, num_heads: int, cs: int, qb: int,
                   rows: bool):
    """(layout, stage) floats of a streamed K3b CTA (make_stream_layout in
    csrc/mha_bwd.cu): the biases and γ; Q, O, dy [Tq][·] and K, V, dK, dV
    [Tk][·] of the own columns (all under ROWS); the query block's
    statistics, LayerNorm's exchange, dγ and dβ and its probabilities; the
    stage: two buffers, each the largest of a product's tiles (TILE_K
    columns of at most TILE_ROWS own query and key rows of x or dpre, and
    the projections' three weight tiles or the input gradients' two; the
    weight gradients' xᵀ of up to TILE_ROWS features by STEP_K steps and
    dpre's STEP_K rows); in the query blocks, a block's own columns of xq
    and g."""
    hc = num_heads if rows else num_heads // cs
    dhp = _r4(D // num_heads)
    dcp, dc = hc * dhp, hc * (D // num_heads)
    ldc, ldp = dcp + PAD, _r4(Tk) + PAD
    main = (4 * dcp + 3 * _r4(Tq) * ldc + 4 * _r4(Tk) * ldc + _r4(qb * hc) + _r4(2 * qb)
            + 2 * 4 * qb + _r4(2 * dc) + hc * qb * ldp)
    nq, nk = (-(-Tq // cs), -(-Tk // cs)) if rows else (Tq, Tk)
    nc, ldt = min(dcp, TILE_N), TILE_K + PAD
    ra, rk, rw = (_r4(min(n, TILE_ROWS)) for n in (nq, nk, D))
    buf = max((ra + rk) * ldt + 3 * TILE_K * (nc + PAD),    # the projections
              (ra + rk) * ldt + 2 * nc * ldt,               # the input gradients
              rw * (STEP_K + PAD) + STEP_K * (nc + PAD))    # the weight gradients
    return main, max(2 * buf, 2 * qb * ldc)


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


def _bwd_plan(B, Tq, Tk, D, num_heads, replicas, mode, cs, clusters, qb, alias, smem, per_cta,
              stage, work) -> BwdPlan:
    dc = D if mode == ROWS else D // cs
    slots, tickets = _tree(clusters * cs if mode == ROWS else clusters)
    return BwdPlan(D // num_heads, cs, clusters, clusters * cs, replicas, THREADS, qb, mode,
                   alias, smem, per_cta, stage, 3 * D * dc + 5 * dc, slots, tickets, work)


def _stream_plans(B: int, Tq: int, Tk: int, D: int, num_heads: int, in_smem: bool):
    """(key, mode, cs, qb, layout, stage, smem, clusters) of every streamed
    geometry: the layout within a CTA's shared memory (`in_smem`) or in
    device memory (the largest query block of up to 64 rows whose stage
    fits shared memory; the clusters as many as WORK_CAP floats hold, at
    least one; none past WORK_LIMIT a cluster).
    The key orders them by the rows' share a CTA takes (1/cs within one
    wave, B over the CTAs past it, so that no plan changes with B past every
    geometry's wave), then HEADS before ROWS, larger clusters, larger
    blocks."""
    for mode in (HEADS, ROWS):
        for cs in CLUSTER_SIZES:
            if (mode == HEADS and num_heads % cs) or (mode == ROWS and cs == 1):
                continue
            own = -(-Tq // cs) if mode == ROWS else Tq
            for qb in _query_blocks(own):
                main, stage = _stream_layout(Tq, Tk, D, num_heads, cs, qb, mode == ROWS)
                smem = 4 * (main + stage) if in_smem else 4 * stage
                if (smem > SMEM_LIMIT - STATIC_SMEM or
                        (not in_smem and (qb > 64 or cs * main > WORK_LIMIT))):
                    continue
                # one CTA an SM: the streamed kernel takes up to 255 registers a thread
                clusters = min(B, ACTIVE_CLUSTERS[cs, 1])
                if not in_smem:
                    clusters = min(clusters, max(1, WORK_CAP // (cs * main)))
                # a row's share a CTA: 1/cs within one wave, the CTAs' share of B past it
                share = fractions.Fraction(1 if B <= clusters else B, cs * (1 if B <= clusters else clusters))
                yield (share, mode, -cs, -qb), mode, cs, qb, main, stage, smem, clusters
                if not in_smem:  # in device memory the largest block that fits will do
                    break


@functools.lru_cache(maxsize=512)
def backward_plan(B: int, Tq: int, Tk: int, D: int, num_heads: int,
                  replicas: int = 1, self_attention: bool = False) -> BwdPlan:
    """The geometry of K3b for queries [B, Tq, D] and keys [B, Tk, D] in
    `num_heads` heads (`self_attention`: keys is queries, one copy of x),
    for each of `replicas` replicas.  The resident design where its layout
    fits (D a multiple of 4): among the cluster sizes that divide the heads
    (with columns on 16-byte boundaries) and the query blocks whose layout
    fits a CTA's shared memory, the largest cluster whose clusters hold the
    B rows in one wave (ACTIVE_CLUSTERS at the CTAs an SM holds), else the
    one with the most CTAs resident; then the fewest query blocks.  Else
    the streamed design (`_stream_plans`), in shared memory where some
    geometry fits, else in device memory.  The grid is that wave, at most B
    clusters, so the scratch does not grow with B.  It depends on the shape
    alone, so two calls agree bit for bit, and a replica's CTAs are those of
    its own launch.  Raises ValueError for no rows, heads that do not divide
    D and a layout past WORK_LIMIT floats a cluster at every geometry."""
    if B < 1 or Tq < 1 or Tk < 1 or num_heads < 1 or replicas < 1 or D % num_heads:
        raise ValueError(
            f"K3b needs B, Tq, Tk, replicas >= 1 and D % num_heads == 0; got "
            f"B={B}, Tq={Tq}, Tk={Tk}, D={D}, num_heads={num_heads}, "
            f"replicas={replicas}")
    alias = bool(self_attention) and Tq == Tk
    best = None
    for cs in CLUSTER_SIZES if D % 4 == 0 else ():
        if num_heads % cs or (D // cs) % 4:
            continue
        for qb in _query_blocks(Tq):
            floats = _bwd_layout(Tq, Tk, D, num_heads, cs, qb, alias)
            if 4 * floats > SMEM_LIMIT - STATIC_SMEM:
                continue
            active = ACTIVE_CLUSTERS[cs, ctas_per_sm(4 * floats)]
            wave = B <= active
            key = (wave, cs if wave else cs * active, qb)
            if best is None or key > best[0]:
                best = key, cs, qb, floats, active
    if best is not None:
        _, cs, qb, floats, active = best
        return _bwd_plan(B, Tq, Tk, D, num_heads, replicas, RESIDENT, cs, min(B, active), qb,
                         alias, 4 * floats, floats, 0, 0)
    for in_smem in (True, False):
        plans = list(_stream_plans(B, Tq, Tk, D, num_heads, in_smem))
        if plans:
            _, mode, cs, qb, main, stage, smem, clusters = min(plans, key=lambda p: p[0])
            return _bwd_plan(B, Tq, Tk, D, num_heads, replicas, mode, cs, clusters, qb, alias,
                             smem, main, stage, 0 if in_smem else clusters * cs * main)
    raise ValueError(
        f"K3b's layout at (Tq, Tk, D, H) = ({Tq}, {Tk}, {D}, {num_heads}) takes more "
        f"than {WORK_LIMIT} floats of device memory a cluster at every cluster size")


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
            [ctypes.c_void_p] * 27 + [ctypes.c_int] * 18
            + [ctypes.c_float, ctypes.c_void_p])
        lib.mha_bwd_launch.restype = ctypes.c_int
        lib.mha_bwd_layout_floats.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
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
    gradient `g` among them: device, dtype, shape, contiguity, and, for D
    a multiple of 4, the 16-byte alignment of the float rows the kernels
    read as float4 (they read rows of any other D one float at a time).
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
        if dtype is _F32 and name != "g" and D % 4 == 0 and t.data_ptr() % 16:
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
    tickets, workspace or None), a tree a replica and tree, a workspace a
    replica.  The kernel leaves every ticket at 0 again."""
    index = queries.get_device()
    trees = plan.replicas * plan.trees
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
        Tq, Tk, D, num_heads, plan.dh, B, plan.cs, plan.clusters, R, plan.qb,
        plan.mode, int(plan.alias), plan.slots, plan.tickets, plan.per_cta, plan.stage,
        plan.threads, plan.smem, keep, stream))
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
