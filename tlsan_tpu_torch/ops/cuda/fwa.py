"""PyTorch wrappers of the CUDA feature-wise attention kernels.

K1 (``csrc/fwa_fwd.cu``, `fwa_forward`) replaces
``tlsan_tpu/ops/pallas/fwa.py::_fwa_kernel``; K2 (``csrc/fwa_bwd.cu``,
`fwa_backward`) replaces ``_fwa_bwd_kernel`` and its block-diagonal fold.
Their plain versions are ``ops/feature_attention.py``'s
``feature_wise_attention_reference`` and ``fwa_backward_reference``.
`FWAFunction` ties them together for autograd, as ``jax.custom_vjp`` ties
``_fwa_fwd`` and ``_fwa_bwd``.  The wrappers check what the kernels take and
raise on anything else; they never fall back to the plain versions.
``launches`` and ``bwd_launches`` count each kernel's launches in this
process.

Both kernels take a leading replica axis of weights: R parameter sets,
each with its own rows (x [R, B, S, D], lengths [R, B], the weights [R,
dh, dh] and [R, dh]), in one launch whatever R is, as ``jax.vmap`` of the
``pallas_call`` adds a grid axis.  Under ``torch.func.vmap`` (the replica
fan-out, train/ensemble.py) `FWAFunction`'s vmap rule moves the replica
axis to the front, expands what is shared (eval's lengths, an unbatched
weight) and applies `FWAFunction` itself to the replica axis: one K1
launch forward and one K2 launch backward for all R replicas.  A CUDA
tensor under vmap launches the replica kernels or raises; nothing loops
over the replicas.

Dropout (train time) is a variant of both kernels: the keep masks of the
two dense maps' inputs, bool [B, S, H, dh] each (with the replica axis
[R, B, S, H, dh]), drawn by the dispatcher (ops/feature_attention.py) with
the same generator calls as the plain version, and keep = 1 − rate.
`FWAFunction` saves them for K2, and its vmap rule moves their replica
axis first.  Without masks the kernels run the variant without dropout.

Both kernels run one warp per (batch row, head) unit for heads of up to
`MAX_HEAD_WIDTH` features.  Wider heads take a wide variant
(csrc/fwa_wide.cuh): the maps of all B·S·H steps are tiled products
([B·S·H, dh] × [dh, dh], WIDE_BM × WIDE_BN outputs a CTA), the
intermediates go through scratch memory between a few launches (three for
K1 and five or six for K2, each call counted once), the softmax over time
is per (row, head, feature) column, and K2's weight gradients are tiles of
entries summed over the rows in a fixed order; K1 at narrow heads of short
rows runs its phases in one launch, a CTA a batch row.
`launch_plan` gives every geometry (pure Python, so the CPU tests hold
it).  They take any S >= 1 and any head width.  K2 sums its weight
gradients across blocks, and the wide variants keep their intermediates,
in scratch memory that this module keeps per device and reuses, so calls
of one kernel on one device run on one stream at a time.
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

SOURCE = "fwa_fwd"
BWD_SOURCE = "fwa_bwd"

WARP = 32
MAX_HEAD_WIDTH = 32        # kMaxDh in csrc/fwa_common.cuh
FWD_WARPS, BWD_WARPS = 4, 8  # warps (units) a block
GROUP = 128                # kGroup in csrc/fwa_bwd.cu: slots summed together
# the wide variants (csrc/fwa_wide.cuh): a product tile's rows and output
# features, the depth staged at once and the threads of a tile (kWideBM,
# kWideBN, kWideBK, kWideThreads); the shared memory of a tile's CTA (two
# staged slices of both operands, padded rows of 4 floats more)
WIDE_BM, WIDE_BN, WIDE_BK, WIDE_THREADS = 32, 64, 16, 128
WIDE_SMEM = 4 * 2 * WIDE_BK * (WIDE_BM + 4 + WIDE_BN + 4)
# K1's fused path (kWideFuseDh, kWideFuseRows and kWideRowThreads in
# csrc/fwa_wide.cuh): heads of at most this many features whose batch rows
# hold at most this many steps (S·H), in CTAs of this many threads
WIDE_FUSE_DH, WIDE_FUSE_ROWS, WIDE_FUSE_THREADS = 64, 32, 256
# the floats a replica's intermediates may take (more only where one batch
# row needs more); K2's weight-gradient tiles aimed at (two CTAs an SM) and
# the fewest rows a split of them sums
WIDE_SCRATCH_FLOATS, WIDE_TARGET, WIDE_SPLIT_ROWS = 1 << 24, 264, 32

launches = 0
bwd_launches = 0

_F32 = torch.float32
_I32 = torch.int32
_BOOL = torch.bool
# K2's cross-block scratch per device index: (slots f32, tickets i32, all 0)
_scratch: dict = {}
# the wide variants' scratch per (device index, backward)
_wide_scratch: dict = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: `grid` × `replicas` blocks of `threads` threads
    (`warps` units a block, `units` = B·H a replica), `smem` bytes of
    dynamic shared memory; for K2 also `slots` scratch floats and
    `tickets` scratch integers a replica (its cross-block tree).  The wide
    variant (`wide`) runs passes of `rows` batch rows (`passes` of them):
    `grid` CTAs of WIDE_THREADS a product of a full pass, `smem` bytes of
    static shared memory each, `scratch` floats a replica; K2 sums its
    weight gradients over `splits` splits of `split_rows` rows a pass.
    K1's fused path (`fused`) is one launch of `grid` CTAs of one batch row
    each (`rows` 1), `smem` bytes of shared memory holding its arrays."""
    dh: int
    units: int
    warps: int
    grid: int
    threads: int
    smem: int
    slots: int = 0
    tickets: int = 0
    replicas: int = 1
    rows: int = 0
    passes: int = 0
    splits: int = 0
    split_rows: int = 0
    scratch: int = 0
    fused: bool = False

    @property
    def wide(self) -> bool:
        return self.rows > 0


def _tree(n: int, group: int):
    """(slots, tickets) of a cross-block tree over n slots in groups."""
    slots, tickets = n, 0
    while n > 1:  # the levels of the tree
        n = -(-n // group)
        slots += n
        tickets += n
    return slots, tickets


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wide_product_tiles(rows: int, dh: int) -> int:
    """The CTAs of a [rows, dh] × [dh, dh] product of the wide variants."""
    return _cdiv(rows, WIDE_BM) * _cdiv(dh, WIDE_BN)


def wide_weight_tiles(dh: int) -> int:
    """The tiles of K2's two weight gradients [dW; db], (dh + 1) × dh each."""
    return 2 * _cdiv(dh + 1, WIDE_BM) * _cdiv(dh, WIDE_BN)


def _wide_plan(B: int, S: int, dh: int, num_heads: int, backward: bool,
               replicas: int) -> Plan:
    """The wide variants' geometry (csrc/fwa_wide.cuh).  K1 at heads of at
    most WIDE_FUSE_DH features whose batch rows hold at most WIDE_FUSE_ROWS
    steps takes the fused path: a CTA a batch row, its m1_in and m2 in the
    CTA's shared memory.  Otherwise the tiled path: passes of the most
    whole batch rows whose intermediates (m1_in and m2; K2 also dm2 and
    dz1: [rows·S·H, dh] each) fit WIDE_SCRATCH_FLOATS, one at least; the
    products of a pass in tiles of WIDE_BM rows × WIDE_BN features.  K2
    splits a pass's rows for its weight gradients until their tiles come
    near WIDE_TARGET CTAs, each split WIDE_SPLIT_ROWS rows at least (a
    multiple of WIDE_BK), and then keeps a slot of both gradients a split.
    A pure function of the shape: the replicas only repeat it."""
    units = B * num_heads
    arrays = 4 if backward else 2
    if not backward and dh <= WIDE_FUSE_DH and S * num_heads <= WIDE_FUSE_ROWS:
        smem = WIDE_SMEM + 4 * arrays * S * num_heads * dh
        return Plan(dh, units, WIDE_FUSE_THREADS // WARP, B, WIDE_FUSE_THREADS, smem,
                    replicas=replicas, rows=1, passes=1, fused=True)
    rows = max(1, min(B, WIDE_SCRATCH_FLOATS // (arrays * S * num_heads * dh)))
    steps = rows * S * num_heads
    common = dict(dh=dh, units=units, warps=WIDE_THREADS // WARP,
                  grid=wide_product_tiles(steps, dh), threads=WIDE_THREADS, smem=WIDE_SMEM,
                  replicas=replicas, rows=rows, passes=_cdiv(B, rows))
    if not backward:
        return Plan(**common, scratch=arrays * steps * dh)
    splits = max(1, min(_cdiv(WIDE_TARGET, wide_weight_tiles(dh)),
                        _cdiv(steps, WIDE_SPLIT_ROWS)))
    split_rows = _cdiv(_cdiv(steps, splits), WIDE_BK) * WIDE_BK
    splits = _cdiv(steps, split_rows)
    parts = 2 * splits * (dh + 1) * dh if splits > 1 else 0
    return Plan(**common, splits=splits, split_rows=split_rows,
                scratch=arrays * steps * dh + parts)


@functools.lru_cache(maxsize=512)
def launch_plan(B: int, S: int, D: int, num_heads: int,
                backward: bool = False, replicas: int = 1) -> Plan:
    """The geometry of K1 (or, with `backward`, K2) for x [B, S, D] in
    `num_heads` heads, for each of `replicas` replicas (the grid's y axis;
    a replica's blocks, and K2's scratch tree, are those of one replica's
    launch); raises ValueError for what the kernels refuse: shapes that
    are not a batch of heads."""
    if B < 1 or S < 1 or num_heads < 1 or D % num_heads or replicas < 1:
        raise ValueError(
            f"feature-wise attention needs B, S, replicas >= 1 and "
            f"D % num_heads == 0; got B={B}, S={S}, D={D}, "
            f"num_heads={num_heads}, replicas={replicas}")
    dh = D // num_heads
    if dh > MAX_HEAD_WIDTH:
        return _wide_plan(B, S, dh, num_heads, backward, replicas)
    units = B * num_heads
    weights = 2 * dh * dh + 2 * dh
    if not backward:
        warps = FWD_WARPS
        grid = -(-units // warps)
        return Plan(dh, units, warps, grid, WARP * warps, 4 * weights,
                    replicas=replicas)
    # W1 | W2 | b1 | b2, then per warp 32 staged steps of 4·dh + 1 floats
    # and its weight-gradient sums (64 bytes kept for the static flag)
    per_warp = WARP * (4 * dh + 1) + weights
    warps = BWD_WARPS
    while warps > 1 and 4 * (weights + warps * per_warp) > SMEM_LIMIT - 64:
        warps //= 2
    grid = -(-units // warps)
    slots, tickets = _tree(grid, GROUP)
    return Plan(dh, units, warps, grid, WARP * warps,
                4 * (weights + warps * per_warp), slots * weights, tickets,
                replicas)


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if lib.fwa_fwd_launch.argtypes is None:
        lib.fwa_fwd_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
            + [ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_void_p])
        lib.fwa_fwd_launch.restype = ctypes.c_int
        lib.fwa_fwd_wide_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
            + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
        lib.fwa_fwd_wide_launch.restype = ctypes.c_int
        lib.fwa_empty_launch.argtypes = [ctypes.c_void_p]
        lib.fwa_empty_launch.restype = ctypes.c_int
        lib.fwa_error_string.argtypes = [ctypes.c_int]
        lib.fwa_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = build.load(BWD_SOURCE)
    if lib.fwa_bwd_launch.argtypes is None:
        lib.fwa_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 14 + [ctypes.c_int] * 11
            + [ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_void_p])
        lib.fwa_bwd_launch.restype = ctypes.c_int
        lib.fwa_bwd_wide_launch.argtypes = (
            [ctypes.c_void_p] * 15 + [ctypes.c_int] * 9
            + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
        lib.fwa_bwd_wide_launch.restype = ctypes.c_int
        lib.fwa_bwd_error_string.argtypes = [ctypes.c_int]
        lib.fwa_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(fn: str, x, lengths, num_heads, w1, b1, w2, b2, g=None,
                  k1=None, k2=None, keep=1.0):
    """Checks shared by both kernels, one pass over the tensors; returns
    (lead, B, S, D, dh), `lead` () for one replica or (R,) for a replica
    axis that every tensor leads with.  The dropout masks come both or
    neither, with 0 < keep <= 1."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn} runs on CUDA tensors, x is on {x.device}")
    if x.dim() not in (3, 4):
        raise ValueError(
            f"{fn}: x must be [B, S, D] or [R, B, S, D], got {tuple(x.shape)}")
    lead = tuple(x.shape[:-3])
    B, S, D = x.shape[-3:]
    if S < 1 or num_heads < 1 or D % num_heads:
        raise ValueError(
            f"{fn}: needs S >= 1 and D % num_heads == 0; "
            f"got S={S}, D={D}, num_heads={num_heads}")
    dh = D // num_heads
    index = x.get_device()
    wshape, bshape = lead + (dh, dh), lead + (dh,)
    todo = [("x", x, _F32, lead + (B, S, D)), ("lengths", lengths, _I32, lead + (B,)),
            ("w1", w1, _F32, wshape), ("b1", b1, _F32, bshape),
            ("w2", w2, _F32, wshape), ("b2", b2, _F32, bshape)]
    if g is not None:
        todo.append(("g", g, _F32, lead + (B, D)))
    if (k1 is None) != (k2 is None):
        raise ValueError(f"{fn}: the dropout masks k1 and k2 come together")
    if k1 is not None:
        if not 0.0 < keep <= 1.0:
            raise ValueError(f"{fn}: keep must lie in (0, 1], got {keep}")
        mshape = lead + (B, S, num_heads, dh)
        todo += [("k1", k1, _BOOL, mshape), ("k2", k2, _BOOL, mshape)]
    for name, t, dtype, shape in todo:
        if (t.get_device() != index or t.dtype is not dtype or t.shape != shape
                or not t.is_contiguous()):
            check_tensor(fn, name, t, dtype, shape, x.device)
    return lead, B, S, D, dh


def _ptr(t) -> int:
    """A tensor's address, or null for no tensor."""
    return None if t is None else t.data_ptr()


def fwa_forward(x: torch.Tensor, lengths: torch.Tensor, num_heads: int,
                w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                b2: torch.Tensor, k1=None, k2=None,
                keep: float = 1.0) -> torch.Tensor:
    """K1.  x f32 [B, S, D], lengths i32 [B], w1/w2 f32 [dh, dh], b1/b2 f32
    [dh] (dh = D / num_heads), all contiguous on one CUDA device →
    out f32 [B, D]; or every tensor with a leading replica axis R (x [R,
    B, S, D], ..., out [R, B, D]), R replicas in one launch.  Dropout:
    `k1` and `k2`, bool [B, S, num_heads, dh] (R first with the replica
    axis), keep x's and map1's entries, each divided by `keep`.  Records no
    gradient: `FWAFunction` does."""
    global launches
    lead, B, S, D, dh = _check_inputs("fwa_forward", x, lengths, num_heads,
                                      w1, b1, w2, b2, None, k1, k2, keep)
    out = x.new_empty(lead + (B, D))
    if B == 0 or math.prod(lead) == 0:
        return out
    plan = launch_plan(B, S, D, num_heads, replicas=math.prod(lead))
    lib = _library()
    ptrs = (x.data_ptr(), lengths.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr())
    if plan.wide:
        scratch = _wide_buffer(x, plan, False)
        err = launch(x.get_device(), lambda stream: lib.fwa_fwd_wide_launch(
            *ptrs, scratch.data_ptr(), _ptr(k1), _ptr(k2), B, S, D, num_heads, dh,
            plan.rows, int(plan.fused), plan.replicas, plan.scratch, keep, stream))
    else:
        err = launch(x.get_device(), lambda stream: lib.fwa_fwd_launch(
            *ptrs, plan.units, S, D, num_heads, dh, plan.grid, plan.replicas, plan.threads,
            plan.smem, _ptr(k1), _ptr(k2), keep, stream))
    if err != 0:
        raise RuntimeError(
            f"fwa_fwd launch failed: {lib.fwa_error_string(err).decode()}")
    launches += 1
    return out


def _bwd_scratch(x: torch.Tensor, plan: Plan):
    """x's device's K2 scratch, grown to the plan's size, one tree a
    replica: (slots, tickets).  The kernel leaves every ticket at 0 again."""
    index = x.get_device()
    need_slots, need_tickets = plan.replicas * plan.slots, plan.replicas * plan.tickets
    slots, tickets = _scratch.get(index, (None, None))
    if slots is None or slots.numel() < need_slots:
        slots = x.new_empty(max(need_slots, 1))
    if tickets is None or tickets.numel() < need_tickets:
        tickets = x.new_zeros(max(need_tickets, 1), dtype=_I32)
    _scratch[index] = (slots, tickets)
    return slots, tickets


def _wide_buffer(x: torch.Tensor, plan: Plan, backward: bool) -> torch.Tensor:
    """x's device's scratch of the wide K1 (K2 with `backward`), grown to
    the plan's floats for all its replicas."""
    key = (x.get_device(), backward)
    need = plan.replicas * plan.scratch
    buf = _wide_scratch.get(key)
    if buf is None or buf.numel() < need:
        buf = _wide_scratch[key] = x.new_empty(need)
    return buf


def fwa_backward(x: torch.Tensor, lengths: torch.Tensor, num_heads: int,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, g: torch.Tensor, k1=None, k2=None,
                 keep: float = 1.0):
    """K2.  The inputs of `fwa_forward` plus g = dL/dout f32 [B, D], all
    contiguous on one CUDA device → (dx [B, S, D], dw1, db1, dw2, db2); or
    every tensor with a leading replica axis R, each replica's gradients
    its own ([R, B, S, D], [R, dh, dh], ...), in one launch; with the
    forward's dropout masks and keep, the gradients of the dropped forward.
    The weight gradients are summed without atomics, so two calls on the
    same inputs agree bit for bit."""
    global bwd_launches
    lead, B, S, D, dh = _check_inputs("fwa_backward", x, lengths, num_heads,
                                      w1, b1, w2, b2, g, k1, k2, keep)
    # the kernel writes every entry; an empty batch gives zero gradients
    new = x.new_empty if B else x.new_zeros
    dx = x.new_empty(lead + (B, S, D))
    dw1, db1 = new(lead + (dh, dh)), new(lead + (dh,))
    dw2, db2 = new(lead + (dh, dh)), new(lead + (dh,))
    if B == 0 or math.prod(lead) == 0:
        return dx, dw1, db1, dw2, db2
    plan = launch_plan(B, S, D, num_heads, True, math.prod(lead))
    lib = _bwd_library()
    ptrs = (x.data_ptr(), lengths.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), g.data_ptr(), dx.data_ptr())
    grads = (dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr())
    if plan.wide:
        scratch = _wide_buffer(x, plan, True)
        err = launch(x.get_device(), lambda stream: lib.fwa_bwd_wide_launch(
            *ptrs, *grads, scratch.data_ptr(), _ptr(k1), _ptr(k2), B, S, D, num_heads, dh,
            plan.rows, plan.splits, plan.split_rows, plan.replicas, plan.scratch, keep,
            stream))
    else:
        slots, tickets = _bwd_scratch(x, plan)
        err = launch(x.get_device(), lambda stream: lib.fwa_bwd_launch(
            *ptrs, slots.data_ptr(), tickets.data_ptr(), *grads, plan.units, S, D,
            num_heads, dh, plan.grid, plan.replicas, plan.slots, plan.tickets, plan.threads,
            plan.smem, _ptr(k1), _ptr(k2), keep, stream))
    if err != 0:
        raise RuntimeError(
            f"fwa_bwd launch failed: {lib.fwa_bwd_error_string(err).decode()}")
    bwd_launches += 1
    return dx, dw1, db1, dw2, db2


def _keep(drop):
    """(k1, k2, rate) → (k1, k2, keep), keep = 1 − rate as the plain
    version computes it; nothing stays nothing."""
    return (*drop[:2], 1.0 - drop[2]) if drop else ()


class FWAFunction(torch.autograd.Function):
    """Feature-wise attention with K1 forward and K2 backward.  Like the
    JAX custom_vjp, it saves only the inputs (x, lengths, the weights and
    the dropout masks) and recomputes the maps in the backward.  Arguments
    are those of `fwa_forward`, with or without the replica axis, but the
    dropout rate in place of keep (x, lengths, num_heads, w1, b1, w2, b2,
    then k1, k2, rate under dropout); lengths, num_heads and the masks get
    no gradient.  Under ``torch.func.vmap`` its vmap rule applies it to the
    replica axis."""

    @staticmethod
    def forward(x, lengths, num_heads, w1, b1, w2, b2, *drop):
        # drop: (k1, k2, rate) under dropout, else nothing
        return fwa_forward(x, lengths, num_heads, w1, b1, w2, b2, *_keep(drop))

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, lengths, num_heads, w1, b1, w2, b2, *drop = inputs
        ctx.num_heads, ctx.rate = num_heads, drop[2:]
        ctx.save_for_backward(x, lengths, w1, b1, w2, b2, *drop[:2])

    @staticmethod
    def backward(ctx, g):
        x, lengths, w1, b1, w2, b2, *masks = ctx.saved_tensors
        # g arrives from `out + u_emb` and the loss, possibly expanded
        dx, dw1, db1, dw2, db2 = fwa_backward(
            x, lengths, ctx.num_heads, w1, b1, w2, b2, g.contiguous(),
            *_keep(masks + list(ctx.rate)))
        return (dx, None, None, dw1, db1, dw2, db2) + (None,) * (3 if masks else 0)

    @staticmethod
    def vmap(info, in_dims, x, lengths, num_heads, w1, b1, w2, b2, *drop):
        R = info.batch_size
        tensors = (x, lengths, w1, b1, w2, b2, *drop[:2])
        dims = in_dims[:2] + in_dims[3:3 + len(tensors) - 2]
        x, lengths, *rest = (replica_first(t, d, R) for t, d in zip(tensors, dims))
        return FWAFunction.apply(x, lengths, num_heads, *rest, *drop[2:]), 0
