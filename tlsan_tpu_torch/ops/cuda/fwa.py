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
`MAX_HEAD_WIDTH` features, and a wide variant (csrc/fwa_wide.cuh: one block
a unit, the steps in chunks that fit shared memory) for wider heads, up to
the widest whose chunk of one step fits a block's shared memory;
`launch_plan` gives their geometry (pure Python, so the
CPU tests hold it).  They take any S >= 1.  K2 sums its weight gradients
across blocks through scratch memory that this module keeps per device and
reuses, so K2 calls on one device run on one stream at a time.
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
# the wide variants (csrc/fwa_wide.cuh): kWideThreads, the steps a chunk at
# most, kWideGroup in csrc/fwa_bwd.cu; K2's blocks at most (two an SM) and
# the floats its slots may take a replica, which bound its grid
WIDE_THREADS, WIDE_CHUNK, WIDE_GROUP = 256, 32, 4
WIDE_BLOCKS, WIDE_SLOT_FLOATS = 264, 1 << 24

launches = 0
bwd_launches = 0

_F32 = torch.float32
_I32 = torch.int32
_BOOL = torch.bool
# K2's cross-block scratch per device index: (slots f32, tickets i32, all 0)
_scratch: dict = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: `grid` × `replicas` blocks of `threads` threads
    (`warps` units a block, `units` = B·H a replica), `smem` bytes of
    dynamic shared memory; for K2 also `slots` scratch floats and
    `tickets` scratch integers a replica (its cross-block tree).  The wide
    variant (`chunk` > 0) runs one unit a block at a time, the steps
    `chunk` at once."""
    dh: int
    units: int
    warps: int
    grid: int
    threads: int
    smem: int
    slots: int = 0
    tickets: int = 0
    replicas: int = 1
    chunk: int = 0


def _tree(n: int, group: int):
    """(slots, tickets) of a cross-block tree over n slots in groups."""
    slots, tickets = n, 0
    while n > 1:  # the levels of the tree
        n = -(-n // group)
        slots += n
        tickets += n
    return slots, tickets


def _wide_plan(B: int, S: int, dh: int, num_heads: int, backward: bool,
               replicas: int) -> Plan:
    """The wide variant's geometry: one block of WIDE_THREADS a unit (K2:
    at most WIDE_BLOCKS blocks, fewer where the slots would pass
    WIDE_SLOT_FLOATS), and the most steps a chunk (up to WIDE_CHUNK and S)
    whose arrays fit shared memory: x, m2, m1 and three per-feature
    statistics; K2 also dm2, dz1 and a fourth (g).  Raises ValueError
    where not even one step fits."""
    units = B * num_heads
    arrays, stats = (5, 4) if backward else (3, 3)
    room = (SMEM_LIMIT - 64) // 4 - stats * dh
    chunk = min(S, WIDE_CHUNK, room // (arrays * dh))
    if chunk < 1:
        raise ValueError(
            f"feature-wise attention's wide {'K2' if backward else 'K1'} keeps a step "
            f"of {arrays + stats}·dh floats in a block's shared memory ({SMEM_LIMIT} "
            f"bytes): heads of dh={dh} features do not fit")
    smem = 4 * (arrays * chunk * dh + stats * dh)
    warps = WIDE_THREADS // WARP
    if not backward:
        return Plan(dh, units, warps, units, WIDE_THREADS, smem, replicas=replicas,
                    chunk=chunk)
    weights = 2 * dh * dh + 2 * dh
    grid = min(units, WIDE_BLOCKS, max(1, WIDE_SLOT_FLOATS // weights))
    slots, tickets = _tree(grid, WIDE_GROUP)
    return Plan(dh, units, warps, grid, WIDE_THREADS, smem, slots * weights, tickets,
                replicas, chunk)


@functools.lru_cache(maxsize=512)
def launch_plan(B: int, S: int, D: int, num_heads: int,
                backward: bool = False, replicas: int = 1) -> Plan:
    """The geometry of K1 (or, with `backward`, K2) for x [B, S, D] in
    `num_heads` heads, for each of `replicas` replicas (the grid's y axis;
    a replica's blocks, and K2's scratch tree, are those of one replica's
    launch); raises ValueError for what the kernels refuse."""
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
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
            + [ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_void_p])
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
            [ctypes.c_void_p] * 14 + [ctypes.c_int] * 12
            + [ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_void_p])
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
    args = (x.data_ptr(), lengths.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(), plan.units, S, D,
            num_heads, dh)
    tail = (plan.grid, plan.replicas, plan.threads, plan.smem, _ptr(k1), _ptr(k2), keep)
    if plan.chunk:
        err = launch(x.get_device(), lambda stream: lib.fwa_fwd_wide_launch(
            *args, plan.chunk, *tail, stream))
    else:
        err = launch(x.get_device(), lambda stream: lib.fwa_fwd_launch(*args, *tail, stream))
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
    slots, tickets = _bwd_scratch(x, plan)
    args = (x.data_ptr(), lengths.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), g.data_ptr(), dx.data_ptr(),
            slots.data_ptr(), tickets.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
            dw2.data_ptr(), db2.data_ptr(), plan.units, S, D, num_heads, dh)
    tail = (plan.grid, plan.replicas, plan.slots, plan.tickets, plan.threads,
            plan.smem, _ptr(k1), _ptr(k2), keep)
    if plan.chunk:
        err = launch(x.get_device(), lambda stream: lib.fwa_bwd_wide_launch(
            *args, plan.chunk, *tail, stream))
    else:
        err = launch(x.get_device(), lambda stream: lib.fwa_bwd_launch(*args, *tail, stream))
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
