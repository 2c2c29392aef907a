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

Both kernels run one warp per (batch row, head) unit; `launch_plan` gives
their geometry (pure Python, so the CPU tests hold it).  They take any
S >= 1 and heads of up to `MAX_HEAD_WIDTH` features.  K2 sums its weight
gradients across blocks through scratch memory that this module keeps per
device and reuses, so K2 calls on one device run on one stream at a time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from tlsan_tpu_torch.ops.cuda import build
from tlsan_tpu_torch.ops.cuda.common import SMEM_LIMIT, check_tensor, launch

SOURCE = "fwa_fwd"
BWD_SOURCE = "fwa_bwd"

WARP = 32
MAX_HEAD_WIDTH = 32        # kMaxDh in csrc/fwa_common.cuh
FWD_WARPS, BWD_WARPS = 4, 8  # warps (units) a block
GROUP = 128                # kGroup in csrc/fwa_bwd.cu: slots summed together

launches = 0
bwd_launches = 0

_F32 = torch.float32
_I32 = torch.int32
# K2's cross-block scratch per device index: (slots f32, tickets i32, all 0)
_scratch: dict = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: `grid` blocks of `threads` threads (`warps` units a
    block, `units` = B·H in all), `smem` bytes of dynamic shared memory;
    for K2 also `slots` scratch floats and `tickets` scratch integers."""
    dh: int
    units: int
    warps: int
    grid: int
    threads: int
    smem: int
    slots: int = 0
    tickets: int = 0


@functools.lru_cache(maxsize=512)
def launch_plan(B: int, S: int, D: int, num_heads: int,
                backward: bool = False) -> Plan:
    """The geometry of K1 (or, with `backward`, K2) for x [B, S, D] in
    `num_heads` heads; raises ValueError for what the kernels refuse."""
    if B < 1 or S < 1 or num_heads < 1 or D % num_heads:
        raise ValueError(
            f"feature-wise attention needs B, S >= 1 and D % num_heads == 0; "
            f"got B={B}, S={S}, D={D}, num_heads={num_heads}")
    dh = D // num_heads
    if dh > MAX_HEAD_WIDTH:
        raise ValueError(
            f"feature-wise attention kernels take heads of at most "
            f"{MAX_HEAD_WIDTH} features; got D={D}, num_heads={num_heads} "
            f"(dh={dh})")
    units = B * num_heads
    weights = 2 * dh * dh + 2 * dh
    if not backward:
        warps = FWD_WARPS
        grid = -(-units // warps)
        return Plan(dh, units, warps, grid, WARP * warps, 4 * weights)
    # W1 | W2 | b1 | b2, then per warp 32 staged steps of 4·dh + 1 floats
    # and its weight-gradient sums (64 bytes kept for the static flag)
    per_warp = WARP * (4 * dh + 1) + weights
    warps = BWD_WARPS
    while warps > 1 and 4 * (weights + warps * per_warp) > SMEM_LIMIT - 64:
        warps //= 2
    grid = -(-units // warps)
    slots, tickets, n = grid, 0, grid
    while n > 1:  # the levels of the cross-block tree
        n = -(-n // GROUP)
        slots += n
        tickets += n
    return Plan(dh, units, warps, grid, WARP * warps,
                4 * (weights + warps * per_warp), slots * weights, tickets)


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if lib.fwa_fwd_launch.argtypes is None:
        lib.fwa_fwd_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.fwa_fwd_launch.restype = ctypes.c_int
        lib.fwa_empty_launch.argtypes = [ctypes.c_void_p]
        lib.fwa_empty_launch.restype = ctypes.c_int
        lib.fwa_error_string.argtypes = [ctypes.c_int]
        lib.fwa_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = build.load(BWD_SOURCE)
    if lib.fwa_bwd_launch.argtypes is None:
        lib.fwa_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.fwa_bwd_launch.restype = ctypes.c_int
        lib.fwa_bwd_error_string.argtypes = [ctypes.c_int]
        lib.fwa_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(fn: str, x, lengths, num_heads, w1, b1, w2, b2, g=None):
    """Checks shared by both kernels, one pass over the tensors; returns
    (B, S, D, dh)."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn} runs on CUDA tensors, x is on {x.device}")
    if x.dim() != 3:
        raise ValueError(f"{fn}: x must be [B, S, D], got {tuple(x.shape)}")
    B, S, D = x.shape
    if S < 1 or num_heads < 1 or D % num_heads:
        raise ValueError(
            f"{fn}: needs S >= 1 and D % num_heads == 0; "
            f"got S={S}, D={D}, num_heads={num_heads}")
    dh = D // num_heads
    if dh > MAX_HEAD_WIDTH:
        raise ValueError(
            f"{fn}: the kernel takes heads of at most {MAX_HEAD_WIDTH} "
            f"features; got D={D}, num_heads={num_heads} (dh={dh})")
    index = x.get_device()
    wshape, bshape = (dh, dh), (dh,)
    todo = [("x", x, _F32, (B, S, D)), ("lengths", lengths, _I32, (B,)),
            ("w1", w1, _F32, wshape), ("b1", b1, _F32, bshape),
            ("w2", w2, _F32, wshape), ("b2", b2, _F32, bshape)]
    if g is not None:
        todo.append(("g", g, _F32, (B, D)))
    for name, t, dtype, shape in todo:
        if (t.get_device() != index or t.dtype is not dtype or t.shape != shape
                or not t.is_contiguous()):
            check_tensor(fn, name, t, dtype, shape, x.device)
    return B, S, D, dh


def fwa_forward(x: torch.Tensor, lengths: torch.Tensor, num_heads: int,
                w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                b2: torch.Tensor) -> torch.Tensor:
    """K1.  x f32 [B, S, D], lengths i32 [B], w1/w2 f32 [dh, dh], b1/b2 f32
    [dh] (dh = D / num_heads <= 32), all contiguous on one CUDA device →
    out f32 [B, D].  Records no gradient: `FWAFunction` does."""
    global launches
    B, S, D, dh = _check_inputs("fwa_forward", x, lengths, num_heads,
                                w1, b1, w2, b2)
    out = x.new_empty((B, D))
    if B == 0:
        return out
    plan = launch_plan(B, S, D, num_heads)
    lib = _library()
    err = launch(x.get_device(), lambda stream: lib.fwa_fwd_launch(
        x.data_ptr(), lengths.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), plan.units, S, D,
        num_heads, dh, plan.grid, plan.threads, plan.smem, stream))
    if err != 0:
        raise RuntimeError(
            f"fwa_fwd launch failed: {lib.fwa_error_string(err).decode()}")
    launches += 1
    return out


def _bwd_scratch(x: torch.Tensor, plan: Plan):
    """x's device's K2 scratch, grown to the plan's size: (slots, tickets).
    The kernel leaves every ticket at 0 again."""
    index = x.get_device()
    slots, tickets = _scratch.get(index, (None, None))
    if slots is None or slots.numel() < plan.slots:
        slots = x.new_empty(max(plan.slots, 1))
    if tickets is None or tickets.numel() < plan.tickets:
        tickets = x.new_zeros(max(plan.tickets, 1), dtype=_I32)
    _scratch[index] = (slots, tickets)
    return slots, tickets


def fwa_backward(x: torch.Tensor, lengths: torch.Tensor, num_heads: int,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, g: torch.Tensor):
    """K2.  The inputs of `fwa_forward` plus g = dL/dout f32 [B, D], all
    contiguous on one CUDA device → (dx [B, S, D], dw1, db1, dw2, db2).
    The weight gradients are summed without atomics, so two calls on the
    same inputs agree bit for bit."""
    global bwd_launches
    B, S, D, dh = _check_inputs("fwa_backward", x, lengths, num_heads,
                                w1, b1, w2, b2, g)
    # the kernel writes every entry; an empty batch gives zero gradients
    new = x.new_empty if B else x.new_zeros
    dx = x.new_empty((B, S, D))
    dw1, db1, dw2, db2 = new((dh, dh)), new((dh,)), new((dh, dh)), new((dh,))
    if B == 0:
        return dx, dw1, db1, dw2, db2
    plan = launch_plan(B, S, D, num_heads, True)
    lib = _bwd_library()
    slots, tickets = _bwd_scratch(x, plan)
    err = launch(x.get_device(), lambda stream: lib.fwa_bwd_launch(
        x.data_ptr(), lengths.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), g.data_ptr(), dx.data_ptr(),
        slots.data_ptr(), tickets.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
        dw2.data_ptr(), db2.data_ptr(), plan.units, S, D, num_heads, dh,
        plan.grid, plan.threads, plan.smem, stream))
    if err != 0:
        raise RuntimeError(
            f"fwa_bwd launch failed: {lib.fwa_bwd_error_string(err).decode()}")
    bwd_launches += 1
    return dx, dw1, db1, dw2, db2


class FWAFunction(torch.autograd.Function):
    """Feature-wise attention with K1 forward and K2 backward.  Like the
    JAX custom_vjp, it saves only the inputs (x, lengths and the weights)
    and recomputes the maps in the backward.  Arguments are those of
    `fwa_forward`; lengths and num_heads get no gradient."""

    @staticmethod
    def forward(ctx, x, lengths, num_heads, w1, b1, w2, b2):
        ctx.num_heads = num_heads
        ctx.save_for_backward(x, lengths, w1, b1, w2, b2)
        return fwa_forward(x, lengths, num_heads, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        x, lengths, w1, b1, w2, b2 = ctx.saved_tensors
        # g arrives from `out + u_emb` and the loss, possibly expanded
        dx, dw1, db1, dw2, db2 = fwa_backward(
            x, lengths, ctx.num_heads, w1, b1, w2, b2, g.contiguous())
        return dx, None, None, dw1, db1, dw2, db2
