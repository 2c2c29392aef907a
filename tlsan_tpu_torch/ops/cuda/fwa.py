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
"""

from __future__ import annotations

import ctypes

import torch

from tlsan_tpu_torch.ops.cuda import build

SOURCE = "fwa_fwd"
BWD_SOURCE = "fwa_bwd"

launches = 0
bwd_launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if lib.fwa_fwd_launch.argtypes is None:
        lib.fwa_fwd_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.fwa_fwd_launch.restype = ctypes.c_int
        lib.fwa_error_string.argtypes = [ctypes.c_int]
        lib.fwa_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = build.load(BWD_SOURCE)
    if lib.fwa_bwd_launch.argtypes is None:
        lib.fwa_bwd_scratch_floats.argtypes = [ctypes.c_int] * 4
        lib.fwa_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.fwa_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.fwa_bwd_launch.restype = ctypes.c_int
        lib.fwa_bwd_error_string.argtypes = [ctypes.c_int]
        lib.fwa_bwd_error_string.restype = ctypes.c_char_p
    return lib


def check_tensor(fn: str, name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape, device):
    """Raise unless `t` is on `device` with `dtype`, `shape` and a
    contiguous layout; `fn` and `name` go into the message."""
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{fn}: {name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _check_inputs(fn: str, x, lengths, num_heads, w1, b1, w2, b2):
    """Checks shared by both kernels; returns (B, S, D, dh)."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn} runs on CUDA tensors, x is on {x.device}")
    if x.dim() != 3:
        raise ValueError(f"{fn}: x must be [B, S, D], got {tuple(x.shape)}")
    B, S, D = x.shape
    if S < 1 or D % num_heads or D > 1024:
        raise ValueError(
            f"{fn}: needs S >= 1, D <= 1024 and D % num_heads == 0; "
            f"got S={S}, D={D}, num_heads={num_heads}")
    dh = D // num_heads
    check_tensor(fn, "x", x, torch.float32, (B, S, D), x.device)
    check_tensor(fn, "lengths", lengths, torch.int32, (B,), x.device)
    for name, w in (("w1", w1), ("w2", w2)):
        check_tensor(fn, name, w, torch.float32, (dh, dh), x.device)
    for name, b in (("b1", b1), ("b2", b2)):
        check_tensor(fn, name, b, torch.float32, (dh,), x.device)
    return B, S, D, dh


def fwa_forward(x: torch.Tensor, lengths: torch.Tensor, num_heads: int,
                w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                b2: torch.Tensor) -> torch.Tensor:
    """K1.  x f32 [B, S, D], lengths i32 [B], w1/w2 f32 [dh, dh], b1/b2 f32
    [dh] (dh = D / num_heads), all contiguous on one CUDA device → out f32
    [B, D].  Records no gradient: `FWAFunction` does."""
    global launches
    B, S, D, dh = _check_inputs("fwa_forward", x, lengths, num_heads,
                                w1, b1, w2, b2)
    out = torch.empty((B, D), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fwa_fwd_launch(
            x.data_ptr(), lengths.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(), B, S, D, dh, stream)
    if err != 0:
        raise RuntimeError(
            f"fwa_fwd launch failed: {lib.fwa_error_string(err).decode()}")
    launches += 1
    return out


def fwa_backward(x: torch.Tensor, lengths: torch.Tensor, num_heads: int,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, g: torch.Tensor):
    """K2.  The inputs of `fwa_forward` plus g = dL/dout f32 [B, D], all
    contiguous on one CUDA device → (dx [B, S, D], dw1, db1, dw2, db2).
    The weight gradients are summed without atomics, so two calls on the
    same inputs agree bit for bit."""
    global bwd_launches
    B, S, D, dh = _check_inputs("fwa_backward", x, lengths, num_heads,
                                w1, b1, w2, b2)
    check_tensor("fwa_backward", "g", g, torch.float32, (B, D), x.device)
    dev = x.device
    # the kernels write every entry; an empty batch gives zero gradients
    new = torch.empty if B else torch.zeros
    dx = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    dw1, dw2 = (new((dh, dh), dtype=torch.float32, device=dev)
                for _ in range(2))
    db1, db2 = (new((dh,), dtype=torch.float32, device=dev) for _ in range(2))
    if B == 0:
        return dx, dw1, db1, dw2, db2
    lib = _bwd_library()
    partial = torch.empty(lib.fwa_bwd_scratch_floats(B, S, D, dh),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fwa_bwd_launch(
            x.data_ptr(), lengths.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), g.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
            dw2.data_ptr(), db2.data_ptr(), B, S, D, dh, stream)
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
