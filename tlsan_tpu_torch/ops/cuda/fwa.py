"""PyTorch wrapper of the CUDA feature-wise attention forward (K1).

The kernel (``csrc/fwa_fwd.cu``) replaces
``tlsan_tpu/ops/pallas/fwa.py::_fwa_kernel``; its plain version is
``ops/feature_attention.py::feature_wise_attention_reference``.  The
wrapper checks what the kernel takes and raises on anything else; it never
falls back to the plain version.  ``launches`` counts the kernel launches
of this process.
"""

from __future__ import annotations

import ctypes

import torch

from tlsan_tpu_torch.ops.cuda import build

SOURCE = "fwa_fwd"

launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if lib.fwa_fwd_launch.argtypes is None:
        lib.fwa_fwd_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.fwa_fwd_launch.restype = ctypes.c_int
        lib.fwa_error_string.argtypes = [ctypes.c_int]
        lib.fwa_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device):
    if t.device != device:
        raise ValueError(f"fwa_forward: {name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"fwa_forward: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"fwa_forward: {name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"fwa_forward: {name} must be contiguous")


def fwa_forward(x: torch.Tensor, lengths: torch.Tensor, num_heads: int,
                w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                b2: torch.Tensor) -> torch.Tensor:
    """x f32 [B, S, D], lengths i32 [B], w1/w2 f32 [dh, dh], b1/b2 f32 [dh]
    (dh = D / num_heads), all contiguous on one CUDA device → out f32 [B, D]."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"fwa_forward runs on CUDA tensors, x is on {x.device}")
    if x.dim() != 3:
        raise ValueError(f"fwa_forward: x must be [B, S, D], got {tuple(x.shape)}")
    B, S, D = x.shape
    if S < 1 or D % num_heads or D > 1024:
        raise ValueError(
            f"fwa_forward: needs S >= 1, D <= 1024 and D % num_heads == 0; "
            f"got S={S}, D={D}, num_heads={num_heads}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise NotImplementedError(
            "fwa_forward has no backward yet (K2, the training slice); "
            "call it under torch.no_grad()")
    dh = D // num_heads
    _check("x", x, torch.float32, (B, S, D), x.device)
    _check("lengths", lengths, torch.int32, (B,), x.device)
    for name, w in (("w1", w1), ("w2", w2)):
        _check(name, w, torch.float32, (dh, dh), x.device)
    for name, b in (("b1", b1), ("b2", b2)):
        _check(name, b, torch.float32, (dh,), x.device)
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
