"""What the CUDA kernels' wrappers share: the check of one tensor, and a
launch on the current stream with no Python Stream object and no device
context unless another device is current."""

from __future__ import annotations

import torch

SMEM_LIMIT = 232_448  # shared memory a block may use on the H100

# the current device's index and a device's current stream as plain ints,
# through torch's own hooks (what its compiler launches with) where the
# build has them: no Python Stream object a call
current_device = getattr(torch._C, "_cuda_getDevice", None) or torch.cuda.current_device
raw_stream = (getattr(torch._C, "_cuda_getCurrentRawStream", None)
              or (lambda index: torch.cuda.current_stream(index).cuda_stream))


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


def launch(index: int, call) -> int:
    """Run `call(stream)` on device `index`'s current stream, entering the
    device's context only when another device is current."""
    if index == current_device():
        return call(raw_stream(index))
    with torch.cuda.device(index):
        return call(raw_stream(index))
