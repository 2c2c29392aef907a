"""PyTorch wrapper of the CUDA multi-head attention kernel.

K3 (``csrc/mha_fwd.cu``, `mha_forward`) replaces
``tlsan_tpu/ops/pallas/mha.py::_mha_kernel``.  Its plain version is
``ops/multihead_attention.py::multihead_attention_reference``.
`MHAFunction` puts it under autograd as ``jax.custom_vjp`` puts
``_mha_forward``: the forward is K3, and the backward recomputes the plain
version and differentiates it, as ``_mha_bwd`` re-runs the jnp reference
through ``jax.vjp`` (the JAX package has no backward kernel).  The wrapper
checks what the kernel takes and raises on anything else; it never falls
back to the plain version.  ``launches`` counts the kernel's launches in
this process.

The kernel holds one batch row in shared memory: at D = 64 it takes Tq
and Tk up to 128 (larger shapes raise).  Its head width is the
reference's dh = D / H = 8, and D divides 256; other widths raise.
"""

from __future__ import annotations

import ctypes

import torch

from tlsan_tpu_torch.ops.cuda import build
from tlsan_tpu_torch.ops.cuda.fwa import check_tensor

SOURCE = "mha_fwd"
HEAD_WIDTH = 8
# the weight arguments of `mha_forward`, in order, by their JAX names
WEIGHTS = ("wq", "bq", "wk", "bk", "wv", "bv", "ln_gamma", "ln_beta")

launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if lib.mha_fwd_launch.argtypes is None:
        lib.mha_fwd_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.mha_fwd_smem_bytes.restype = ctypes.c_int
        lib.mha_fwd_max_smem_bytes.argtypes = []
        lib.mha_fwd_max_smem_bytes.restype = ctypes.c_int
        lib.mha_fwd_launch.argtypes = (
            [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.mha_fwd_launch.restype = ctypes.c_int
        lib.mha_error_string.argtypes = [ctypes.c_int]
        lib.mha_error_string.restype = ctypes.c_char_p
    return lib


def mha_forward(queries: torch.Tensor, keys: torch.Tensor, q_len: torch.Tensor,
                k_len: torch.Tensor, num_heads: int, wq, bq, wk, bk, wv, bv,
                ln_gamma, ln_beta) -> torch.Tensor:
    """K3.  queries f32 [B, Tq, D], keys f32 [B, Tk, D] (the same tensor
    for self-attention), q_len and k_len i32 [B], wq/wk/wv f32 [D, D],
    bq/bk/bv/ln_gamma/ln_beta f32 [D], all contiguous on one CUDA device →
    out f32 [B, Tq, D].  Records no gradient: `MHAFunction` does."""
    global launches
    fn = "mha_forward"
    if queries.device.type != "cuda":
        raise ValueError(f"{fn} runs on CUDA tensors, queries is on {queries.device}")
    if queries.dim() != 3 or keys.dim() != 3:
        raise ValueError(f"{fn}: queries and keys must be [B, T, D], got "
                         f"{tuple(queries.shape)} and {tuple(keys.shape)}")
    B, Tq, D = queries.shape
    Tk = keys.shape[1]
    if Tq < 1 or Tk < 1 or D != HEAD_WIDTH * num_heads or 256 % D:
        raise ValueError(
            f"{fn}: needs Tq, Tk >= 1, D = {HEAD_WIDTH} * num_heads and D "
            f"dividing 256; got Tq={Tq}, Tk={Tk}, D={D}, num_heads={num_heads}")
    dev = queries.device
    check_tensor(fn, "queries", queries, torch.float32, (B, Tq, D), dev)
    check_tensor(fn, "keys", keys, torch.float32, (B, Tk, D), dev)
    check_tensor(fn, "q_len", q_len, torch.int32, (B,), dev)
    check_tensor(fn, "k_len", k_len, torch.int32, (B,), dev)
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv)):
        check_tensor(fn, name, w, torch.float32, (D, D), dev)
    for name, v in (("bq", bq), ("bk", bk), ("bv", bv), ("ln_gamma", ln_gamma),
                    ("ln_beta", ln_beta)):
        check_tensor(fn, name, v, torch.float32, (D,), dev)
    lib = _library()
    smem = lib.mha_fwd_smem_bytes(Tq, Tk, D)
    if smem > lib.mha_fwd_max_smem_bytes():
        raise ValueError(
            f"{fn}: Tq={Tq}, Tk={Tk}, D={D} needs {smem} bytes of shared "
            f"memory a block, above the card's {lib.mha_fwd_max_smem_bytes()} "
            "(at D=64 the kernel takes Tq and Tk up to 128)")
    out = torch.empty((B, Tq, D), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mha_fwd_launch(
            queries.data_ptr(), keys.data_ptr(), q_len.data_ptr(),
            k_len.data_ptr(), wq.data_ptr(), bq.data_ptr(), wk.data_ptr(),
            bk.data_ptr(), wv.data_ptr(), bv.data_ptr(), ln_gamma.data_ptr(),
            ln_beta.data_ptr(), out.data_ptr(), B, Tq, Tk, D, num_heads,
            stream)
    if err != 0:
        raise RuntimeError(
            f"mha_fwd launch failed: {lib.mha_error_string(err).decode()}")
    launches += 1
    return out


class MHAFunction(torch.autograd.Function):
    """Multi-head attention with K3 forward.  Like the JAX custom_vjp, it
    saves only the inputs and recomputes in the backward, through the
    plain version under autograd.  Arguments are those of `mha_forward`;
    q_len, k_len and num_heads get no gradient.  For self-attention
    (queries is keys) the two gradients are summed by autograd."""

    @staticmethod
    def forward(ctx, queries, keys, q_len, k_len, num_heads, *weights):
        ctx.num_heads = num_heads
        ctx.save_for_backward(queries, keys, q_len, k_len, *weights)
        return mha_forward(queries, keys, q_len, k_len, num_heads, *weights)

    @staticmethod
    def backward(ctx, g):
        # imported here: ops/multihead_attention.py imports this module
        from tlsan_tpu_torch.ops.multihead_attention import (
            multihead_attention_reference,
        )

        queries, keys, q_len, k_len, *weights = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in (queries, keys, *weights)]
            out, _ = multihead_attention_reference(
                leaves[0], q_len, leaves[1], k_len, ctx.num_heads,
                dict(zip(WEIGHTS, leaves[2:])))
            grads = torch.autograd.grad(out, leaves, g)
        return (grads[0], grads[1], None, None, None, *grads[2:])
