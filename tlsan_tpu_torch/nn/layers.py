"""Shared layers, ported from tlsan_tpu/nn/layers.py: layer norm, dropout,
dense, the TF-1.8 LSTM as a loop over time, the valid-prefix reversal and
the per-row time gather; and the one-hot of the time buckets that ATRank
and CNN share."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-8) -> torch.Tensor:
    """LayerNorm over the last axis with the biased moment variance and
    `eps` inside the square root (reference: ATRank/model.py:461-488)."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return gamma * (x - mean) / torch.sqrt(var + eps) + beta


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout (≡ tf.nn.dropout at train time): keep each element
    with probability 1 − rate and scale it by 1 / (1 − rate).  The mask is
    drawn from `generator`, which lives on x's device.  No-op when rate is 0
    or there is no generator (eval)."""
    if rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                   device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
          activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
          ) -> torch.Tensor:
    """x @ w (+ b) (then `activation`), with w [in, out] as in the JAX
    package.  f32 at full precision: the entry points keep TF32 off."""
    out = x @ w
    if b is not None:
        out = out + b
    if activation is not None:
        out = activation(out)
    return out


def one_hot(buckets: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """jax.nn.one_hot: a comparison with arange(n), so bucket n (and
    anything outside 0..n-1) gives a zero row (torch's one_hot raises)."""
    classes = torch.arange(n, dtype=buckets.dtype, device=buckets.device)
    return (buckets[..., None] == classes).to(dtype)


def lstm_scan(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, hidden: int,
              forget_bias: float = 1.0) -> torch.Tensor:
    """TF-1.8 LSTMCell over [B, T, D] → outputs [B, T, H], one step at a
    time (the JAX package's lax.scan).  The layout is tf.nn.rnn_cell.LSTMCell's
    (reference: Bi-LSTM/model.py:197-205): one kernel [D+H, 4H] applied to
    concat([x_t, h]), split into (i, j, f, o), `forget_bias` added to f.
    Plain matrix products and elementwise ops, not torch.nn.LSTM, whose
    gates come in another order with two biases."""
    B = x.shape[0]
    c = x.new_zeros((B, hidden))
    h = x.new_zeros((B, hidden))
    outs = []
    for t in range(x.shape[1]):
        z = torch.cat([x[:, t], h], dim=-1) @ w + b
        i, j, f, o = torch.split(z, hidden, dim=-1)
        c = torch.sigmoid(f + forget_bias) * c + torch.sigmoid(i) * torch.tanh(j)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, dim=1)


def _take_time(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, t], ...] for x [B, T] or [B, T, D] and idx [B, T']."""
    idx = idx.long()
    if x.dim() == 3:
        idx = idx[..., None].expand(-1, -1, x.shape[2])
    return torch.gather(x, 1, idx)


def reverse_valid(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse the first `lengths[b]` steps of each row, like
    tf.reverse_sequence: the padding past a row's length keeps its place."""
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    n = lengths.long()[:, None]
    return _take_time(x, torch.where(pos < n, n - 1 - pos, pos))


def gather_time(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x[b, t[b], :] (≡ reference extract_axis_1, Bi-LSTM/model.py:191-195).
    A negative t wraps as in jnp.take_along_axis: t = −1, the step before
    an empty history, reads the last step."""
    T = x.shape[1]
    return _take_time(x, (t.long() % T)[:, None])[:, 0]
