"""Shared layers, ported from tlsan_tpu/nn/layers.py: layer norm, dropout,
dense, the TF-1.8 LSTM as a loop over time, the valid-prefix reversal and
the per-row time gather; and the one-hot of the time buckets that ATRank
and CNN share.

Dropout's keep masks come from a "source": a ``torch.Generator`` (each
draw one ``torch.rand``), or an object with ``draw(shape, keep, device)``
that stands in for one — `RowShardMasks` (a mesh rank's rows of the
global batch's masks), `GivenMasks` (masks drawn beforehand, for the
replica fan-out) or `RecordedShapes` (the draws' shapes).  The models and
the attention dispatchers take either where they take a generator."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-8) -> torch.Tensor:
    """LayerNorm over the last axis with the biased moment variance and
    `eps` inside the square root (reference: ATRank/model.py:461-488)."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return gamma * (x - mean) / torch.sqrt(var + eps) + beta


class RowShardMasks:
    """A mask source for one dp rank of a mesh: every rank draws the
    GLOBAL batch's mask from its generator (the same seed on every rank, so
    the same draws) and keeps its own rows, [d·b, (d+1)·b) of the leading
    batch axis, as it keeps its rows of the batch
    (parallel/multihost.py::local_batch_slice).  So a dp run sees, row for
    row, the masks that one process sees, as the JAX mesh draws one key
    over the global batch."""

    def __init__(self, generator: torch.Generator, shards: int, index: int):
        self.generator, self.shards, self.index = generator, shards, index

    def draw(self, shape, keep: float, device) -> torch.Tensor:
        b = shape[0]
        full = draw_keep(self.generator, (b * self.shards,) + tuple(shape[1:]),
                         keep, device)
        return full[self.index * b:(self.index + 1) * b]


class GivenMasks:
    """A mask source that hands out masks drawn beforehand, in order (the
    replica fan-out draws each replica's outside ``torch.func.vmap``, where
    explicit generators do not run); each must have the shape asked for."""

    def __init__(self, masks: Sequence[torch.Tensor]):
        self.masks = list(masks)

    def draw(self, shape, keep: float, device) -> torch.Tensor:
        if not self.masks:
            raise RuntimeError(f"no dropout mask left for a draw of {tuple(shape)}")
        mask = self.masks.pop(0)
        if tuple(mask.shape) != tuple(shape):
            raise RuntimeError(f"the next dropout mask is {tuple(mask.shape)}, "
                               f"a draw of {tuple(shape)} asked for")
        return mask


class RecordedShapes:
    """A mask source that keeps everything (all-true masks) and records the
    shape of each draw, in order: what a forward draws, found without
    drawing (the fan-out's shapes per batch shape)."""

    def __init__(self):
        self.shapes = []

    def draw(self, shape, keep: float, device) -> torch.Tensor:
        self.shapes.append(tuple(shape))
        return torch.ones(tuple(shape), dtype=torch.bool, device=device)


def draw_keep(source, shape, keep: float, device) -> torch.Tensor:
    """The keep flags (bool, `shape`) of one dropout draw: from a
    ``torch.Generator`` one ``torch.rand`` of f32 uniforms kept below
    `keep`, on the generator's device `device`; from a mask source (above)
    what its `draw` gives."""
    if isinstance(source, torch.Generator):
        u = torch.rand(tuple(shape), generator=source, dtype=torch.float32,
                       device=device)
        return u < keep
    return source.draw(tuple(shape), keep, device)


def apply_keep(x: torch.Tensor, keep_mask: torch.Tensor,
               rate: float) -> torch.Tensor:
    """Inverted dropout by a given mask: x / keep where kept, else 0, with
    keep = 1 − rate (a division, as tf.nn.dropout divides)."""
    keep = 1.0 - rate
    return torch.where(keep_mask, x / keep, torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float, generator=None,
            keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout (≡ tf.nn.dropout at train time): keep each element
    with probability 1 − rate and scale it by 1 / (1 − rate).  The mask is
    `keep_mask` when given, else drawn from `generator` (a
    ``torch.Generator`` on x's device, or a mask source above).  No-op when
    rate is 0 or there is neither (eval)."""
    if rate <= 0.0 or (generator is None and keep_mask is None):
        return x
    if keep_mask is None:
        keep_mask = draw_keep(generator, x.shape, 1.0 - rate, x.device)
    return apply_keep(x, keep_mask, rate)


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
