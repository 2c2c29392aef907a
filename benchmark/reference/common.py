"""What the plain references share: the seeded weight draw, the sigmoid
cross-entropy, the clipped SGD steps and the excluded top-k.

Plain PyTorch in float32; no module of the program is imported.  Each
family's file (`reference/<family>.py`) gives `param_specs(config)`,
`loss(p, batch, cate_list, model)`, `scores(p, batch, cate_list, model)`
and `HISTORY`, the (ids, length) fields a served user's history lies in.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

Params = Dict[str, torch.Tensor]
Spec = Tuple[str, Tuple[int, ...], tuple]  # (name, shape, init)

GLOROT = ("glorot",)


def uniform(lo: float, hi: float) -> tuple:
    return ("uniform", lo, hi)


def draw(specs: Sequence[Spec], seed: int, device) -> Params:
    """Every leaf from one ``torch.rand`` on a generator on `device` seeded
    with `seed`: glorot-uniform leaves U(-l, l), l = sqrt(6 / (fan_in +
    fan_out)) over their last two axes; the others U(lo, hi)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (name, shape, init), n in zip(specs, sizes):
        if init[0] == "glorot":
            lim = math.sqrt(6.0 / (shape[-2] + shape[-1]))
            lo, hi = -lim, lim
        else:
            lo, hi = init[1], init[2]
        out[name] = (lo + (hi - lo) * u[off:off + n]).reshape(shape).clone()
        off += n
    return out


def sigmoid_ce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid cross-entropy, log(1 + e^-x) for y = 1 and
    log(1 + e^x) for y = 0, in the stable form max(x, 0) - x·y +
    log(1 + e^-|x|)."""
    return torch.mean(torch.clamp_min(logits, 0.0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def l2(*tensors: torch.Tensor) -> torch.Tensor:
    """Σ ½‖t‖² (tf.nn.l2_loss)."""
    return sum(0.5 * torch.sum(t * t) for t in tensors)


def layer_norm(x, gamma, beta, eps: float = 1e-8):
    """LayerNorm over the last axis, biased variance, eps inside the root
    (ATRank/model.py:461-488)."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return gamma * (x - mean) / torch.sqrt(var + eps) + beta


def sgd_steps(params: Params, batches: List[dict], loss_fn: Callable,
              lr: float, max_norm: float):
    """Clipped SGD over `batches`, one step each: g scaled by max_norm/‖g‖
    when the global norm ‖g‖ reaches max_norm, then p ← p + (−lr)·g.
    Returns (losses, {leaf: ‖g‖ of the first step}, {leaf: ‖Δp‖ after
    the first step}, {leaf: ‖Δp‖ after the last})."""
    start = {k: v.detach().clone() for k, v in params.items()}
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    names = list(p)
    losses, grad1, upd1 = [], None, None
    for b in batches:
        loss = loss_fn(p, b)
        grads = torch.autograd.grad(loss, [p[n] for n in names])
        losses.append(float(loss.detach()))
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = 1.0 if float(norm) < max_norm else max_norm / norm
        with torch.no_grad():
            for n, g in zip(names, grads):
                p[n] += -lr * (g * scale)
            if grad1 is None:
                grad1 = {n: float(torch.linalg.vector_norm(g)) for n, g in zip(names, grads)}
                upd1 = {n: float(torch.linalg.vector_norm(p[n] - start[n])) for n in names}
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(p[n] - start[n])) for n in names}
    return losses, grad1, upd1, change


def excluded_topk(logits: torch.Tensor, batch: dict, history, k: int):
    """The top-k (scores, ids) of each row after every history item of the
    row is set to -inf; returns them with the masked logits."""
    logits = logits.clone()
    rows = torch.arange(logits.shape[0], device=logits.device)
    for ids_key, len_key in history:
        ids, n = batch[ids_key].long(), batch[len_key].long()
        cols = torch.arange(ids.shape[1], device=ids.device)[None, :]
        r, c = torch.nonzero(cols < n[:, None], as_tuple=True)
        logits[rows[r], ids[r, c]] = -torch.inf
    vals, idx = torch.topk(logits, k, dim=1)
    return vals, idx, logits


class precision:
    """Run the enclosed reference with TF32 matrix products on (the
    control, one step below the configurations' float32) or off."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def __enter__(self):
        self.saved = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high" if self.tf32 else "highest")
        torch.backends.cudnn.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        torch.set_float32_matmul_precision(self.saved)
        torch.backends.cudnn.allow_tf32 = False
