"""The weights bridge between a JAX parameter tree and the port's models.

A JAX tree (as numpy arrays) nests dicts and lists: TLSAN's is ``{"gamma",
"item_emb", ..., "long": [{w1, b1, w2, b2, proj_w, proj_b}, ...], "short":
[...]}``, ATRank's ``{"item_emb", ..., "self_blocks": [{"attn": {wq, ...},
"ffn": {w1, ...}}, ...], "vanilla_blocks": [...]}``.  The port's parameters
keep those names and layouts, the path joined by dots (``long.0.w1``,
``self_blocks.0.attn.wq``), so the copy is exact both ways, and gradients
come out in the same layout.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from tlsan_tpu_torch.core.config import ModelConfig
from tlsan_tpu_torch.models import get_model


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    flat = {}
    for key, value in items:
        flat.update(_flatten(value, f"{prefix}{key}."))
    return flat


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device) -> nn.Module:
    """A `get_model(cfg.model)` model on `device` holding the values of the
    JAX tree `tree`."""
    model = get_model(cfg.model)(cfg, device)
    flat = _flatten(tree)
    state = model.state_dict()
    if set(flat) != set(state):
        raise KeyError(
            f"parameter names differ: missing {sorted(set(state) - set(flat))}, "
            f"unexpected {sorted(set(flat) - set(state))}")
    for name, arr in flat.items():
        if tuple(arr.shape) != tuple(state[name].shape):
            raise ValueError(f"{name}: shape {arr.shape}, the model has "
                             f"{tuple(state[name].shape)}")
    model.load_state_dict(
        {name: torch.from_numpy(np.array(arr, np.float32))
         for name, arr in flat.items()})
    return model


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Dotted names back to nested dicts; a dict whose keys are all
    integers becomes a list."""
    tree: Dict[str, Any] = {}
    for name, arr in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def params_to_numpy(model: nn.Module) -> Dict[str, Any]:
    """The JAX-shaped tree of numpy arrays holding `model`'s values."""
    return _unflatten({k: v.detach().cpu().numpy()
                       for k, v in model.state_dict().items()})


def grads_to_numpy(model: nn.Module) -> Dict[str, Any]:
    """The JAX-shaped tree of numpy arrays holding `model`'s gradients
    (`.grad`; zeros where a parameter has none), so gradient leaves compare
    by name with a JAX grad tree."""
    return _unflatten({
        name: (p.grad if p.grad is not None else torch.zeros_like(p))
        .detach().cpu().numpy() for name, p in model.named_parameters()})
