"""The weights bridge between the JAX parameter tree and the port's TLSAN.

The JAX tree (as numpy arrays) is ``{"gamma", "item_emb", "item_b",
"user_emb", "usert_emb", "cate_emb", "long": [{w1, b1, w2, b2, proj_w,
proj_b}, ...], "short": [{w1, b1, w2, b2}, ...]}``; the port's parameters
keep those names and layouts, so the copy is exact both ways, and gradients
come out in the same layout.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from tlsan_tpu_torch.core.config import ModelConfig
from tlsan_tpu_torch.models.tlsan import TLSAN


def _flatten(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        if isinstance(value, (list, tuple)):
            for i, blk in enumerate(value):
                for name, arr in blk.items():
                    flat[f"{key}.{i}.{name}"] = np.asarray(arr)
        else:
            flat[key] = np.asarray(value)
    return flat


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device) -> TLSAN:
    """A TLSAN on `device` holding the values of the JAX tree `tree`."""
    model = TLSAN(cfg, device)
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
    tree: Dict[str, Any] = {}
    for name, arr in flat.items():
        parts = name.split(".")
        if len(parts) == 1:
            tree[name] = arr
            continue
        group, i, leaf = parts[0], int(parts[1]), parts[2]
        blocks = tree.setdefault(group, [])
        while len(blocks) <= i:
            blocks.append({})
        blocks[i][leaf] = arr
    return tree


def params_to_numpy(model: TLSAN) -> Dict[str, Any]:
    """The JAX-shaped tree of numpy arrays holding `model`'s values."""
    return _unflatten({k: v.detach().cpu().numpy()
                       for k, v in model.state_dict().items()})


def grads_to_numpy(model: TLSAN) -> Dict[str, Any]:
    """The JAX-shaped tree of numpy arrays holding `model`'s gradients
    (`.grad`; zeros where a parameter has none), so gradient leaves compare
    by name with a JAX grad tree."""
    return _unflatten({
        name: (p.grad if p.grad is not None else torch.zeros_like(p))
        .detach().cpu().numpy() for name, p in model.named_parameters()})
