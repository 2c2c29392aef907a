"""The weights bridge between a JAX parameter tree and the port's models.

A JAX tree (as numpy arrays) nests dicts and lists: TLSAN's is ``{"gamma",
"item_emb", ..., "long": [{w1, b1, w2, b2, proj_w, proj_b}, ...], "short":
[...]}``, ATRank's ``{"item_emb", ..., "self_blocks": [{"attn": {wq, ...},
"ffn": {w1, ...}}, ...], "vanilla_blocks": [...]}``.  The port's parameters
keep those names and layouts, the path joined by dots (``long.0.w1``,
``self_blocks.0.attn.wq``), so the copy is exact both ways, and gradients
come out in the same layout.

The replica fan-out's stacked parameters (train/ensemble.py: a leading
replica axis R on every parameter) move to and from the JAX fan-out's
stacked tree (``tlsan_tpu/train/ensemble.py``: a leading R on every leaf)
the same way, by `stacked_from_numpy` and `stacked_to_numpy`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

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


def _checked(tree: Dict[str, Any], model: nn.Module,
             lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """The JAX tree `tree` flattened to f32 tensors by `model`'s parameter
    names, each leaf shaped as the model's parameter after `lead`."""
    flat = _flatten(tree)
    state = model.state_dict()
    if set(flat) != set(state):
        raise KeyError(
            f"parameter names differ: missing {sorted(set(state) - set(flat))}, "
            f"unexpected {sorted(set(flat) - set(state))}")
    for name, arr in flat.items():
        want = lead + tuple(state[name].shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{name}: shape {arr.shape}, expected {want}")
    return {name: torch.from_numpy(np.array(arr, np.float32))
            for name, arr in flat.items()}


def state_from_tree(tree: Dict[str, Any], model: nn.Module) -> Dict[str, torch.Tensor]:
    """`model`'s state dict holding the values of the JAX tree `tree` (or
    flax's state dict of it, lists as maps keyed "0", "1", ...): f32 CPU
    tensors by parameter name; raises on a missing leaf, an extra one or a
    wrong shape."""
    return _checked(tree, model)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device) -> nn.Module:
    """A `get_model(cfg.model)` model on `device` holding the values of the
    JAX tree `tree`."""
    model = get_model(cfg.model)(cfg, device)
    model.load_state_dict(_checked(tree, model))
    return model


def stacked_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, replicas: int,
                       device) -> Dict[str, torch.Tensor]:
    """The JAX fan-out's stacked tree (`replicas` on a leading axis of every
    leaf) as the port fan-out's stacked parameters: f32 tensors [R, ...]
    on `device`, by parameter name."""
    model = get_model(cfg.model)(cfg, "cpu")
    return {name: t.to(device) for name, t in
            _checked(tree, model, (replicas,)).items()}


def stacked_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port fan-out's stacked parameters (by name, [R, ...]) as the JAX
    fan-out's stacked tree of numpy arrays."""
    return _unflatten({k: v.detach().cpu().numpy() for k, v in params.items()})


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
