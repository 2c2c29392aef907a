"""Checkpoint save/restore with JSON config sidecars.

Mirrors tlsan_tpu/train/checkpoint.py (reference contract:
TLSAN/model.py:302-313, TLSAN/train.py:59-84): step-named
``<name>-<step>.ckpt`` files under model_dir, a ``<name>-<step>.json``
config sidecar per save, ``latest``/``best`` pointers, and the
`from_scratch` wipe.  The file is a ``torch.save`` of ``{"step", "params":
state_dict on the CPU, "opt_state"}``.  The optimizer entry is ``{"count":
n}``, the schedule count (train/state.py), so a resumed run continues the
lr schedule, and for Adam, Adadelta and RMSProp also ``"slots": {slot:
{parameter name: tensor}}`` (train/state.py `OptState.to_dict`), unpadded
under mp as the parameters are.  The sparse step keeps the same state as
the dense one (its count is the step), so either restores the other's
save.  A serving-only save writes None.  Reading the JAX package's
msgpack checkpoints is the migration slice's work.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from tlsan_tpu_torch.core.config import save_config_json

LATEST = "latest"
BEST = "best"


def save(model_dir: str, name: str, step: int,
         params: Union[nn.Module, Mapping[str, torch.Tensor]],
         opt_state: Any, *configs: Any, best: bool = False) -> str:
    """Write `<name>-<step>.ckpt` + `<name>-<step>.json` sidecar and update
    the latest-pointer.  `params` is a model or its state dict (a mesh
    saves the gathered, unpadded one).  `best=True` additionally updates
    the best-pointer, which the unconditional final-epoch save never
    touches."""
    os.makedirs(model_dir, exist_ok=True)
    stem = os.path.join(model_dir, f"{name}-{step}")
    if isinstance(params, nn.Module):
        params = params.state_dict()
    state = {k: v.detach().cpu() for k, v in params.items()}
    payload = {"step": step, "params": state, "opt_state": opt_state}
    torch.save(payload, stem + ".ckpt")
    if configs:
        save_config_json(stem + ".json", *configs)
    pointers = (LATEST, BEST) if best else (LATEST,)
    for pointer in pointers:
        with open(os.path.join(model_dir, pointer), "w") as f:
            f.write(f"{name}-{step}.ckpt\n")
    return stem + ".ckpt"


def _read_pointer(model_dir: str, pointer_name: str) -> Optional[str]:
    pointer = os.path.join(model_dir, pointer_name)
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        fname = f.read().strip()
    path = os.path.join(model_dir, fname)
    return path if os.path.exists(path) else None


def latest_checkpoint(model_dir: str) -> Optional[str]:
    """Path of the newest checkpoint, or None
    (≡ tf.train.get_checkpoint_state at TLSAN/train.py:71)."""
    return _read_pointer(model_dir, LATEST)


def best_checkpoint(model_dir: str) -> Optional[str]:
    """Path of the best gated-save checkpoint, falling back to latest."""
    return _read_pointer(model_dir, BEST) or _read_pointer(model_dir, LATEST)


def restore(path: str, params: nn.Module) -> Tuple[int, nn.Module, Any]:
    """Load a checkpoint into `params` (in place, on its own device);
    returns (step, params, opt_state)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    params.load_state_dict(payload["params"])
    return payload["step"], params, payload["opt_state"]


def maybe_wipe(model_dir: str, from_scratch: bool) -> None:
    """`from_scratch` wipes the model dir (reference: TLSAN/train.py:124-127)."""
    if from_scratch and os.path.exists(model_dir):
        shutil.rmtree(model_dir)
    os.makedirs(model_dir, exist_ok=True)
