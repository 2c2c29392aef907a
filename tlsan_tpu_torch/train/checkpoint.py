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
save.  A serving-only save writes None.

`restore` also reads the JAX package's checkpoints: ``flax.serialization
.to_bytes({"step", "params", "opt_state"})`` (tlsan_tpu/train/checkpoint.py),
told apart from a ``torch.save`` file (a zip, ``PK\x03\x04``) by its first
byte (a msgpack map) and decoded by train/msgpack.py.  The parameters load
strictly by the JAX tree's names (tools/params.py); the optimizer state,
optax's ``chain(clip_by_global_norm, opt)`` (tlsan_tpu/train/state.py),
becomes the port's ``{"count", "slots"}``, the optimizer read from its
layout (`JAX_OPT_LAYOUTS`).  So ``Trainer`` (``--resume``), ``serve.cli``,
``serve.http`` and ``Recommender.from_model_dir`` open a JAX ``--model_dir``
as they open the port's.  Saves stay ``torch.save``.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from tlsan_tpu_torch.core.config import save_config_json
from tlsan_tpu_torch.train import msgpack

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


TORCH_MAGIC = b"PK\x03\x04"  # torch.save writes a zip
# the non-empty entries of optax's inner chain state, by optimizer, as flax
# writes ``chain(clip_by_global_norm, opt)``'s state: the clip's ("0") is
# empty; "count" alone is the lr schedule's, the rest the slots
JAX_OPT_LAYOUTS = {
    "sgd": {"1": {"count"}},
    "adam": {"0": {"count", "mu", "nu"}, "1": {"count"}},
    "adadelta": {"1": {"e_g", "e_x"}, "2": {"count"}},
    "rmsprop": {"0": {"nu"}, "1": {"count"}},
}


def checkpoint_format(path: str) -> str:
    """"torch" for the port's ``torch.save`` file, "jax" for the JAX
    package's flax msgpack; raises ValueError naming both for anything
    else."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head.startswith(TORCH_MAGIC):
        return "torch"
    if head and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf)):
        return "jax"
    raise ValueError(
        f"{path} is neither a torch.save checkpoint (a zip, starting "
        f"{TORCH_MAGIC!r}) nor a JAX package checkpoint (flax msgpack, a map: "
        f"first byte 0x80-0x8f, 0xde or 0xdf); it starts {head!r}")


def jax_opt_state(opt_state: Any, model: nn.Module,
                  optimizer: Optional[str] = None) -> Optional[Dict]:
    """A JAX checkpoint's optax state (flax's state dict of it) as the
    port's ``{"count", "slots"}``; the optimizer is read from its layout,
    and must be `optimizer` when that is given.  Adam's bias-correction
    count must equal the schedule's.  None stays None."""
    from tlsan_tpu_torch.tools.params import state_from_tree

    if opt_state is None:
        return None
    inner = opt_state.get("1") if isinstance(opt_state, dict) else None
    if set(opt_state) != {"0", "1"} or opt_state["0"] or not isinstance(inner, dict):
        raise ValueError("the JAX checkpoint's opt_state is not optax's "
                         "chain(clip_by_global_norm, opt) state")
    layout = {k: set(v) for k, v in inner.items() if v}
    names = [n for n, want in JAX_OPT_LAYOUTS.items() if want == layout]
    if not names:
        raise ValueError(f"the JAX checkpoint's optimizer state {layout} is none "
                         f"of {sorted(JAX_OPT_LAYOUTS)}")
    name = names[0]
    if optimizer is not None and optimizer != name:
        raise ValueError(f"the JAX checkpoint was written by the {name} optimizer; "
                         f"this run trains with {optimizer}")
    entries = {k: inner[k] for k in JAX_OPT_LAYOUTS[name]}
    (sched,) = [e for e in entries.values() if set(e) == {"count"}]
    count = int(sched["count"])
    out: Dict = {"count": count}
    slots = {}
    for entry in entries.values():
        for slot, tree in entry.items():
            if slot != "count":
                slots[slot] = state_from_tree(tree, model)
            elif entry is not sched and int(tree) != count:
                raise ValueError(f"the JAX checkpoint's {name} count {int(tree)} "
                                 f"differs from its schedule count {count}")
    if slots:
        out["slots"] = slots
    return out


def restore(path: str, params: nn.Module, optimizer: Optional[str] = None
            ) -> Tuple[int, nn.Module, Any]:
    """Load a checkpoint, the port's or the JAX package's, into `params`
    (in place, on its own device); returns (step, params, opt_state).  A
    JAX checkpoint's parameters must be exactly the model's (names and
    shapes), and, with `optimizer`, its optimizer state that optimizer's."""
    from tlsan_tpu_torch.tools.params import state_from_tree

    if checkpoint_format(path) == "torch":
        payload = torch.load(path, map_location="cpu", weights_only=True)
        params.load_state_dict(payload["params"])
        return payload["step"], params, payload["opt_state"]
    with open(path, "rb") as f:
        payload = msgpack.loads(f.read())
    params.load_state_dict(state_from_tree(payload["params"], params))
    opt_state = jax_opt_state(payload.get("opt_state"), params, optimizer)
    return int(payload["step"]), params, opt_state


def maybe_wipe(model_dir: str, from_scratch: bool) -> None:
    """`from_scratch` wipes the model dir (reference: TLSAN/train.py:124-127)."""
    if from_scratch and os.path.exists(model_dir):
        shutil.rmtree(model_dir)
    os.makedirs(model_dir, exist_ok=True)
