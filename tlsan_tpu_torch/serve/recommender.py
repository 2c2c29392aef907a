"""Serving: top-k recommendation over the full catalog, on one device.

Ported from tlsan_tpu/serve/recommender.py.  A `Recommender` holds the
model on its device and serves fixed-size request batches: the user tower
(on CUDA, TLSAN's two feature-wise attention kernels or ATRank's two
multi-head attention kernels a block), a [B, D] × [D, V] scoring
product in full f32, the catalog-padding and history masks, and
``torch.topk``.  It runs on CUDA unless the caller asks for the CPU; with
no GPU and no explicit ``device="cpu"`` it raises.

By default recommendations may include items from the user's own history —
the reference's eval semantics (SURVEY.md §8 quirk list); pass
`exclude_history=True` to mask them (LSPM's right-aligned window
included).

With a (dp, mp) `mesh` (ported from tlsan_tpu/serve/recommender.py:56-75,
:113-165) every rank of the world serves the same requests: the user
towers run on each dp index's share of a request batch's rows, the catalog
is scored per mp shard with a k·mp candidate exchange
(parallel/topk.py), the history filter runs on the host over k + slack
candidates, and every rank returns the whole result.  The HTTP server
stays on one device, as the JAX package's does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tlsan_tpu_torch.core import spans
from tlsan_tpu_torch.core.config import load_config_json, model_config_from_json
from tlsan_tpu_torch.models import get_model
from tlsan_tpu_torch.nn.embedding import mesh_context
from tlsan_tpu_torch.parallel import api
from tlsan_tpu_torch.parallel.mesh import Mesh, gather_rows
from tlsan_tpu_torch.parallel.topk import sharded_topk_scores
from tlsan_tpu_torch.train import checkpoint

# (ids_key, length_key) pairs that can hold a user's history in a batch
_HISTORY_KEYS = (("hist_i", "sl"), ("hist_i_new", "sl_new"))


def resolve_device(device=None) -> torch.device:
    """`device`, or CUDA when it is None; raises if CUDA is asked for and
    missing (there is no quiet fall back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


class Recommender:
    """Top-k item recommendation from a trained model.

    recommend(batch) → (item_ids [B, k] int32, scores [B, k] float32) as
    numpy; `batch` is the numpy dict layout the trainer and featurizer emit
    (u, hist_i, sl, ... — no candidate item or label fields).
    """

    def __init__(self, model, cate_list, k: int = 50,
                 exclude_history: bool = False, batch_size: int = 128,
                 device=None, mesh: Optional[Mesh] = None):
        """`model` holds the whole weights (true vocab sizes); with a
        `mesh` of more than one rank, each rank places its copy on the mesh
        (padded for mp, its own rows) and every rank must call `recommend`
        with the same requests."""
        self.device = resolve_device(device)
        # float32 matrix products in full f32 (TF32 off), as the JAX package
        # pins precision='highest': TF32 keeps ~10 mantissa bits, which
        # perturbs the top-k ranking and the parity with the reference
        torch.set_float32_matmul_precision("highest")
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None:
            if batch_size % self.mesh.dp:
                raise ValueError(f"batch_size {batch_size} must divide evenly "
                                 f"over dp={self.mesh.dp}")
            model = api.shard_model(model, self.mesh, self.device)
            cate_list = api.pad_cate_list(cate_list, model.cfg)
        self.model = model.to(self.device).eval()
        self.cfg = self.model.cfg
        self.k = k
        self.batch_size = batch_size
        self.cate_list = torch.as_tensor(np.asarray(cate_list, np.int32),
                                         device=self.device)
        self._exclude = exclude_history
        # LSPM packs its fixed-k window right-aligned (LSPM/input.py:30-37)
        self._right_aligned = self.cfg.model == "lspm"

    # ------------------------------------------------------------- compute

    def _history_valid(self, ids_key: str, ids: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
        """[B, L] bool: the columns of `ids` that hold history items.  The
        packers fill [0, sl); LSPM's right-aligned window fills [L-sl, L)
        (LSPM/input.py:30-37, JAX serve/recommender.py:37-50)."""
        L = ids.shape[1]
        cols = torch.arange(L, device=ids.device)[None, :]
        if self._right_aligned and ids_key == "hist_i":
            return cols >= L - lengths[:, None]
        return cols < lengths[:, None]

    def _recommend(self, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        with spans.span("serve.logits", inner="models."):
            logits = self.model.eval_logits(batch, self.cate_list)
        B, V = logits.shape
        with spans.span("serve.exclusion"):
            if self.cfg.catalog_items and self.cfg.catalog_items < V:
                logits[:, self.cfg.catalog_items:] = -torch.inf  # padding rows never rank
            if self._exclude:
                for ids_key, len_key in _HISTORY_KEYS:
                    if ids_key in batch and len_key in batch:
                        ids = batch[ids_key]  # [B, L]
                        valid = self._history_valid(ids_key, ids, batch[len_key])
                        rows = torch.arange(B, device=ids.device)[:, None].expand_as(ids)
                        # an add, as in the JAX package: duplicate ids still
                        # give −inf, never NaN
                        logits.index_put_(
                            (rows, ids),
                            torch.where(valid, -torch.inf, 0.0).to(logits.dtype),
                            accumulate=True)
        with spans.span("serve.topk"):
            vals, idx = torch.topk(logits, min(self.k, V), dim=1)
            return idx.to(torch.int32), vals

    def _recommend_meshed(self, batch: Dict[str, torch.Tensor]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The whole request batch's k + slack candidates (ids, scores), on
        every rank: this dp index's rows through the user tower and the
        sharded top-k, then the dp shares gathered (zero-filled buffers
        summed over dp).  Slack is the batch's excludable history width,
        so the host filter always leaves k survivors."""
        mesh = self.mesh
        local = api.shard_batch(batch, mesh)
        with mesh_context(mesh):
            u = self.model.user_repr(local, self.cate_list)
            all_emb, all_b = self.model.all_item_repr(self.cate_list)
        V = all_emb.shape[0] * mesh.mp
        slack = 0
        if self._exclude:
            slack = sum(batch[ids_key].shape[1] for ids_key, len_key in _HISTORY_KEYS
                        if ids_key in batch and len_key in batch)
        vals, idx = sharded_topk_scores(mesh, u, all_emb, all_b,
                                        min(self.k + slack, V),
                                        self.cfg.catalog_items or None)
        gather = dict(group=mesh.dp_group, index=mesh.d, parts=mesh.dp)
        return (gather_rows(idx.to(torch.int32), mesh, **gather),
                gather_rows(vals, mesh, **gather))

    def _exclude_host(self, batch: Dict[str, np.ndarray], ids: np.ndarray,
                      vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Filter history items out of the candidate lists (the mesh path);
        the first k survivors of each row, in score order."""
        B = len(ids)
        out_i = np.full((B, self.k), -1, np.int32)
        out_v = np.full((B, self.k), -np.inf, np.float32)
        for r in range(B):
            hist = set()
            for ids_key, len_key in _HISTORY_KEYS:
                if ids_key in batch and len_key in batch:
                    row, n = batch[ids_key][r], int(batch[len_key][r])
                    if self._right_aligned and ids_key == "hist_i":
                        hist.update(row[len(row) - n:].tolist())
                    else:
                        hist.update(row[:n].tolist())
            keep = [c for c, cand in enumerate(ids[r]) if cand not in hist][:self.k]
            out_i[r, :len(keep)] = ids[r][keep]
            out_v[r, :len(keep)] = vals[r][keep]
        return out_i, out_v

    # -------------------------------------------------------------- public

    @torch.inference_mode()
    def recommend(self, batch: Dict[str, np.ndarray]
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Pad the request to a multiple of the batch size, score each
        batch, unpad.  Spans (core/spans.py): ``serve.request`` around it
        all, ``serve.h2d`` and ``serve.d2h`` around the request's copies,
        and on one device ``serve.logits``, ``serve.exclusion`` and
        ``serve.topk`` a batch."""
        with spans.span("serve.request", device=self.device):
            n = len(next(iter(batch.values())))
            B = self.batch_size
            dev = {}
            with spans.span("serve.h2d"):
                for key, v in batch.items():
                    v = np.asarray(v)
                    if n % B:
                        pad = ((0, B - n % B),) + ((0, 0),) * (v.ndim - 1)
                        v = np.pad(v, pad)
                    dev[key] = torch.from_numpy(v).to(self.device)
            ids_out, vals_out = [], []
            for start in range(0, len(dev[next(iter(dev))]), B):
                chunk = {key: v[start:start + B] for key, v in dev.items()}
                if self.mesh is None:
                    idx, vals = self._recommend(chunk)
                else:
                    idx, vals = self._recommend_meshed(chunk)
                    if self._exclude:
                        idx, vals = map(torch.from_numpy, self._exclude_host(
                            {k: v.cpu().numpy() for k, v in chunk.items()},
                            idx.cpu().numpy(), vals.cpu().numpy()))
                    else:
                        idx, vals = idx[:, :self.k], vals[:, :self.k]
                ids_out.append(idx)
                vals_out.append(vals)
            with spans.span("serve.d2h"):
                ids = torch.cat(ids_out)[:n].cpu().numpy()
                vals = torch.cat(vals_out)[:n].cpu().numpy()
            return ids, vals

    # ---------------------------------------------------------- checkpoint

    @classmethod
    def from_model_dir(cls, model_dir: str, cate_list,
                       model_name: Optional[str] = None, device=None,
                       **kwargs) -> "Recommender":
        """Load the best gated-save checkpoint (falling back to latest) and
        its JSON config sidecar, through the CPU onto `device` (or the
        `mesh` keyword's ranks)."""
        path = checkpoint.best_checkpoint(model_dir)
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {model_dir}")
        sidecar = path[:-len(".ckpt")] + ".json"
        cfg = model_config_from_json(load_config_json(sidecar)["ModelConfig"])
        model = get_model(model_name or cfg.model)(cfg, "cpu")
        checkpoint.restore(path, model)
        return cls(model, cate_list, device=device, **kwargs)
