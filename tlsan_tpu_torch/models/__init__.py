"""Model registry.  Each model is an ``nn.Module`` built as ``Model(cfg,
device)``, with ``init_params(generator)``, ``user_repr(batch, cate_list)``,
``item_repr``, ``all_item_repr``, ``pair_logits``, ``eval_logits`` and
``loss``.

TLSAN and ATRank are ported so far; each other family names the ROADMAP.md
item (queue 1) that ports it.
"""

from tlsan_tpu_torch.models.atrank import ATRank
from tlsan_tpu_torch.models.tlsan import TLSAN

_PORTED = {"tlsan": TLSAN, "atrank": ATRank}
# family → ROADMAP.md queue-1 item that ports it
_NOT_PORTED = {
    "shan": "item 11 (SHAN)", "bpr": "item 12 (BPR-MF)",
    "lspm": "item 13 (LSPM)", "paca": "item 14 (PACA)",
    "cnn": "item 15 (CNN)", "bilstm": "item 16 (Bi-LSTM)",
    "csan": "item 17 (CSAN)",
}


def get_model(name: str):
    """Resolve a model class by family name."""
    if name in _PORTED:
        return _PORTED[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet: ROADMAP.md "
            f"queue 1, {_NOT_PORTED[name]}")
    raise KeyError(
        f"unknown model {name!r}; one of {sorted([*_PORTED, *_NOT_PORTED])}")
