"""Model registry.  Each model is an ``nn.Module`` built as ``Model(cfg,
device)``, with ``init_params(generator)``, ``user_repr(batch, cate_list)``,
``item_repr``, ``all_item_repr``, ``pair_logits``, ``eval_logits`` and
``loss(batch, cate_list, generator=None)``.  All nine families of the JAX
package are here.
"""

from tlsan_tpu_torch.models.atrank import ATRank
from tlsan_tpu_torch.models.bilstm import BiLSTM
from tlsan_tpu_torch.models.bpr import BPR
from tlsan_tpu_torch.models.cnn import CNN
from tlsan_tpu_torch.models.csan import CSAN
from tlsan_tpu_torch.models.lspm import LSPM
from tlsan_tpu_torch.models.paca import PACA
from tlsan_tpu_torch.models.shan import SHAN
from tlsan_tpu_torch.models.tlsan import TLSAN

MODELS = {"tlsan": TLSAN, "shan": SHAN, "atrank": ATRank, "bpr": BPR,
          "lspm": LSPM, "paca": PACA, "cnn": CNN, "bilstm": BiLSTM,
          "csan": CSAN}


def get_model(name: str):
    """Resolve a model class by family name."""
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; one of {sorted(MODELS)}")
    return MODELS[name]
