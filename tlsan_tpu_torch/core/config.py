"""Config system: dataclasses + JSON sidecar I/O.

Replaces the reference's per-trainer ``tf.app.flags`` tables
(reference: TLSAN/train.py:26-54 and the matching blocks in the other eight
trainers) with typed dataclasses.  Like the reference, the resolved config is
persisted as a JSON sidecar next to every checkpoint
(reference: TLSAN/model.py:306).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class DataCounts:
    """Catalog sizes of a preprocessed Amazon category dataset.

    Matches the counts tuple pickled by the ID-remap stage
    (reference: utils/2_remap_id.py:98-101).
    """

    user_count: int
    item_count: int
    cate_count: int
    example_count: int = 0


@dataclass(frozen=True)
class ModelConfig:
    """Union of the hyperparameters of all nine model families.

    Defaults follow the reference flag tables (see SURVEY.md §2.6).  Each
    model reads only the fields it needs.
    """

    model: str = "tlsan"

    # catalog sizes (filled from DataCounts).  When tables are row-sharded
    # over mp these are rounded up to a multiple of mp; catalog_items then
    # holds the true item count so eval can mask the padded catalog rows.
    user_count: int = 0
    item_count: int = 0
    cate_count: int = 0
    catalog_items: int = 0  # 0 → item_count is the true catalog size

    # embedding sizes (reference: TLSAN/train.py:33-35)
    itemid_embedding_size: int = 32
    userid_embedding_size: int = 32
    cateid_embedding_size: int = 32

    # attention tower (reference: TLSAN/train.py:30-32)
    hidden_units: int = 64
    num_blocks: int = 1
    num_heads: int = 8
    dropout: float = 0.0

    # TLSAN long-term window (reference: TLSAN/train.py:36 `Ls`)
    Ls: int = 10
    # static padded length of the short-term session (TPU static shapes; the
    # reference pads to the per-batch max — TLSAN/input.py:33-37)
    Ts: int = 16
    # generic max history length (prefix-window models; reference caps at 90)
    max_length: int = 90

    # LSPM (reference: LSPM/train.py:26-33): last-k window + mixing weight
    lspm_k: int = 5
    lspm_alpha: float = 1.0

    # PACA (reference: PACA/train.py:29-31)
    paca_kernel_size: int = 10
    paca_max_len: int = 90

    # CNN (reference: CNN/model.py:299-325): fixed time-axis pad + towers
    cnn_pad_length: int = 500
    cnn_num_filters: int = 32
    cnn_filter_sizes: Tuple[int, ...] = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10)

    # ATRank / CNN time featurization (reference: ATRank/train.py:40)
    concat_time_emb: bool = True

    # Bi-LSTM (reference: Bi-LSTM/model.py:20)
    lstm_hidden_units: int = 64

    # BPR (reference: BPR/model.py:13-20)
    bpr_user_embedding_size: int = 64

    # regularization (reference: TLSAN/train.py:40)
    regulation_rate: float = 5e-5

    def with_counts(self, counts: DataCounts) -> "ModelConfig":
        return dataclasses.replace(
            self,
            user_count=counts.user_count,
            item_count=counts.item_count,
            cate_count=counts.cate_count,
        )


@dataclass(frozen=True)
class TrainConfig:
    """Trainer hyperparameters (reference: TLSAN/train.py:26-54)."""

    dataset: str = "Digital_Music"
    data_dir: str = "Data"
    model_dir: str = "save_path"
    from_scratch: bool = True

    optimizer: str = "sgd"  # sgd | adam | adadelta | rmsprop
    learning_rate: float = 1.0
    max_gradient_norm: float = 5.0
    # LR drops to lr*0.1 at this global step (reference: TLSAN/train.py:232-233;
    # 270k for ATRank/CSAN/Bi-LSTM, 540k for CNN)
    lr_drop_step: int = 150_000

    train_batch_size: int = 32
    test_batch_size: int = 128
    max_epochs: int = 20

    display_freq: int = 100
    eval_freq: int = 1000
    # best-metric tracking only after this step (reference: TLSAN/train.py:222)
    best_after_step: int = 20_000
    # checkpoint gate: save only when AUC exceeds this and is a new best
    # (reference: TLSAN/train.py:228-230)
    save_auc_gate: float = 0.8

    seed: int = 1234

    # fused scan: number of train steps executed per device dispatch
    steps_per_call: int = 100

    # touched-row (sparse) vocab-table updates (train/sparse.py) for
    # optimizer in {'sgd', 'adam'}, composing with the (dp, mp) mesh
    # (single-process; the multi-process path keeps the dense step); exact
    # vs the dense step.  Measured on-chip (RESULTS.md round-2 study): the
    # dense XLA step wins below ~100k total vocab rows (every reference
    # dataset), the sparse step wins above (sub-linear in vocab vs linear;
    # ~40x at 2M rows for SGD; Adam's own elementwise moment passes bound
    # its win to ~2x).  None = auto by catalog size; True/False force.
    sparse_updates: Optional[bool] = None

    # auto threshold: total vocab rows (items + users) above which the
    # sparse path engages when sparse_updates is None
    sparse_auto_rows: int = 100_000

    # TensorBoard histogram summaries of the tables / gamma / attention
    # output (the reference's train_summary set, TLSAN/model.py:173-183),
    # device-side digests
    tb_histograms: bool = True
    # histogram cadence in steps.  The reference histograms at
    # display_freq (100); digesting the full tables costs ~100 ms+ at
    # Electronics scale, so the default here is the eval cadence
    # (documented deviation; set =display_freq for reference cadence)
    summary_freq: int = 1000

    # parallelism: data-parallel and model-parallel (table-sharding) axis sizes
    dp: int = 1
    mp: int = 1

    # training compute dtype: "float32" (default; bit-faithful to the TF f32
    # reference) or "bfloat16" (mixed precision: master params, optimizer
    # state, loss reductions and the L2 term stay f32; the forward/backward
    # network compute runs in bf16 — the standard TPU lever; opt-in because
    # exactness-vs-reference is the f32 contract).  Eval always runs f32.
    compute_dtype: str = "float32"


def save_config_json(path: str, *cfgs: Any) -> None:
    """Dump dataclass configs as one JSON sidecar (reference: TLSAN/model.py:306)."""
    merged: Dict[str, Any] = {}
    for cfg in cfgs:
        d = dataclasses.asdict(cfg)
        d = {k: (list(v) if isinstance(v, tuple) else v) for k, v in d.items()}
        merged[type(cfg).__name__] = d
    with open(path, "w") as f:
        json.dump(merged, f, indent=2, sort_keys=True)


def load_config_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def model_config_from_json(d: Dict[str, Any]) -> ModelConfig:
    d = dict(d)
    if "cnn_filter_sizes" in d:
        d["cnn_filter_sizes"] = tuple(d["cnn_filter_sizes"])
    return ModelConfig(**d)
