"""Import the reference's TF checkpoints into the port (migration), and
the maps back (EXPORT, tools/tf_export.py).

Ported from tlsan_tpu/tools/tf_import.py.  A user moving from the
reference (TsingZ0/TLSAN) loads any trained ``tf.train.Saver`` checkpoint
written by the reference's per-model ``model.py`` ``save()``
(TLSAN/model.py:302-313): every trainable TF variable is mapped onto the
matching parameter of the port's model (the JAX package's tree names,
tools/params.py) and the result is written as a port checkpoint
(train/checkpoint.py: ``torch.save`` + JSON sidecar) that the Trainer
(``--resume``), the Evaluator and the serving stack load as they are.

The maps are numpy code, the JAX tool's own: the variable names of each
reference graph, the conv1d kernels' squeeze and gamma's reshape.
TensorFlow is imported only inside `read_tf_checkpoint` and
`write_tf_checkpoint`, and only this module and tf_export.py call them;
the rest of the port never imports TF (the card's machine has none, so the
tools run where TF is installed).

The import is strict both ways: every trainable variable in the
checkpoint must be consumed and every parameter of the family's model
filled with the exact shape (`validate_tree`, against the port model's
``state_dict``), or the import fails.  The reference's step counter
(``global_step``) carries over as the checkpoint step; optimizer slot
variables (Adam moments etc.) are skipped with a notice, and the written
checkpoint carries a fresh state of ``--optimizer``.

Usage:
  python -m tlsan_tpu_torch.tools.tf_import --model shan \
      --ckpt save_path/shan-71160 --out save_shan_imported \
      [--dataset Beauty --data_dir Data --eval --device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, Tuple

import numpy as np
import torch

# non-trainable counters the reference Saver also writes
_COUNTERS = ("global_step", "global_epoch_step")
# optimizer slot-variable markers (reference init_optimizer supports
# sgd/adam/adadelta/rmsprop — TLSAN/model.py:185-205)
_SLOT_MARKERS = ("/Adam", "/Adadelta", "/RMSProp", "/Momentum",
                 "beta1_power", "beta2_power")


def read_tf_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], int]:
    """Read every variable of a TF checkpoint into host numpy arrays.

    Returns (name → array for model variables, global_step).  Optimizer
    slot variables are dropped with a notice.
    """
    try:
        from tensorflow.python.training import py_checkpoint_reader
        reader = py_checkpoint_reader.NewCheckpointReader(path)
    except ImportError:
        try:
            import tensorflow as tf
            reader = tf.train.load_checkpoint(path)
        except ImportError:
            raise SystemExit(
                "a TensorFlow wheel is required to READ the reference "
                "checkpoint (a pure file reader; the rest of the port never "
                "imports TF)")
    out, step = {}, 0
    for name in reader.get_variable_to_shape_map():
        if name in _COUNTERS:
            if name == "global_step":
                step = int(reader.get_tensor(name))
            continue
        if any(m in name for m in _SLOT_MARKERS):
            print(f"[tf_import] skipping optimizer slot variable {name}",
                  file=sys.stderr)
            continue
        out[name] = np.asarray(reader.get_tensor(name))
    return out, step


class _Vars:
    """Strict accessor over the checkpoint variables: tracks consumption."""

    def __init__(self, tf_vars: Dict[str, np.ndarray]):
        self._v = tf_vars
        self.used = set()

    def __call__(self, name: str) -> np.ndarray:
        if name not in self._v:
            raise KeyError(f"checkpoint is missing variable {name!r} "
                           f"(has: {sorted(self._v)[:8]}...)")
        self.used.add(name)
        return self._v[name]

    def has(self, name: str) -> bool:
        return name in self._v

    def unused(self):
        return sorted(set(self._v) - self.used)


# ---------------------------------------------------------------------------
# Per-family variable-name maps (reference model.py get_variable names).
# Each converter returns (param_tree, cfg_hints) where cfg_hints carries
# the shape-derived ModelConfig fields needed to rebuild the model.
# ---------------------------------------------------------------------------

def _fwa(g, scope):
    """Feature-wise attention block (TLSAN/model.py:370-394; the two
    bn_dense_layer maps at :380-383)."""
    return {"w1": g(f"{scope}/bn_dense_map1/linear_map/W"),
            "b1": g(f"{scope}/bn_dense_map1/linear_map/bias"),
            "w2": g(f"{scope}/bn_dense_map2/linear_map/W"),
            "b2": g(f"{scope}/bn_dense_map2/linear_map/bias")}


def _import_tlsan(g):
    # TLSAN/model.py:58-77 (tables, gamma), :330-364 (long/short towers)
    p = {"gamma": g("gamma_parameter").reshape(()),
         "item_emb": g("item_emb"), "item_b": g("item_b"),
         "user_emb": g("user_emb"), "usert_emb": g("usert_emb"),
         "cate_emb": g("cate_emb"), "long": [], "short": []}
    b = 0
    while g.has(f"all/long_term/num_blocks0_{b}/long_term_layer/"
                f"feature_wise_attention1/bn_dense_map1/linear_map/W"):
        s = f"all/long_term/num_blocks0_{b}"
        blk = _fwa(g, f"{s}/long_term_layer/feature_wise_attention1")
        blk["proj_w"] = g(f"{s}/dense/kernel")
        blk["proj_b"] = g(f"{s}/dense/bias")
        p["long"].append(blk)
        s = f"all/short_term/num_blocks1_{b}"
        p["short"].append(
            _fwa(g, f"{s}/short_term_layer/feature_wise_attention2"))
        b += 1
    hints = dict(user_count=p["user_emb"].shape[0],
                 item_count=p["item_emb"].shape[0],
                 cate_count=p["cate_emb"].shape[0],
                 itemid_embedding_size=p["item_emb"].shape[1],
                 userid_embedding_size=p["user_emb"].shape[1],
                 cateid_embedding_size=p["cate_emb"].shape[1],
                 Ls=p["usert_emb"].shape[1], num_blocks=b)
    return p, hints


def _import_atrank(g):
    # ATRank/model.py:334-459 (multihead_attention dense/dense_1/dense_2 =
    # Q/K/V, ln/Variable(_1) = LayerNorm beta/gamma, feedforward conv1d
    # kernels [1, D, F] squeezed to [D, F])
    def attn(scope):
        return {"wq": g(f"{scope}/dense/kernel"),
                "bq": g(f"{scope}/dense/bias"),
                "wk": g(f"{scope}/dense_1/kernel"),
                "bk": g(f"{scope}/dense_1/bias"),
                "wv": g(f"{scope}/dense_2/kernel"),
                "bv": g(f"{scope}/dense_2/bias"),
                "ln_beta": g(f"{scope}/ln/Variable"),
                "ln_gamma": g(f"{scope}/ln/Variable_1")}

    def ffn(scope):
        return {"w1": g(f"{scope}/conv1d/kernel")[0],
                "b1": g(f"{scope}/conv1d/bias"),
                "w2": g(f"{scope}/conv1d_1/kernel")[0],
                "b2": g(f"{scope}/conv1d_1/bias"),
                "ln_beta": g(f"{scope}/ln/Variable"),
                "ln_gamma": g(f"{scope}/ln/Variable_1")}

    p = {"item_emb": g("item_emb_w"), "item_b": g("item_b"),
         "cate_emb": g("cate_emb_w"),
         "time_w": g("dense/kernel"), "time_b": g("dense/bias"),
         "self_blocks": [], "vanilla_blocks": []}
    b = 0
    while g.has(f"all/user_hist_group/num_blocks_{b}/self_attention/"
                f"dense/kernel"):
        s = f"all/user_hist_group/num_blocks_{b}"
        p["self_blocks"].append({"attn": attn(f"{s}/self_attention"),
                                 "ffn": ffn(f"{s}/feed_forward")})
        s = f"all/item_feature_group/num_blocks_{b}"
        p["vanilla_blocks"].append({"attn": attn(f"{s}/vanilla_attention"),
                                    "ffn": ffn(f"{s}/feed_forward")})
        b += 1
    hints = dict(item_count=p["item_emb"].shape[0],
                 cate_count=p["cate_emb"].shape[0], num_blocks=b,
                 itemid_embedding_size=p["item_emb"].shape[1],
                 cateid_embedding_size=p["cate_emb"].shape[1],
                 hidden_units=p["time_b"].shape[0])
    return p, hints


def _import_shan(g):
    # SHAN/model.py:52-77 — 1:1 names
    p = {name: g(name) for name in
         ("item_emb", "item_b", "user_emb",
          "layer1_w", "layer1_b", "layer2_w", "layer2_b")}
    hints = dict(user_count=p["user_emb"].shape[0],
                 item_count=p["item_emb"].shape[0],
                 itemid_embedding_size=p["item_emb"].shape[1],
                 userid_embedding_size=p["user_emb"].shape[1])
    return p, hints


def _import_bpr(g):
    # BPR/model.py:11-14
    p = {"user_emb": g("user_emb_w"), "item_emb": g("item_emb_w"),
         "item_b": g("item_b"), "cate_emb": g("cate_emb_w")}
    hints = dict(user_count=p["user_emb"].shape[0],
                 item_count=p["item_emb"].shape[0],
                 cate_count=p["cate_emb"].shape[0],
                 itemid_embedding_size=p["item_emb"].shape[1],
                 cateid_embedding_size=p["cate_emb"].shape[1],
                 bpr_user_embedding_size=p["user_emb"].shape[1])
    return p, hints


def _import_lspm(g):
    # LSPM/model.py:23-33
    p = {"item_emb": g("item_emb_w"), "long_w": g("long_w"),
         "short_w": g("short_w")}
    hints = dict(user_count=p["long_w"].shape[0],
                 item_count=p["item_emb"].shape[0],
                 itemid_embedding_size=p["item_emb"].shape[1])
    return p, hints


def _import_paca(g):
    # PACA/model.py:41-48
    p = {"item_emb": g("item_emb_w"), "position_w": g("weights_position"),
         "linear_w": g("weights_bilinear")}
    hints = dict(item_count=p["item_emb"].shape[0],
                 itemid_embedding_size=p["item_emb"].shape[1],
                 paca_kernel_size=p["position_w"].shape[0],
                 paca_max_len=p["position_w"].shape[1])
    return p, hints


def _import_cnn(g):
    # CNN/model.py:58-91 (dense = time projection, dense_1 = output head)
    # + :306-325 conv towers conv-maxpool-<h>/{W,b}, filter heights 1..10
    p = {"item_emb": g("item_emb_w"), "item_b": g("item_b"),
         "cate_emb": g("cate_emb_w"),
         "time_w": g("dense/kernel"), "time_b": g("dense/bias"),
         "out_w": g("dense_1/kernel"), "out_b": g("dense_1/bias"),
         "towers": []}
    h = 1
    while g.has(f"conv-maxpool-{h}/W"):
        p["towers"].append({"w": g(f"conv-maxpool-{h}/W"),
                            "b": g(f"conv-maxpool-{h}/b")})
        h += 1
    hints = dict(item_count=p["item_emb"].shape[0],
                 cate_count=p["cate_emb"].shape[0],
                 itemid_embedding_size=p["item_emb"].shape[1],
                 cateid_embedding_size=p["cate_emb"].shape[1],
                 hidden_units=p["time_b"].shape[0],
                 cnn_filter_sizes=tuple(range(1, h)))
    return p, hints


def _import_bilstm(g):
    # Bi-LSTM/model.py:60-70 — the stock tf.nn.rnn_cell LSTM kernels keep
    # their (i, j, f, o) gate layout (nn/layers.py lstm_scan matches)
    rnn = "bidirectional_rnn/{d}/multi_rnn_cell/cell_0/lstm_cell/{v}"
    p = {"item_emb": g("item_emb_w"), "item_b": g("item_b"),
         "cate_emb": g("cate_emb_w"), "user_emb": g("user_emb_w"),
         "lstm_fw_w": g(rnn.format(d="fw", v="kernel")),
         "lstm_fw_b": g(rnn.format(d="fw", v="bias")),
         "lstm_bw_w": g(rnn.format(d="bw", v="kernel")),
         "lstm_bw_b": g(rnn.format(d="bw", v="bias")),
         "out_w": g("dense/kernel"), "out_b": g("dense/bias")}
    hints = dict(user_count=p["user_emb"].shape[0],
                 item_count=p["item_emb"].shape[0],
                 cate_count=p["cate_emb"].shape[0],
                 itemid_embedding_size=p["item_emb"].shape[1],
                 cateid_embedding_size=p["cate_emb"].shape[1],
                 lstm_hidden_units=p["user_emb"].shape[1])
    return p, hints


def _import_csan(g):
    # CSAN/model.py:351-442 — DiSAN block scopes
    def disan(scope):
        return {"map_w": g(f"{scope}/bn_dense_map/linear_map/W"),
                "map_b": g(f"{scope}/bn_dense_map/linear_map/bias"),
                "dep_w": g(f"{scope}/disan_attention/linear_dependent/W"),
                "head_w": g(f"{scope}/disan_attention/linear_head/W"),
                "f_bias": g(f"{scope}/disan_attention/f_bias"),
                "fus_a_w": g(f"{scope}/disan_output/linear_fusion_a/W"),
                "fus_a_b": g(f"{scope}/disan_output/linear_fusion_a/bias"),
                "fus_i_w": g(f"{scope}/disan_output/linear_fusion_i/W"),
                "fus_i_b": g(f"{scope}/disan_output/linear_fusion_i/bias"),
                "o_bias": g(f"{scope}/disan_output/o_bias")}

    p = {"item_emb": g("item_emb"), "item_b": g("item_b"), "blocks": []}
    b = 0
    while g.has(f"all/feature_wise_self_attention/num_blocks0_{b}/"
                f"dense/kernel"):
        s = f"all/feature_wise_self_attention/num_blocks0_{b}"
        fwsa = f"{s}/feature_wise_self_attention/feature_wise_self_attention"
        p["blocks"].append({
            "fw": disan(f"{s}/fwbw_attention/dir_attn_fw"),
            "bw": disan(f"{s}/fwbw_attention/dir_attn_bw"),
            "fwsa": {"w1": g(f"{fwsa}/bn_dense_map1/linear_map/W"),
                     "b1": g(f"{fwsa}/bn_dense_map1/linear_map/bias"),
                     "w2": g(f"{fwsa}/bn_dense_map2/linear_map/W"),
                     "b2": g(f"{fwsa}/bn_dense_map2/linear_map/bias")},
            "proj_w": g(f"{s}/dense/kernel"),
            "proj_b": g(f"{s}/dense/bias")})
        b += 1
    # CSAN's widths are all multiples of the item embedding size
    # (models/csan.py init_params), NOT hidden_units
    hints = dict(item_count=p["item_emb"].shape[0], num_blocks=b,
                 itemid_embedding_size=p["item_emb"].shape[1])
    return p, hints


_CONVERTERS = {"tlsan": _import_tlsan, "atrank": _import_atrank,
               "shan": _import_shan, "bpr": _import_bpr,
               "lspm": _import_lspm, "paca": _import_paca,
               "cnn": _import_cnn, "bilstm": _import_bilstm,
               "csan": _import_csan}


# ---------------------------------------------------------------------------
# Inverse maps (EXPORT): param tree → reference-named TF variables, undoing
# the import-side transformations (conv1d kernel squeeze, gamma reshape).
# Round-trip identity per family is tested in tests/test_torch_tf_import.py.
# ---------------------------------------------------------------------------

def _export_fwa(blk, scope):
    return {f"{scope}/bn_dense_map1/linear_map/W": blk["w1"],
            f"{scope}/bn_dense_map1/linear_map/bias": blk["b1"],
            f"{scope}/bn_dense_map2/linear_map/W": blk["w2"],
            f"{scope}/bn_dense_map2/linear_map/bias": blk["b2"]}


def _export_tlsan(p):
    out = {"gamma_parameter": np.reshape(p["gamma"], ()),  # [] get_variable
           "item_emb": p["item_emb"], "item_b": p["item_b"],
           "user_emb": p["user_emb"], "usert_emb": p["usert_emb"],
           "cate_emb": p["cate_emb"]}
    for b, blk in enumerate(p["long"]):
        s = f"all/long_term/num_blocks0_{b}"
        out.update(_export_fwa(
            blk, f"{s}/long_term_layer/feature_wise_attention1"))
        out[f"{s}/dense/kernel"] = blk["proj_w"]
        out[f"{s}/dense/bias"] = blk["proj_b"]
    for b, blk in enumerate(p["short"]):
        s = f"all/short_term/num_blocks1_{b}"
        out.update(_export_fwa(
            blk, f"{s}/short_term_layer/feature_wise_attention2"))
    return out


def _export_atrank(p):
    def attn(scope, a):
        return {f"{scope}/dense/kernel": a["wq"],
                f"{scope}/dense/bias": a["bq"],
                f"{scope}/dense_1/kernel": a["wk"],
                f"{scope}/dense_1/bias": a["bk"],
                f"{scope}/dense_2/kernel": a["wv"],
                f"{scope}/dense_2/bias": a["bv"],
                f"{scope}/ln/Variable": a["ln_beta"],
                f"{scope}/ln/Variable_1": a["ln_gamma"]}

    def ffn(scope, f):
        return {f"{scope}/conv1d/kernel": np.asarray(f["w1"])[None],
                f"{scope}/conv1d/bias": f["b1"],
                f"{scope}/conv1d_1/kernel": np.asarray(f["w2"])[None],
                f"{scope}/conv1d_1/bias": f["b2"],
                f"{scope}/ln/Variable": f["ln_beta"],
                f"{scope}/ln/Variable_1": f["ln_gamma"]}

    out = {"item_emb_w": p["item_emb"], "item_b": p["item_b"],
           "cate_emb_w": p["cate_emb"],
           "dense/kernel": p["time_w"], "dense/bias": p["time_b"]}
    for b, blk in enumerate(p["self_blocks"]):
        s = f"all/user_hist_group/num_blocks_{b}"
        out.update(attn(f"{s}/self_attention", blk["attn"]))
        out.update(ffn(f"{s}/feed_forward", blk["ffn"]))
    for b, blk in enumerate(p["vanilla_blocks"]):
        s = f"all/item_feature_group/num_blocks_{b}"
        out.update(attn(f"{s}/vanilla_attention", blk["attn"]))
        out.update(ffn(f"{s}/feed_forward", blk["ffn"]))
    return out


def _export_shan(p):
    return dict(p)  # 1:1 names (SHAN/model.py:52-77)


def _export_bpr(p):
    return {"user_emb_w": p["user_emb"], "item_emb_w": p["item_emb"],
            "item_b": p["item_b"], "cate_emb_w": p["cate_emb"]}


def _export_lspm(p):
    return {"item_emb_w": p["item_emb"], "long_w": p["long_w"],
            "short_w": p["short_w"]}


def _export_paca(p):
    return {"item_emb_w": p["item_emb"],
            "weights_position": p["position_w"],
            "weights_bilinear": p["linear_w"]}


def _export_cnn(p):
    out = {"item_emb_w": p["item_emb"], "item_b": p["item_b"],
           "cate_emb_w": p["cate_emb"],
           "dense/kernel": p["time_w"], "dense/bias": p["time_b"],
           "dense_1/kernel": p["out_w"], "dense_1/bias": p["out_b"]}
    for h, tower in enumerate(p["towers"], start=1):
        out[f"conv-maxpool-{h}/W"] = tower["w"]
        out[f"conv-maxpool-{h}/b"] = tower["b"]
    return out


def _export_bilstm(p):
    rnn = "bidirectional_rnn/{d}/multi_rnn_cell/cell_0/lstm_cell/{v}"
    return {"item_emb_w": p["item_emb"], "item_b": p["item_b"],
            "cate_emb_w": p["cate_emb"], "user_emb_w": p["user_emb"],
            rnn.format(d="fw", v="kernel"): p["lstm_fw_w"],
            rnn.format(d="fw", v="bias"): p["lstm_fw_b"],
            rnn.format(d="bw", v="kernel"): p["lstm_bw_w"],
            rnn.format(d="bw", v="bias"): p["lstm_bw_b"],
            "dense/kernel": p["out_w"], "dense/bias": p["out_b"]}


def _export_csan(p):
    def disan(scope, d):
        return {f"{scope}/bn_dense_map/linear_map/W": d["map_w"],
                f"{scope}/bn_dense_map/linear_map/bias": d["map_b"],
                f"{scope}/disan_attention/linear_dependent/W": d["dep_w"],
                f"{scope}/disan_attention/linear_head/W": d["head_w"],
                f"{scope}/disan_attention/f_bias": d["f_bias"],
                f"{scope}/disan_output/linear_fusion_a/W": d["fus_a_w"],
                f"{scope}/disan_output/linear_fusion_a/bias": d["fus_a_b"],
                f"{scope}/disan_output/linear_fusion_i/W": d["fus_i_w"],
                f"{scope}/disan_output/linear_fusion_i/bias": d["fus_i_b"],
                f"{scope}/disan_output/o_bias": d["o_bias"]}

    out = {"item_emb": p["item_emb"], "item_b": p["item_b"]}
    for b, blk in enumerate(p["blocks"]):
        s = f"all/feature_wise_self_attention/num_blocks0_{b}"
        fwsa = f"{s}/feature_wise_self_attention/feature_wise_self_attention"
        out.update(disan(f"{s}/fwbw_attention/dir_attn_fw", blk["fw"]))
        out.update(disan(f"{s}/fwbw_attention/dir_attn_bw", blk["bw"]))
        out.update({f"{fwsa}/bn_dense_map1/linear_map/W": blk["fwsa"]["w1"],
                    f"{fwsa}/bn_dense_map1/linear_map/bias": blk["fwsa"]["b1"],
                    f"{fwsa}/bn_dense_map2/linear_map/W": blk["fwsa"]["w2"],
                    f"{fwsa}/bn_dense_map2/linear_map/bias": blk["fwsa"]["b2"]})
        out[f"{s}/dense/kernel"] = blk["proj_w"]
        out[f"{s}/dense/bias"] = blk["proj_b"]
    return out


_EXPORTERS = {"tlsan": _export_tlsan, "atrank": _export_atrank,
              "shan": _export_shan, "bpr": _export_bpr,
              "lspm": _export_lspm, "paca": _export_paca,
              "cnn": _export_cnn, "bilstm": _export_bilstm,
              "csan": _export_csan}


def to_tf_vars(model_name: str, params) -> Dict[str, np.ndarray]:
    """Inverse of to_params: param tree → reference-named variable dict."""
    if model_name not in _EXPORTERS:
        raise KeyError(f"unknown model {model_name!r}; "
                       f"one of {sorted(_EXPORTERS)}")
    out = _EXPORTERS[model_name](params)
    return {name: np.asarray(val, dtype=np.float32)
            for name, val in out.items()}


def write_tf_checkpoint(prefix: str, tf_vars: Dict[str, np.ndarray],
                        step: int = 0, epoch: int = 0) -> str:
    """Write the named variables as a ``tf.train.Saver`` checkpoint the
    reference's ``model.restore()`` loads directly (TLSAN/model.py:309-313;
    the Saver restores by variable name, so the extra counters are ignored
    by families without them, e.g. BPR).  Needs a TF wheel."""
    import tensorflow.compat.v1 as tf1
    graph = tf1.Graph()
    with graph.as_default():
        for name, val in tf_vars.items():
            tf1.Variable(initial_value=val, name=name)
        tf1.Variable(np.int32(step), name="global_step", trainable=False)
        tf1.Variable(np.int32(epoch), name="global_epoch_step",
                     trainable=False)
        saver = tf1.train.Saver()
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            return saver.save(sess, prefix, global_step=step)


def to_params(model_name: str, tf_vars: Dict[str, np.ndarray]):
    """Map checkpoint variables → (param tree, shape-derived cfg hints).

    Strict: unconsumed trainable variables are an error."""
    if model_name not in _CONVERTERS:
        raise KeyError(f"unknown model {model_name!r}; "
                       f"one of {sorted(_CONVERTERS)}")
    g = _Vars(tf_vars)
    params, hints = _CONVERTERS[model_name](g)
    leftover = g.unused()
    if leftover:
        raise SystemExit(
            f"[tf_import] {len(leftover)} checkpoint variables were NOT "
            f"consumed by the {model_name} map: {leftover} — wrong --model, "
            f"or a reference variant this map does not cover")
    return params, hints


def _model_config(model_name: str, hints, **over):
    """The ModelConfig the shape-derived `hints` give (the counts at 1 when
    the family's tree does not carry them), with `over` on top."""
    from tlsan_tpu_torch.core.config import ModelConfig

    known = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = dict(user_count=1, cate_count=1)
    kw.update({k: v for k, v in hints.items() if k in known})
    kw.update(over)
    return ModelConfig(model=model_name, **kw)


def validate_tree(model_name: str, params, hints) -> None:
    """Check the imported tree against the port model's ``state_dict``:
    the same parameter names and shapes (catches transposed maps and
    family mix-ups)."""
    from tlsan_tpu_torch.models import get_model
    from tlsan_tpu_torch.tools.params import _flatten

    model = get_model(model_name)(_model_config(model_name, hints), "meta")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in _flatten(params).items()}
    if set(got) != set(want):
        raise SystemExit(f"[tf_import] tree structure mismatch:\n"
                         f"  imported only: {sorted(set(got) - set(want))}\n"
                         f"  expected only: {sorted(set(want) - set(got))}")
    for name in sorted(want):
        if got[name] != want[name]:
            raise SystemExit(f"[tf_import] shape mismatch at {name}: imported "
                             f"{got[name]} vs expected {want[name]}")


def main(argv=None):
    from tlsan_tpu_torch.train.cli import _device_arg

    p = argparse.ArgumentParser(
        description="import a reference TF checkpoint into the port")
    p.add_argument("--model", required=True)
    p.add_argument("--ckpt", required=True,
                   help="TF checkpoint prefix (e.g. .../save_path/shan-71160)")
    p.add_argument("--out", required=True, help="port model_dir to write")
    p.add_argument("--optimizer", default="sgd",
                   choices=["sgd", "adam", "adadelta", "rmsprop"],
                   help="optimizer whose fresh state the checkpoint carries")
    p.add_argument("--dataset", default=None,
                   help="with --eval: category name (e.g. Beauty)")
    p.add_argument("--data_dir", default="Data",
                   help="where <dataset>.npz (train/cli.py's category file) lies")
    p.add_argument("--eval", action="store_true",
                   help="evaluate pairwise AUC of the imported params on the "
                        "category's test set")
    p.add_argument("--device", type=_device_arg, default="cuda",
                   help="the evaluation's device: cuda (the default), cuda:N or cpu")
    args = p.parse_args(argv)

    tf_vars, step = read_tf_checkpoint(args.ckpt)
    params_np, hints = to_params(args.model, tf_vars)
    validate_tree(args.model, params_np, hints)
    print(f"[tf_import] {args.model}: mapped {len(tf_vars)} variables "
          f"(step {step}) from {args.ckpt}")

    from tlsan_tpu_torch.core.config import TrainConfig
    from tlsan_tpu_torch.models import get_model
    from tlsan_tpu_torch.tools.params import state_from_tree
    from tlsan_tpu_torch.train import checkpoint as ckpt
    from tlsan_tpu_torch.train.state import make_optimizer

    tc = TrainConfig(optimizer=args.optimizer, model_dir=args.out,
                     dataset=args.dataset or "")
    counts = ("user_count", "item_count", "cate_count")
    auc = None
    if args.eval or args.dataset:
        from tlsan_tpu_torch.data.remap import category_path
        from tlsan_tpu_torch.serve.recommender import resolve_device
        from tlsan_tpu_torch.train.cli import prepare
        from tlsan_tpu_torch.train.evaluate import Evaluator

        cfg = _model_config(args.model, {k: v for k, v in hints.items()
                                         if k not in counts})
        prep = prepare(args.model, category_path(args.data_dir, args.dataset), cfg)
        cfg = prep.cfg
        for k in counts:
            if k in hints and hints[k] != getattr(cfg, k):
                raise SystemExit(
                    f"[tf_import] {k} mismatch: checkpoint {hints[k]} vs "
                    f"dataset {getattr(cfg, k)} — wrong --dataset?")
        if args.eval:
            device = resolve_device(args.device)
            torch_model = get_model(args.model)(cfg, device)
            torch_model.load_state_dict(state_from_tree(params_np, torch_model))
            cate_list = torch.from_numpy(np.asarray(prep.cate_list, np.int32)).to(device)
            ev = Evaluator(cfg, cate_list, prep.test, 128, device)
            auc = ev.auc(torch_model)
            print(f"[tf_import] imported-params test AUC on "
                  f"{args.dataset}: {auc:.4f}")
    else:
        cfg = _model_config(args.model, hints)

    model = get_model(args.model)(cfg, "cpu")
    model.load_state_dict(state_from_tree(params_np, model))
    names = [n for n, _ in model.named_parameters()]
    opt_state = make_optimizer(tc).init(list(model.parameters())).to_dict(names)
    path = ckpt.save(args.out, args.model, step, model, opt_state, cfg, tc)
    print(f"[tf_import] wrote {path}")
    if auc is not None:
        print(json.dumps({"model": args.model, "dataset": args.dataset,
                          "step": step, "auc": round(float(auc), 4)}))
    return path


if __name__ == "__main__":
    main()
