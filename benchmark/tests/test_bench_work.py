"""work/<config>.py against counts made by hand at tiny shapes."""

import json
from pathlib import Path

import numpy as np

from benchmark import data, harness, peaks

REPO = Path(__file__).resolve().parents[2]


def _load(name):
    conf = json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())
    return harness.load_module(REPO / "benchmark" / "work" / f"{name}.py"), data.sized(conf)


def test_tlsan_kernels_by_hand():
    work, conf = _load("tlsan-electronics")
    # D = 64, dh = 8, Ls = 10, S = Ts + 1 = 17; two rows
    calls = work.unit_kernels({"sl": np.array([3, 12]), "sl_new": np.array([0, 30])}, conf, True)
    (b_long, o_long), (b_short, o_short) = calls["fwa_fwd"]
    assert o_long == (3 + 10) * 64 * (4 * 8 + 9)          # valid 3 and 10 of 10
    assert o_short == (1 + 17) * 64 * (4 * 8 + 9)         # valid 1 and 17 of 17
    assert b_long == 4 * ((3 + 10) * 64 + 2 + 2 * 64 + 2 * 8 + 2 * 64)
    (bb, ob), _ = calls["fwa_bwd"]
    assert ob == 13 * 64 * (12 * 8 + 18)
    assert bb == 4 * (2 * 13 * 64 + 2 * 64 + 2 + 2 * (2 * 64 + 2 * 8))
    assert "fwa_bwd" not in work.unit_kernels({"sl": [1], "sl_new": [1]}, conf, False)


def test_atrank_kernels_by_hand():
    work, conf = _load("atrank-electronics")
    calls = work.unit_kernels({"sl": np.array([2, 5])}, conf, True)
    (b_self, o_self), (b_read, o_read) = calls["mha_fwd"]
    D = 64
    assert o_self == 2 * ((2 + 4) * D * D + 2 * 2 * 2 * D) + 2 * ((5 + 10) * D * D + 2 * 5 * 5 * D)
    assert o_read == 2 * ((1 + 4) * D * D + 2 * 1 * 2 * D) + 2 * ((1 + 10) * D * D + 2 * 1 * 5 * D)
    assert b_self == 4 * (7 * D + 4 + 3 * D * D + 5 * D + 7 * D)
    assert b_read == 4 * (2 * D + 7 * D + 4 + 3 * D * D + 5 * D + 2 * D)
    (_, o_bwd), _ = calls["mha_bwd"]
    assert o_bwd == 3 * o_self


def test_step_counts_grow_with_valid_lengths_only():
    for name, lengths, more in (
            ("tlsan-electronics", {"sl": np.array([2]), "sl_new": np.array([1])},
             {"sl": np.array([2]), "sl_new": np.array([1])}),
            ("atrank-electronics", {"sl": np.array([4])}, {"sl": np.array([4])})):
        work, conf = _load(name)
        one = work.unit_flops(lengths, conf, True)
        assert one > 6 * work.n_params(conf)
        longer = {k: v + 1 for k, v in more.items()}
        assert work.unit_flops(longer, conf, True) > one
        serve = work.unit_flops(lengths, conf, False)
        assert serve > 2 * 64 * conf["catalog"]["items"]


def test_n_params_matches_the_reference_specs():
    for name, family in (("tlsan-electronics", "tlsan"), ("atrank-electronics", "atrank")):
        work, conf = _load(name)
        specs = harness.reference(family).param_specs(conf)
        assert work.n_params(conf) == sum(int(np.prod(s)) for _, s, _ in specs)


def test_bound_is_the_larger_time():
    p = peaks.PEAKS["NVIDIA H100 80GB HBM3"]
    assert peaks.bound_s(3.35e12, 1.0, p) == 1.0
    assert peaks.bound_s(1.0, 67e12, p) == 1.0
    assert peaks.peaks("some other card") is None
