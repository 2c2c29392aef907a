"""On the card (skipped without one): a tiny cell through the CUDA
kernels is correct, and the control (the reference at TF32 in the
program's place) fails the limits at that size.  The full-size control
is `python3 -m benchmark.calibrate`."""

import pytest

from benchmark import harness, run


@pytest.mark.card
@pytest.mark.parametrize("cell", ["tlsan.train.tiny", "atrank.train.tiny",
                                  "tlsan.serve.tiny", "atrank.serve.tiny"])
def test_tiny_cell_on_the_card(card, tiny_root, cell):
    line = run.run_cell(harness.find_cell(cell, tiny_root), 17, 0.5, False, card)
    assert line["correct"], line["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["tlsan.train.tiny", "atrank.train.tiny",
                                  "tlsan.serve.tiny", "atrank.serve.tiny"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(card, tiny_root, cell, seed):
    c = harness.find_cell(cell, tiny_root)
    kind = harness.load_module(tiny_root / "benchmark" / "kinds" / f"{c.traffic['kind']}.py")
    ctx = harness.Context(cell=c, seed=seed, seconds=0.0, trace=False, device=card, t0=0.0)
    correct, table = harness.judge(kind.control(ctx), c.limits)
    assert not correct, table
