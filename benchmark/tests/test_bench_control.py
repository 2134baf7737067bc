"""The control, on the card: the reference computed one precision below
the configuration's (TF32 in the float32 stages, float8 activations and
weights in the bf16 detector), put in the port's place, fails the limits
that the sound port passes.  At 160x120 and a few frames (the fixture
cells), each held to the limits of the benchmark cell with its entry.

    python -m pytest benchmark/tests/test_bench_control.py -p no:cacheprovider

The benchmark's own runs never run the control; ``benchmark/calibrate.py``
reads it at the cells' own sizes."""

from __future__ import annotations

import time

import pytest
import torch

from benchlib import cell as cell_mod
from benchlib import check, spec
from fixture_cell import load

PAIRS = [("tiny.replay", "rs720.replay"), ("tiny.live", "rs720.live"),
         ("tiny.dynamic", "tum640.dynamic"), ("tiny.fleet", "rs720.fleet8")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("fixture,real", PAIRS)
def test_control_fails_where_the_port_passes(tmp_path, card, fixture, real):
    cell = load(tmp_path, fixture)
    limits = spec.load_cell(real).limits
    cell.limits = limits
    res = cell_mod.run(cell, 3_000_000_029, 2.0, False, card, time.time(),
                       workers=2, control=True)
    assert res["correct"], res["check"]
    judged = check.judge(res["control"], limits,
                         cell.traffic["check"]["require"])
    assert not check.is_correct(judged), judged
