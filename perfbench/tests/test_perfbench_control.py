"""The control of the training cell comes out not correct: the plain
reference in float8 (e4m3, one scale a tensor; e5m2 gradients) put in
the program's place.  On the CPU at a tiny size; at the cell's own size
on the card (marked ``gpu``: ``python -m pytest -m gpu perfbench/tests``
on the machine with the card)."""

import pytest

from perfbench import control
from perfbench.lib import checks, manifest
from perfbench.tests import tiny


def test_training_control_fails_on_the_cpu():
    r = control.train_readings(tiny.train_cell(), 3, "cpu")
    assert not checks.judge(r["control"], checks.limits(tiny.TRAIN))[0]
    assert not checks.judge(r["half_batch"], checks.limits(tiny.TRAIN))[0]


@pytest.mark.gpu
def test_training_control_fails_at_the_cells_size(card):
    cell = manifest.load_cell(tiny.TRAIN)
    r = control.train_readings(cell, 2 ** 31 + 5, card)
    assert not checks.judge(r["control"], checks.limits(tiny.TRAIN))[0]
