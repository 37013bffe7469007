"""The control on the card: the plain reference in float32 with its GEMMs
on TF32 (the precision below the cells' float32 with TF32 off), put in the
program's place, comes out not correct under each cell's limits, while the
program's own run on the same seed comes out correct.  At the cells' own
sizes, one output interval each (``benchmark/control.py`` reads a dozen
seeds the same way), for every cell of ``BENCHMARK.json``."""

import pytest

from benchmark import control, harness
from benchmark.tests.conftest import CELLS


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_passes(cell, card):
    run, sides = control.readings(cell, 2**31 + 7, 1.0, device=card)
    c = harness.load_cell(cell)
    assert harness.decide({"failed": 0}, harness.checks_of(c, sides["program"]))
    assert not harness.decide({"failed": 0}, harness.checks_of(c, sides["control"]))
