"""The controls of the correctness check, on the card at each cell's own
size: the plain reference in the program's place, one precision below
what the configuration states, must break a limit on every seed, and the
program must keep every limit. Three seeds a cell, in one process
(``benchmark/calibrate.py`` prints the same readings for more seeds)."""

import pytest

from benchmark.calibrate import readings
from benchmark.harness import checks
from benchmark.harness.spec import Cell, load_spec

CELLS = ["adm64-guided-search", "lsun256-search", "adm64-guided-sample"]
SEEDS = [2718281828, 3141592653, 1414213562]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_breaks_a_limit_on_the_card(name, cuda):
    limits = Cell(load_spec(), name).limits["limits"]
    for row in readings(name, SEEDS, 1.0):
        assert checks.passed(checks.verdict(row["program"], limits)), row
        assert not checks.passed(checks.verdict(row["control"], limits)), \
            row
