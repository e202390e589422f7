"""A run whose timed path is broken underneath comes out not correct: the
harness's whole run but the look for a card, at a CPU test's size, once
for each fault each cell can have."""

import pytest

from benchmark import drive, run
from benchmark.conftest import sharded_cell
from benchmark.tests import faults

SINGLE = ["dense8k-default-window", "dense8k-steepest-optimal"]


def _run(cell, fault):
    return run.run_cell(cell, 2**32 + 9, 0.3, False, "cpu", drive.Clock(), faults=fault)


@pytest.mark.parametrize("workload", SINGLE)
def test_sound_run_is_correct(workload, small):
    out = _run(small(workload), None)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("workload", SINGLE)
@pytest.mark.parametrize("fault", [faults.Unchanged, faults.Altered])
def test_single_card_fault_is_not_correct(workload, fault, small):
    out = _run(small(workload), fault())
    assert not out["correct"]


@pytest.mark.parametrize("fault", [None, faults.Unchanged, faults.Altered, faults.NoExchange])
def test_sharded_fault_is_not_correct(fault, small):
    out = _run(small(sharded_cell(), m=32, n=128), fault and fault())
    assert out["correct"] == (fault is None)
