"""The control (the reference put in the program's place in bfloat16) comes
out not correct under each single-card cell's limits, at a size a CPU run
holds; the program, judged the same way, is correct. The card runs the same
at the cells' own sizes: test_harness_card.py."""

import pytest

from benchmark import check, drive, run


@pytest.mark.parametrize("workload", ["dense8k-default-window", "dense8k-steepest-optimal"])
def test_control_fails_a_limit(workload, small):
    cell = small(workload, m=512, n=1024, block=256, chunk=32, restart_after=256, sample_chunks=4)
    out = run.run_cell(cell, 2**31 + 77, 0.5, False, "cpu", drive.Clock(), also_control=True)
    assert out["correct"]
    rows = check.compare(out["control"], cell.limits)
    assert not all(ok for _, _, _, ok in rows), rows
