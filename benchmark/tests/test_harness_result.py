"""The result line: the contract's keys, each compared number beside its
limit under the last key, the end-to-end metrics with --trace 0 and the
per-layer ones with --trace 1."""

import json

import pytest

from benchmark import drive, run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", ["dense8k-default-window", "dense8k-steepest-optimal"])
def test_result_keys(workload, trace, small):
    cell = small(workload)
    out = json.loads(json.dumps(run.run_cell(cell, 2**31 + 3, 0.2, trace, "cpu", drive.Clock())))
    keys = list(out)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert set(keys) <= set(KEYS) | {"breakdown", "checks"}
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, spec in cell.limits.items():
        assert out["checks"][name]["limit"] == spec["limit"]
    e2e = {m["name"] for m in cell.end_to_end if cell.reports(m)}
    if trace:
        assert not set(out["metrics"]) & e2e and out["metrics"]
        assert {"busy_s", "window_s"} <= set(out["device"]) and out["device"]["busy_s"] > 0
        for part in ("device_ops", "idle_gaps"):
            assert len(out["breakdown"][part]) <= 10
    else:
        assert set(out["metrics"]) == e2e and "breakdown" not in out
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
