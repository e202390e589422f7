"""Host spans of the port's solve loop (``simplex_tpu_torch.spans``) on the
CPU, backend "torch", tiny LPs: nothing is recorded while the profiler is
off, one ``pivot`` span a pivot step with every child inside its parent,
one ``read`` span a counted host read, no span in the profiler's records,
the profiler's records on the spans' clock, and the idle-gap table on
synthetic records."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from simplex_tpu_torch import SimplexOptions, solve, spans
from simplex_tpu_torch.core import solver, step
from simplex_tpu_torch.oracle.generator import random_dense_lp

SPAN_NAMES = {"solve_state", "pivot", "price", "ftran", "tail", "update", "weights", "read", "maintain",
              "verify", "polish"}

# each path of the step and the loop: shadow and segments (branch reads),
# multiple pricing with deferred updates, the weighted rules, the upkeep,
# the bounded rule
OPTION_SETS = {
    "default": (dict(), False),
    "shadow, segments": (dict(pricing_dtype="bfloat16", partial_pricing=2, partial_min_segment=4), False),
    "multi-price, defer": (dict(pricing_dtype="bfloat16", multi_price=4, update_defer=4), False),
    "devex": (dict(pricing="devex"), False),
    "steepest, defer": (dict(pricing="steepest", update_defer=4), False),
    "upkeep": (dict(refactor_every=3, recompute_every=2, perturb_after=1), False),
    "bounded": (dict(), True),
}


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """A recorder of this test's own: other tests of the process may have
    left a session."""
    monkeypatch.setattr(spans, "_rec", spans._Recorder())


@pytest.fixture
def counted(monkeypatch):
    """The pivot steps the solve loop takes, counted by wrapping the module
    global it calls."""
    calls = [0]
    inner = solver.pivot_step

    def wrapped(*a, **k):
        calls[0] += 1
        return inner(*a, **k)

    monkeypatch.setattr(solver, "pivot_step", wrapped)
    return calls


def _solve(name, seed=3):
    kw, bounded = OPTION_SETS[name]
    A, b, c = random_dense_lp(24, 64, seed=seed)
    u = [4.0] * 64 if bounded else None
    return solve(A, b, c, u=u, device="cpu", options=SimplexOptions(backend="torch", **kw))


def _profiled(name):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _solve(name)
    return res, prof


def test_nothing_is_recorded_while_off():
    res = _solve("default")
    assert res.iters > 0
    assert spans.latest() == []


@pytest.mark.parametrize("name", OPTION_SETS)
def test_one_pivot_span_a_step_and_children_inside_parents(name, counted):
    res, _ = _profiled(name)
    recs = spans.latest()
    assert res.iters > 0 and recs
    assert sum(r.name == "pivot" for r in recs) == counted[0]
    assert sum(r.name == "solve_state" for r in recs) == 1
    assert {r.name for r in recs} <= SPAN_NAMES
    for r in recs:
        assert r.start_ns <= r.end_ns, r
        if r.parent >= 0:
            up = recs[r.parent]
            assert up.start_ns <= r.start_ns and r.end_ns <= up.end_ns, (r, up)
            assert r.solve == up.solve
            assert r.pivot == up.pivot or up.name != "pivot" and r.name == "pivot", (r, up)
    pivots = [r.pivot for r in recs if r.name == "pivot"]
    assert pivots == sorted(pivots) and pivots[0] == 0 and pivots[-1] <= res.iters
    assert {r.name for r in recs if r.parent >= 0 and recs[r.parent].name == "pivot"} >= {"price", "ftran", "read"}


@pytest.mark.parametrize("name", OPTION_SETS)
def test_read_spans_match_host_reads(name):
    step.reset_host_reads()
    _profiled(name)
    reads = [r for r in spans.latest() if r.name == "read"]
    assert len(reads) == sum(step.host_reads.values())
    for kind in ("control", "branch"):
        assert sum(r.kind == kind for r in reads) == step.host_reads[kind]
    if name == "shadow, segments":
        assert step.host_reads["branch"] > 0


def test_no_profiler_record_carries_a_span_name():
    _, prof = _profiled("upkeep")
    recorded = {r.name for r in spans.latest()}
    assert recorded >= {"solve_state", "pivot", "read", "maintain", "polish"}
    for e in prof.events():
        assert e.name not in SPAN_NAMES and not e.name.startswith("launch:"), e.name


def test_profiler_records_lie_inside_their_span_on_the_same_clock():
    """Every ftran span holds the profiler's record of its ``torch.mv``,
    once the trace's start is added to the record's offsets."""
    _, prof = _profiled("default")
    ops = [op for op in spans.device_ops(prof) if op[0] == "aten::mv"]
    ftran = [r for r in spans.latest() if r.name == "ftran"]
    assert ftran and len(ops) >= len(ftran)
    for r in ftran:
        assert any(r.start_ns <= s and e <= r.end_ns for _, s, e in ops), r


def test_recording_without_the_profiler_replaces_the_session():
    with spans.recording():
        _solve("default")
    first = spans.latest()
    assert first and not torch.autograd.profiler._is_profiler_enabled
    _solve("default")  # off: the session stays until another starts
    assert spans.latest() == first
    with spans.recording():
        with spans.recording():
            _solve("default", seed=4)
        _solve("default", seed=5)
    recs = spans.latest()
    assert [r.solve for r in recs if r.name == "solve_state"] == [1, 2]
    assert recs[0].start_ns > first[-1].end_ns


def test_a_token_of_a_replaced_session_closes_nothing():
    with spans.recording():
        old = spans.start("verify")
    with spans.recording():
        new = spans.start("price")
        spans.stop(old)
        assert spans.latest()[0].end_ns == -1
        spans.stop(new)
    assert [(r.name, r.end_ns >= r.start_ns) for r in spans.latest()] == [("price", True)]


def test_a_full_buffer_drops_later_records(monkeypatch):
    monkeypatch.setattr(spans, "MAX_RECORDS", 10)
    with spans.recording():
        res = _solve("default")
    recs = spans.latest()
    assert res.iters > 0 and len(recs) == 10
    assert all(r.end_ns >= r.start_ns for r in recs)


def test_gaps_on_synthetic_records():
    S = spans.Span
    recs = [
        S("pivot", 10, 90, -1, 0, 0), S("price", 12, 40, 0, 0, 0),
        S("launch:pricing_scan", 30, 30, 1, 0, 0), S("tail", 40, 60, 0, 0, 0),
        S("read", 70, 85, 0, 0, 0, "control"), S("pivot", 95, 150, -1, 0, 1), S("price", 96, 140, 5, 0, 1),
    ]
    ops = [("k1", 0, 20), ("k2", 32, 50), ("k3", 50, 80), ("k4", 100, 120), ("k5", 110, 130),
           ("k6", 200, 210), ("k2", 215, 220), ("k7", 225, 230), ("k7", 240, 250)]
    got = spans.gaps(ops, recs)
    want = [
        ("k6", "price", "-", 1, 70e-9),
        ("k4", "read:control", "price", 1, 20e-9),
        ("k7", "-", "-", 2, 15e-9),
        ("k2", "price", "price", 1, 12e-9),
        ("k2", "-", "-", 1, 5e-9),
    ]
    assert [g[:4] for g in got] == [w[:4] for w in want]
    assert [g.seconds for g in got] == pytest.approx([w[4] for w in want], rel=1e-12)


def test_gaps_of_a_profile_name_the_open_spans():
    _, prof = _profiled("default")
    rows = spans.gaps(prof)
    assert rows and all(r.count > 0 and r.seconds > 0 for r in rows)
    labels = {r.began for r in rows} | {r.ended for r in rows}
    assert "read:control" in labels and labels <= {s for s in SPAN_NAMES} | {"read:control", "-"}
