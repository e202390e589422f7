"""Host spans of the solve loop, on the clock of ``torch.profiler``'s records.

Where the host spends a pivot, and so why the card waits. The solve loop
opens and closes spans at its stage boundaries:

  solve_state   one ``core.solver.solve_state`` call, the root (a new solve id)
  pivot         one pass of ``core.solver._pivot_loop``: the step, its control
                read and any upkeep; its pivot id is the ``Control.iters`` the
                step started from, and the spans inside it inherit it
  price, ftran, tail, update, weights
                the sections of ``core.step.pivot_step``: pricing, the ftran,
                the ratio test and the O(m) tail, the B_inv update or flush,
                the devex / steepest-edge e / gamma update
  graph         a default step run from a CUDA graph (``core.graph``): the
                copy of its input into the graph's buffers, the capture when
                one is due (the sections above inside it), the replay; of
                kind ``ahead`` where the replay was enqueued before the
                previous step's control was read
  read          a device-to-host read that ``core.step.host_reads`` counts,
                of kind ``control`` or ``branch``
  maintain      upkeep between pivots, of kind ``perturb``, ``recompute`` or
                ``refactorize``
  verify        one verify round of ``solve_state``
  polish        ``core.solver.finalize_result``

and the hand-written kernels' wrappers (``kernels.hopper``) stamp a
zero-length ``launch:<wrapper>`` mark immediately before each library call,
as ``core.graph`` stamps ``launch:pivot_graph`` before each replay.

Spans are recorded only while a ``torch.profiler`` session is active (the
flag torch keeps for fast Python checks) or inside ``with recording():``,
which gives spans without the profiler's own cost. Otherwise each site
checks the flag and returns: no allocation, no clock read, no sync. Nothing
goes into the profiler's records (no ``record_function``, no NVTX range), so
a trace holds the same records with spans as without.

The clock is ``time.time_ns()``: Kineto stamps its records with the same
realtime clock, so a profiler record sits at
``prof.profiler.kineto_results.trace_start_ns() + 1000 * time_range.start``
on the spans' axis (:func:`device_ops`).

A session starts at the first record after recording was last found off at
a solve's root or a pivot, or at the entry of ``recording()``, and replaces
the one before. :func:`latest` returns its records, at most ``MAX_RECORDS``
(later ones are dropped); :func:`gaps` puts a finished profile's device idle
gaps beside them.

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = simplex_tpu_torch.solve(A, b, c)
    for row in spans.gaps(prof):
        print(row)
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import List, NamedTuple, Optional

import torch.autograd.profiler as _prof

MAX_RECORDS = 1 << 18
_now = time.time_ns


class Span(NamedTuple):
    """One record of a session. A launch mark ends where it starts."""

    name: str
    start_ns: int
    end_ns: int  # -1 while the span is open
    parent: int  # index of the enclosing span in the session, -1 at a root
    solve: int  # one id a solve_state call; -1 before the first
    pivot: int  # the Control.iters the step started from; -1 outside a pivot
    kind: str = ""  # a read's kind (control, branch), a maintain's, a graph's (ahead)

    @property
    def label(self) -> str:
        return f"{self.name}:{self.kind}" if self.kind else self.name


class _Recorder:
    """A session's records by column (the hot path appends plain values):
    a record's index is its position, a token its index plus ``base``."""

    __slots__ = ("names", "starts", "ends", "parents", "kinds", "solve_ids", "pivot_ids", "stack", "base",
                 "forced", "fresh", "solves")

    def __init__(self):
        self.forced = 0  # depth of recording() blocks
        self.fresh = False  # the next record starts a new session
        self.solves = -1  # the latest solve id
        self.base = 0
        self._clear()

    def _clear(self):
        self.names, self.starts, self.ends, self.parents = [], [], [], []
        self.kinds = {}  # index -> kind, where one was given
        self.solve_ids = {}  # index of a root -> its solve id
        self.pivot_ids = {}  # index of a pivot span -> its pivot id
        self.stack = []  # indices of the open spans, innermost last
        self.base += MAX_RECORDS  # tokens of a replaced session match nothing
        self.fresh = False


_rec = _Recorder()


def _open(name: str, kind: str, push: bool) -> int:
    """Append a record inside the innermost open span; its index, or -1
    when the session is full. Stamps the clock last."""
    r = _rec
    if r.fresh:
        r._clear()
    i = len(r.starts)
    if i >= MAX_RECORDS:
        return -1
    stack = r.stack
    if stack:
        r.parents.append(stack[-1])
    else:
        r.parents.append(-1)
        r.solve_ids[i] = r.solves
    r.names.append(name)
    if kind:
        r.kinds[i] = kind
    if push:
        r.ends.append(-1)
        stack.append(i)
        r.starts.append(_now())
    else:
        now = _now()
        r.starts.append(now)
        r.ends.append(now)
    return i


def start(name: str, kind: str = ""):
    """Open a span inside the innermost open one; None while recording is
    off. Close it with :func:`stop`."""
    if not (_prof._is_profiler_enabled or _rec.forced):
        return None
    i = _open(name, kind, True)  # may start a session, and so move base
    return _rec.base + i


def start_solve():
    """Open a ``solve_state`` root with a new solve id. While recording is
    off, end the session: the next record starts another."""
    if not (_prof._is_profiler_enabled or _rec.forced):
        _rec.fresh = True
        return None
    _rec.solves += 1
    i = _open("solve_state", "", True)
    return _rec.base + i


def start_pivot(iters: int):
    """Open a ``pivot`` span with pivot id ``iters``. While recording is off,
    end the session, as :func:`start_solve`."""
    if not (_prof._is_profiler_enabled or _rec.forced):
        _rec.fresh = True
        return None
    i = _open("pivot", "", True)
    _rec.pivot_ids[i] = iters
    return _rec.base + i


def stop(span) -> None:
    """Close ``span`` (what a start function returned; None does nothing)
    and whatever an exception left open inside it."""
    if span is None:
        return
    now = _now()
    r = _rec
    i = span - r.base
    stack = r.stack
    if i < 0 or i not in stack:
        return  # a full session's, or one since replaced
    while True:
        top = stack.pop()
        r.ends[top] = now
        if top == i:
            return


def mark(name: str) -> None:
    """A zero-length record inside the innermost open span."""
    if not (_prof._is_profiler_enabled or _rec.forced):
        return
    _open(name, "", False)


@contextlib.contextmanager
def recording():
    """Record spans inside the block without a profiler; the outermost
    block starts a session."""
    if not _rec.forced:
        _rec.fresh = True
    _rec.forced += 1
    try:
        yield
    finally:
        _rec.forced -= 1
        if not _rec.forced:
            _rec.fresh = True


def latest() -> List[Span]:
    """The records of the latest session, in the order they were opened;
    each inherits its solve and pivot ids from the spans around it."""
    r = _rec
    out = []
    for i, (name, parent) in enumerate(zip(r.names, r.parents)):
        if parent < 0:
            solve, pivot = r.solve_ids[i], -1
        else:
            solve, pivot = out[parent].solve, out[parent].pivot
        if name == "pivot":
            pivot = r.pivot_ids[i]
        out.append(Span(name, r.starts[i], r.ends[i], parent, solve, pivot, r.kinds.get(i, "")))
    return out


def device_ops(prof) -> list:
    """``(name, start_ns, end_ns)`` of a finished profile's device operations
    on the spans' clock, in start order: its CUDA records (kernels, memsets,
    copies; the ``nccl:`` ranges over NCCL kernels left out), or, where it
    traced no card, its top-level CPU operations."""
    from torch.autograd import DeviceType

    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = prof.events()
    picked = [e for e in events if e.device_type == DeviceType.CUDA and not e.name.startswith("nccl:")]
    if not picked:
        picked = [e for e in events if e.device_type == DeviceType.CPU and e.cpu_parent is None]
    out = [(e.name, t0 + round(1000 * e.time_range.start), t0 + round(1000 * e.time_range.end)) for e in picked]
    out.sort(key=lambda op: op[1])
    return out


class Gap(NamedTuple):
    """Device idle gaps grouped by the operation that ended them and the
    innermost host spans open when they began and ended ("-": none)."""

    before: str  # the operation's name, 80 characters
    began: str
    ended: str
    count: int
    seconds: float


def _innermost(records: List[Span], times: list) -> list:
    """The label of the innermost closed, non-empty span open at each time
    (start <= t < end), "-" where none is: one sweep, spans being nested."""
    timed = sorted((s for s in records if s.end_ns > s.start_ns), key=lambda s: (s.start_ns, -s.end_ns))
    out = ["-"] * len(times)
    j, stack = 0, []
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(timed) and timed[j].start_ns <= t:
            while stack and stack[-1].end_ns <= timed[j].start_ns:
                stack.pop()
            stack.append(timed[j])
            j += 1
        while stack and stack[-1].end_ns <= t:
            stack.pop()
        if stack:
            out[i] = stack[-1].label
    return out


def gaps(prof, records: Optional[List[Span]] = None) -> List[Gap]:
    """Why the card was idle: each gap between the device operations of
    ``prof`` (a finished profile, or its :func:`device_ops`), attributed to
    the innermost host span open when it began and the one open when it
    ended, over ``records`` (default: :func:`latest`). Rows summed by
    (operation after the gap, span at its start, span at its end), the
    largest first."""
    ops = prof if isinstance(prof, list) else device_ops(prof)
    records = latest() if records is None else records
    found, cur_end = [], None
    for name, s, e in ops:
        if cur_end is not None and s > cur_end:
            found.append((name[:80], cur_end, s))
        cur_end = e if cur_end is None else max(cur_end, e)
    began = _innermost(records, [g[1] for g in found])
    ended = _innermost(records, [g[2] for g in found])
    rows = collections.defaultdict(lambda: [0, 0])
    for (name, g0, g1), b, e in zip(found, began, ended):
        row = rows[(name, b, e)]
        row[0] += 1
        row[1] += g1 - g0
    got = [Gap(*key, n, ns * 1e-9) for key, (n, ns) in rows.items()]
    return sorted(got, key=lambda g: -g.seconds)
