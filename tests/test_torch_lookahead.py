"""The solve loop's one-step lookahead (``core.solver._pivot_loop``): the
step after a replay of the default step's graph is enqueued before that
replay's control words are read (``core.solver.may_run_ahead``,
``core.graph.StepGraphs.ready``).

On the CPU: the rule, case by case and against the serial loop's own
conditions, and that no CPU solve runs a step ahead. On the card (marker
``card``; these skip without CUDA, and import no JAX): the lookahead loop
against the serial loop bit for bit, in float32 and float64, over chunks,
restarts, the perturbation and Bland thresholds and the terminal exits; the
step run ahead of a terminal state leaves it as it was; chunks stop at
their pivot limit; the harness's step recorder sees every step once, in
order; the ``graph`` spans of kind ``ahead`` under ``torch.profiler``; and
no eager path runs ahead. On the card, from the repo root:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_lookahead.py -q
"""

import contextlib

import numpy as np
import pytest
import scipy.sparse
import torch

from simplex_tpu_torch import SimplexOptions
from simplex_tpu_torch.core import solver, step
from simplex_tpu_torch.core.state import initial_state_slack
from simplex_tpu_torch.core.step import Control
from simplex_tpu_torch.dist.sharded import make_collective_backend
from simplex_tpu_torch.kernels.dispatch import get_backend
from simplex_tpu_torch.oracle.generator import random_dense_lp
from simplex_tpu_torch.status import SolveStatus

LEAVES = ("basis", "x_b", "y", "c_b", "iters", "status", "degen")
RUNNING = int(SolveStatus.RUNNING)


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); this machine has none")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# CPU: the rule
# --------------------------------------------------------------------------


def _ctl(iters=100, degen=0, pert_rounds=0, status=RUNNING):
    return Control(status=status, iters=iters, degen=degen, last_refac=0, pert_rounds=pert_rounds)


@pytest.mark.parametrize("ctl, opts, max_iter, replayed, ahead", [
    # the default perturb_after 48 and bland_after 64
    (dict(degen=46), {}, 1000, True, True),
    (dict(degen=47), {}, 1000, True, False),  # degen 48 arms the perturbation
    (dict(degen=62), {}, 1000, True, True),
    (dict(degen=63), {}, 1000, True, False),  # degen 64 turns Bland's rule on
    (dict(degen=47, pert_rounds=solver.MAX_PERTURB_ROUNDS), {}, 1000, True, True),  # rounds spent
    (dict(degen=95), dict(bland_after=0), 1000, True, False),  # 96: a multiple of 48
    (dict(degen=96), dict(bland_after=0), 1000, True, True),
    (dict(degen=47), dict(perturb_after=0), 1000, True, True),
    (dict(degen=63), dict(perturb_after=0), 1000, True, False),
    (dict(degen=63), dict(bland_after=0), 1000, True, True),
    (dict(degen=1000), dict(bland_after=0, perturb_after=0), 1000_000, True, True),
    # the pivot limit: iters + 2 at most max_iter
    (dict(iters=998), {}, 1000, True, True),
    (dict(iters=999), {}, 1000, True, False),
    (dict(iters=1000), {}, 1000, True, False),
    # upkeep at iters k or k + 1
    (dict(iters=49), dict(refactor_every=50), 1000, True, False),
    (dict(iters=50), dict(refactor_every=50), 1000, True, False),
    (dict(iters=51), dict(refactor_every=50), 1000, True, True),
    (dict(iters=0), dict(refactor_every=50), 1000, True, True),
    (dict(iters=99), dict(recompute_every=50), 1000, True, False),
    (dict(iters=100), dict(recompute_every=50), 1000, True, False),
    (dict(iters=101), dict(recompute_every=50), 1000, True, True),
    # two triggers at once
    (dict(iters=9, degen=4), dict(perturb_after=5, recompute_every=10), 1000, True, False),
    (dict(iters=9, degen=5), dict(perturb_after=5, recompute_every=10), 1000, True, False),
    (dict(iters=10, degen=5), dict(perturb_after=5, recompute_every=10), 1000, True, False),
    (dict(iters=11, degen=4), dict(perturb_after=5, recompute_every=10), 1000, True, False),
    (dict(iters=11, degen=5), dict(perturb_after=5, recompute_every=10), 1000, True, True),
    (dict(iters=9, degen=4, pert_rounds=solver.MAX_PERTURB_ROUNDS),
     dict(perturb_after=5, recompute_every=10), 1000, True, False),
    (dict(iters=11, degen=4, pert_rounds=solver.MAX_PERTURB_ROUNDS),
     dict(perturb_after=5, recompute_every=10), 1000, True, True),
    (dict(iters=19), dict(recompute_every=10, refactor_every=20), 1000, True, False),
    (dict(iters=20), dict(recompute_every=10, refactor_every=20), 1000, True, False),
    (dict(iters=21), dict(recompute_every=10, refactor_every=20), 1000, True, True),
    (dict(iters=19, degen=4), dict(perturb_after=5, recompute_every=10, refactor_every=20), 1000, True, False),
    (dict(degen=47), dict(bland_after=48), 1000, True, False),  # perturbation and Bland at 48
    (dict(degen=46), dict(bland_after=48), 1000, True, True),
    # step k ran eagerly or was captured (its output is no unread replay's)
    (dict(), {}, 1000, False, False),
    # a terminal state is not stepped by the loop at all
    (dict(status=int(SolveStatus.OPTIMAL)), {}, 1000, True, False),
], ids=lambda v: str(v) if not isinstance(v, dict) else ",".join(f"{k}={x}" for k, x in v.items()) or "-")
def test_lookahead_rule(ctl, opts, max_iter, replayed, ahead):
    assert solver.may_run_ahead(_ctl(**ctl), SimplexOptions(**opts), max_iter, replayed) is ahead


def _serial_would_run_the_same_step(ctl, opts, max_iter, degen_next, iters_next):
    """The serial loop's conditions after step k, restated: it steps again
    from s_{k+1}, with no upkeep before, as the graph path's default step."""
    if iters_next >= max_iter:
        return False
    pa = opts.perturb_after
    if pa > 0 and ctl.pert_rounds < solver.MAX_PERTURB_ROUNDS and degen_next >= pa and degen_next % pa == 0:
        return False
    for every in (opts.recompute_every, opts.refactor_every):
        if every > 0 and iters_next > 0 and iters_next % every == 0:
            return False
    return not (opts.bland_after > 0 and degen_next >= opts.bland_after)


@pytest.mark.parametrize("opts", [
    dict(),
    dict(bland_after=0),
    dict(perturb_after=0),
    dict(perturb_after=5, bland_after=17),
    dict(refactor_every=7, recompute_every=11),
], ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()) or "default")
def test_lookahead_rule_implies_the_serial_step(opts):
    # for every outcome of step k (a pivot: iters + 1 and degen + 1 or 0),
    # a step the rule lets run ahead is the one the serial loop runs next
    opts = SimplexOptions(**opts)
    max_iter, taken = 150, 0
    for iters in range(max_iter + 1):
        for degen in range(140):
            for rounds in (0, solver.MAX_PERTURB_ROUNDS):
                ctl = _ctl(iters=iters, degen=degen, pert_rounds=rounds)
                if not solver.may_run_ahead(ctl, opts, max_iter, True):
                    continue
                taken += 1
                for degen_next in (0, degen + 1):
                    assert _serial_would_run_the_same_step(ctl, opts, max_iter, degen_next, iters + 1)
    assert taken > 0


@contextlib.contextmanager
def _one_rank(device, path):
    """A default process group of one rank, for the column-sharded loop."""
    import torch.distributed as dist

    kind = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(kind, init_method=f"file://{path}", world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _eager_path(case: str, device, tmp_path):
    """A small solve down one of the eager paths on ``device``; the counts
    of steps by how they ran."""
    from simplex_tpu_torch import solve, solve_dual

    m, n = 32, 128
    A, b, c = random_dense_lp(m, n, seed=3)
    kw = {
        "default": {}, "steepest": dict(pricing="steepest"), "devex": dict(pricing="devex"),
        "shadow": dict(pricing_dtype="bfloat16"), "segmented": dict(partial_pricing=4, partial_min_segment=8),
        "multi_price": dict(multi_price=8), "deferred": dict(update_defer=4),
    }
    step.reset_graph_steps()
    if case == "bounded":
        res = solve(A, b, c, u=np.full(n, 5.0), device=device)
    elif case == "dual":
        rng = np.random.default_rng(2)
        A = np.hstack([rng.uniform(-1, 1, (m, n - m)), np.eye(m)]).astype(np.float32)
        b = rng.uniform(-2, 2, m).astype(np.float32)
        c = np.concatenate([-rng.uniform(0.5, 2, n - m), np.zeros(m)]).astype(np.float32)
        res = solve_dual(A, b, c, device=device)
    elif case == "sharded":
        opts = SimplexOptions()
        prob = solver.build_problem(A, b, c, opts, device)
        state = initial_state_slack(prob, opts.dtype, perturb=True)
        kernels = "hopper" if torch.device(device).type == "cuda" else "torch"
        with _one_rank(device, tmp_path / "rendezvous"):
            backend = make_collective_backend(None, 0, n, kernels=kernels)
            res = solver.solve_state(prob, state, opts, 10_000, backend)
    elif case == "sparse":
        res = solve(scipy.sparse.csr_matrix(A), b, c, device=device)
    else:
        res = solve(A, b, c, options=SimplexOptions(**kw[case]), device=device)
    assert int(res.status) != RUNNING
    return dict(step.graph_steps)


EAGER_PATHS = ["steepest", "devex", "shadow", "segmented", "multi_price", "deferred", "bounded", "dual",
               "sharded", "sparse"]


@pytest.mark.parametrize("case", ["default"] + EAGER_PATHS)
def test_cpu_solves_never_run_ahead(case, tmp_path):
    counts = _eager_path(case, "cpu", tmp_path)
    assert counts["ahead"] == counts["replayed"] == counts["captured"] == 0


def test_the_reader_counts_graph_spans_of_kind_ahead():
    from pathlib import Path

    from benchmark import cells
    from simplex_tpu_torch import spans

    read = cells.metric_reader("graph_ahead_per_pivot.window", Path(__file__).resolve().parents[1])
    with spans.recording():
        for kind in ("", "ahead", "ahead", "", "ahead"):
            spans.stop(spans.start("graph", kind))
    assert read({"trace": {"pivots": 4}}) == 0.75
    assert read({"trace": None}) is None
    with spans.recording():
        spans.stop(spans.start("graph"))
    assert read({"trace": {"pivots": 4}}) == 0.0


# --------------------------------------------------------------------------
# the card: the lookahead loop against the serial loop
# --------------------------------------------------------------------------

DTYPES = [torch.float32, torch.float64]


@contextlib.contextmanager
def serial():
    """The serial loop: the lookahead's rule never holds inside the block."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(solver, "may_run_ahead", lambda *a: False)
        yield


@contextlib.contextmanager
def counting(name):
    """Counts the calls of ``solver.<name>`` inside the block."""
    calls = [0]
    inner = getattr(solver, name)

    def wrapped(*a, **k):
        calls[0] += 1
        return inner(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(solver, name, wrapped)
        yield calls


def _lp(dtype, device, zero_every=0, seed=7, m=1024):
    from benchmark import generate

    cfg = {"m": m, "n": 2 * m, "dtype": str(dtype).split(".")[1], "column_block": 512}
    A, b, c = generate.dense_canonical(cfg, seed, device)
    if zero_every:
        b[::zero_every] = 0  # degenerate: the first steps take theta = 0
    return A, b, c


def _fresh(prob, opts):
    return initial_state_slack(prob, opts.dtype, perturb=opts.perturb_after > 0)


def _snap(s):
    return {k: getattr(s, k).clone() for k in LEAVES + ("B_inv",)}


def _bits(t):
    """``t``'s bits: NaN equals NaN, and -0.0 differs from 0.0."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(_bits(a[k]), _bits(b[k])), k


class Steps:
    """Wraps ``solver.pivot_step`` while installed: how each step from a
    running state ran ("a" ahead, "r" replayed, "e" eager), and for each
    step from a terminal state (only a step run ahead starts from one) the
    state and B_inv before and after it, and how it ran."""

    def __init__(self):
        self.kinds, self.from_terminal = [], []

    def __call__(self, prob, state, opts, backend, ctl=None):
        # reading the status here waits on the card; it moves no decision
        terminal = int(state.status) != RUNNING
        before = _snap(state) if terminal else None
        counts = dict(step.graph_steps)
        new = self.inner(prob, state, opts, backend, ctl)
        if step.graph_steps["ahead"] > counts["ahead"]:
            kind = "a"
        else:
            kind = "r" if step.graph_steps["replayed"] > counts["replayed"] else "e"
        if terminal:
            self.from_terminal.append((before, _snap(new), kind))
        else:
            self.kinds.append(kind)
        return new

    def __enter__(self):
        self.inner = solver.pivot_step
        solver.pivot_step = self
        return self

    def __exit__(self, *exc):
        solver.pivot_step = self.inner


def _chunks(prob, opts, sizes):
    """solve_state continued in chunks, restarted from a fresh state at
    each None; the final state of every segment, and the steps."""
    be = get_backend("hopper")
    s, done, finals = _fresh(prob, opts), 0, []
    with Steps() as steps:
        for k in sizes:
            if k is None:
                finals.append(_snap(s))
                s, done = _fresh(prob, opts), 0
                continue
            s = solver.solve_state(prob, s, opts, done + k, be)
            done = int(s.iters)
            s.status = torch.full_like(s.status, RUNNING)
    finals.append(_snap(s))
    return finals, steps


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("zero_every, thresholds", [
    (0, {}),
    # b = 0 on every 64th row: degenerate from the first step, OPTIMAL after
    # ~20 pivots, so most chunks start from an optimal state (status reset)
    (64, {}),
    # ... Bland's rule on from the second degenerate step, the perturbation
    # armed at the fourth
    (64, dict(bland_after=2, perturb_after=4)),
], ids=["steady", "degenerate", "thresholds"])
def test_lookahead_equals_serial_over_chunks_and_restart(dtype, zero_every, thresholds, card):
    opts = SimplexOptions(dtype=dtype, **thresholds)
    prob = solver.build_problem(*_lp(dtype, card, zero_every=zero_every), opts, card)
    sizes = [96] * 4 + [None] + [96, 96]
    step.reset_graph_steps()
    with counting("perturb_activate") as perturbed:
        ahead, steps = _chunks(prob, opts, sizes)
    kinds = "".join(steps.kinds)
    assert step.graph_steps["ahead"] == kinds.count("a") + len(steps.from_terminal)
    with serial():
        step.reset_graph_steps()
        plain, serial_steps = _chunks(prob, opts, sizes)
        assert step.graph_steps["ahead"] == 0
    assert len(plain) == len(ahead) == 2
    for a, b_ in zip(plain, ahead):
        _equal(a, b_)
    # the same steps from running states in the same order, each as it ran
    # in the serial loop; the steps from terminal states ran ahead and
    # changed nothing, and the serial loop runs none
    assert kinds.replace("a", "r") == "".join(serial_steps.kinds)
    assert serial_steps.from_terminal == []
    for before, after, kind in steps.from_terminal:
        assert kind == "a"
        _equal(before, after)
    if zero_every == 0:
        assert kinds.count("a") > 0.9 * len(kinds), kinds
    else:
        assert steps.from_terminal and "a" in kinds
    if thresholds:
        # Bland's steps ran eagerly, the perturbation armed, and the
        # lookahead started again after them
        assert perturbed[0] > 0
        assert "e" in kinds[1:] and "a" in kinds[kinds.index("e", 1):], kinds


def _terminal_lp(exit_: str, dtype, device):
    """256 x 512: eight unit columns, each a nondegenerate pivot (c 19 down to
    12), fillers no step takes, the slacks; with ``unbounded`` column 0 is
    -0.01 on every row at c = 1, which enters after the eight and finds no
    leaving row. B_inv stays the identity, so every step is exact."""
    m, n = 256, 512
    A = np.zeros((m, n))
    A[:, 9:256] = 0.5
    c = np.zeros(n)
    c[9:256] = -1.0
    for j in range(1, 9):
        A[j, j], c[j] = 1.0, 20.0 - j
    if exit_ == "unbounded":
        A[:, 0], c[0] = -0.01, 1.0
    else:
        A[:, 0], c[0] = 0.5, -1.0
    A[:, 256:] = np.eye(m)
    b = np.ones(m)
    return [torch.tensor(x, dtype=dtype, device=device) for x in (A, b, c)]


class Nan:
    """Writes NaN into y[0] of the state the sixth step returns: the step
    after it prices NaN and ends SINGULAR."""

    def __init__(self):
        self.calls = 0

    def __call__(self, prob, state, opts, backend, ctl=None):
        new = self.inner(prob, state, opts, backend, ctl)
        self.calls += 1
        if self.calls == 6:
            new.y[0] = float("nan")
        return new

    def __enter__(self):
        self.inner = solver.pivot_step
        solver.pivot_step = self
        return self

    def __exit__(self, *exc):
        solver.pivot_step = self.inner


def _to_the_end(prob, opts, exit_):
    be = get_backend("hopper")
    with Steps() as steps:
        if exit_ == "singular":
            with Nan():
                s = solver.solve_state(prob, _fresh(prob, opts), opts, 10_000, be)
        else:
            s = solver.solve_state(prob, _fresh(prob, opts), opts, 10_000, be)
    return _snap(s), steps


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("exit_, status", [
    ("optimal", SolveStatus.OPTIMAL), ("unbounded", SolveStatus.UNBOUNDED), ("singular", SolveStatus.SINGULAR),
])
def test_a_step_ahead_of_a_terminal_state_changes_nothing(dtype, exit_, status, card):
    # verify rounds off: the SINGULAR exit (a NaN y, not a drifted inverse)
    # would otherwise be re-inverted away
    opts = SimplexOptions(dtype=dtype, verify_terminal=False)
    prob = solver.build_problem(*_terminal_lp(exit_, dtype, card), opts, card)
    step.reset_graph_steps()
    ahead, steps = _to_the_end(prob, opts, exit_)
    assert int(ahead["status"]) == int(status)
    # the one step from the terminal state ran ahead, and left it as it was
    assert [kind for _, _, kind in steps.from_terminal] == ["a"]
    before, after, _ = steps.from_terminal[0]
    _equal(before, after)
    with serial():
        plain, serial_steps = _to_the_end(prob, opts, exit_)
    assert serial_steps.from_terminal == []
    assert "".join(steps.kinds).replace("a", "r") == "".join(serial_steps.kinds)
    _equal(plain, ahead)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_lookahead_to_optimal_equals_serial(dtype, card):
    opts = SimplexOptions(dtype=dtype)
    prob = solver.build_problem(*_lp(dtype, card, seed=11), opts, card)
    step.reset_graph_steps()
    ahead, steps = _to_the_end(prob, opts, "optimal")
    assert int(ahead["status"]) == int(SolveStatus.OPTIMAL)
    assert step.graph_steps["ahead"] > 0.9 * len(steps.kinds) and steps.from_terminal
    for before, after, kind in steps.from_terminal:
        assert kind == "a"
        _equal(before, after)
    with serial():
        plain, _ = _to_the_end(prob, opts, "optimal")
    _equal(plain, ahead)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_chunks_stop_at_their_pivot_limit(dtype, card):
    from benchmark.drive import StepRecorder

    opts = SimplexOptions(dtype=dtype)
    # 2048 x 4096: still running after 1,536 pivots (1024 x 2048 is OPTIMAL at 520)
    prob = solver.build_problem(*_lp(dtype, card, m=2048), opts, card)
    be = get_backend("hopper")
    s, done = _fresh(prob, opts), 0
    with StepRecorder(solver, set()) as rec:
        for k in range(3):
            rec.start(k, 512)  # one step more raises
            step.reset_graph_steps()
            s = solver.solve_state(prob, s, opts, done + 512, be)
            assert (rec.steps, int(s.iters), int(s.status)) == (512, done + 512, int(SolveStatus.MAX_ITER)), \
                dict(step.graph_steps)
            assert step.graph_steps["ahead"] >= 0.95 * 512
            done = int(s.iters)
            s.status = torch.full_like(s.status, RUNNING)


def _recorded(prob, opts, k):
    from benchmark.drive import StepRecorder

    with StepRecorder(solver, {(0, i) for i in range(k)}) as rec:
        rec.start(0, k)
        solver.solve_state(prob, _fresh(prob, opts), opts, k, get_backend("hopper"))
    return rec.pivots


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_the_harness_recorder_sees_each_step_once_in_order(dtype, card):
    opts = SimplexOptions(dtype=dtype)
    prob = solver.build_problem(*_lp(dtype, card), opts, card)
    step.reset_graph_steps()
    ahead = _recorded(prob, opts, 200)
    assert step.graph_steps["ahead"] > 190
    with serial():
        plain = _recorded(prob, opts, 200)
    assert [p["step"] for p in ahead] == list(range(200))
    for p, q in zip(plain, ahead):
        for k in ("basis0", "basis1", "x_b1"):
            assert torch.equal(p[k], q[k]), (p["step"], k)
    for p, q in zip(ahead, ahead[1:]):
        assert torch.equal(p["basis1"], q["basis0"])
    for p in ahead:
        assert int((p["basis0"] != p["basis1"]).sum()) == 1  # one column in, one out


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_spans_count_the_steps_run_ahead(dtype, card):
    from torch.profiler import ProfilerActivity, profile

    from simplex_tpu_torch import spans

    opts = SimplexOptions(dtype=dtype)
    prob = solver.build_problem(*_lp(dtype, card), opts, card)
    step.reset_graph_steps()
    step.reset_host_reads()
    spans.stop(spans.start_solve())  # recording off: the next record starts a session
    with profile(activities=[ProfilerActivity.CUDA]):
        solver.solve_state(prob, _fresh(prob, opts), opts, 100, get_backend("hopper"))
        torch.cuda.synchronize()
    recs = spans.latest()
    graph = [r for r in recs if r.name == "graph"]
    assert sum(r.kind == "ahead" for r in graph) == step.graph_steps["ahead"] >= 95
    assert len(graph) == step.graph_steps["replayed"]
    assert sum(r.name == "launch:pivot_graph" for r in recs) == step.graph_steps["replayed"]
    assert sum(r.name == "read" for r in recs) == step.host_reads["control"]


@pytest.mark.card
@pytest.mark.parametrize("case", EAGER_PATHS)
def test_eager_paths_never_run_ahead(case, card, tmp_path):
    counts = _eager_path(case, card, tmp_path)
    assert counts["ahead"] == counts["replayed"] == 0
    assert counts["eager"] > 0 or case == "dual"
