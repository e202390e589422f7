"""The default pivot step replayed as a CUDA graph (``core/graph.py``).

On the CPU: the rule that decides where the graph engages
(``step.default_step`` / ``graph.StepGraphs.takes``), and that no
CPU solve replays. On the card (marker ``card``; these skip without CUDA, and import
no JAX): the graph path against the eager path bit for bit, in float32 and
float64, on a ``benchmark.generate.dense_canonical`` LP of 1024 x 2048 --
over 300 pivots, in ``solve_state`` chunks with a restart, around Bland
steps and a perturbation, under ``torch.profiler`` -- and the states, the
launch counts and the host reads it hands back. On the card, from the repo
root:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_pivot_graph.py -q
"""

import dataclasses
import re

import numpy as np
import pytest
import scipy.sparse
import torch

from simplex_tpu_torch import SimplexOptions
from simplex_tpu_torch.core import solver, step
from simplex_tpu_torch.core.state import initial_state_slack
from simplex_tpu_torch.dist.sharded import make_collective_backend
from simplex_tpu_torch.kernels import hopper
from simplex_tpu_torch.kernels.dispatch import get_backend
from simplex_tpu_torch.oracle.generator import random_dense_lp

LEAVES = ("basis", "x_b", "y", "c_b", "iters", "status", "degen")


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); this machine has none")
    return torch.device("cuda")


def _fresh(prob, opts):
    return initial_state_slack(
        prob, opts.dtype, perturb=opts.perturb_after > 0, update_defer=opts.resolve_defer(),
        multi_price=opts.multi_price, pricing=opts.pricing,
        at_upper0=np.zeros(prob.A.shape[1], bool) if prob.u is not None else None,
    )


# --------------------------------------------------------------------------
# CPU: the engagement rule
# --------------------------------------------------------------------------


def _cpu_case(backend="hopper", u=False, sparse=False, **kw):
    m, n = 32, 128
    opts = SimplexOptions(**kw)
    A, b, c = random_dense_lp(m, n, seed=3)
    if sparse:
        A = scipy.sparse.csr_matrix(A)
    prob = solver.build_problem(A, b, c, opts, "cpu", np.full(n, 5.0) if u else None)
    be = make_collective_backend(None, 0, n) if backend == "collective" else get_backend(backend)
    state = _fresh(prob, opts)
    return prob, state, opts, be, step.read_control(state, opts, prob, be)


def _captures(prob, state, opts, be, ctl):
    """The rule on the backend's graphs; a backend without any captures nothing."""
    graphs = getattr(be, "step_graphs", None)
    return graphs is not None and step.default_step(prob, state, opts, ctl)


def _takes(prob, state, opts, be, ctl):
    graphs = getattr(be, "step_graphs", None)
    return graphs is not None and graphs.takes(prob, state, opts, ctl)


def test_default_step_takes_the_graph_path():
    prob, state, opts, be, ctl = _cpu_case()
    assert _captures(prob, state, opts, be, ctl)
    # CPU tensors: the path fits, the graph does not engage
    assert not _takes(prob, state, opts, be, ctl)


@pytest.mark.parametrize("case", [
    dict(backend="collective"),
    dict(backend="torch"),
    dict(u=True),
    dict(pricing_dtype="bfloat16"),
    dict(pricing_sparse=True),
    dict(partial_pricing=4, partial_min_segment=8),
    dict(multi_price=8),
    dict(update_defer=4),
    dict(pricing="devex"),
    dict(pricing="steepest"),
    dict(sparse=True),
], ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_other_paths_launch_op_by_op(case):
    prob, state, opts, be, ctl = _cpu_case(**case)
    assert not _captures(prob, state, opts, be, ctl)
    assert not _takes(prob, state, opts, be, ctl)


def test_bland_step_launches_op_by_op():
    prob, state, opts, be, ctl = _cpu_case(bland_after=4)
    assert _captures(prob, state, opts, be, ctl._replace(degen=3))
    assert not _captures(prob, state, opts, be, ctl._replace(degen=4))


def test_partial_pricing_too_fine_to_segment_takes_the_graph_path():
    # segments under partial_min_segment leave segmented pricing off: the
    # step is then the default one
    prob, state, opts, be, ctl = _cpu_case(partial_pricing=4)
    assert _captures(prob, state, opts, be, ctl)


def test_only_the_single_card_hopper_backend_keeps_graphs():
    assert get_backend("hopper").step_graphs is not None
    assert get_backend("torch").step_graphs is None
    assert getattr(make_collective_backend(None, 0, 8), "step_graphs", None) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_solves_never_replay(dtype):
    from simplex_tpu_torch import solve

    step.reset_graph_steps()
    A, b, c = random_dense_lp(24, 64, seed=5)
    res = solve(A, b, c, options=SimplexOptions(dtype=dtype), device="cpu")
    assert res.status == 1
    assert step.graph_steps["replayed"] == 0 and step.graph_steps["captured"] == 0
    assert step.graph_steps["eager"] >= res.iters


# --------------------------------------------------------------------------
# the card: the graph path against the eager path
# --------------------------------------------------------------------------

DTYPES = [torch.float32, torch.float64]


def _lp(dtype, device, zero_every=0, seed=7):
    from benchmark import generate

    cfg = {"m": 1024, "n": 2048, "dtype": str(dtype).split(".")[1], "column_block": 512}
    A, b, c = generate.dense_canonical(cfg, seed, device)
    if zero_every:
        b[::zero_every] = 0  # degenerate: the first steps take theta = 0
    return A, b, c


def _eager_backend():
    be = get_backend("hopper")
    be.step_graphs = None
    return be


def _snap(s):
    return {k: getattr(s, k).clone() for k in LEAVES + ("B_inv",)}


def _equal(a, b):
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _steps(prob, opts, be, k):
    """k pivots of the loop's kind, one at a time; the snapshot after each."""
    s = _fresh(prob, opts)
    ctl = step.read_control(s, opts, prob, be)
    out = []
    for _ in range(k):
        s = step.pivot_step(prob, s, opts, be, ctl)
        ctl = step.read_control(s, opts, prob, be)
        out.append({name: getattr(s, name).clone() for name in LEAVES})
    return s, out


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_graph_steps_equal_eager_steps(dtype, card):
    opts = SimplexOptions(dtype=dtype)
    A, b, c = _lp(dtype, card)
    prob = solver.build_problem(A, b, c, opts, card)
    s_e, eager = _steps(prob, opts, _eager_backend(), 300)
    step.reset_graph_steps()
    s_g, graph = _steps(prob, opts, get_backend("hopper"), 300)
    assert step.graph_steps == {"captured": 2, "replayed": 299, "eager": 1, "ahead": 0}
    for a, b_ in zip(eager, graph):
        _equal(a, b_)
    assert torch.equal(s_e.B_inv, s_g.B_inv)
    assert int(s_g.iters) == 300 and int(s_g.status) == 0


def _chunks(prob, opts, be, sizes):
    """solve_state continued in chunks, restarted from a fresh state at
    each None; the final state of every segment."""
    s, done, finals = _fresh(prob, opts), 0, []
    for k in sizes:
        if k is None:
            finals.append(_snap(s))
            s, done = _fresh(prob, opts), 0
            continue
        s = solver.solve_state(prob, s, opts, done + k, be)
        done = int(s.iters)
        s.status = torch.full_like(s.status, 0)
    finals.append(_snap(s))
    return finals


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_chunks_and_restart_equal_eager(dtype, card):
    opts = SimplexOptions(dtype=dtype)
    prob = solver.build_problem(*_lp(dtype, card), opts, card)
    sizes = [64] * 5 + [None] + [64, 64]
    step.reset_graph_steps()
    graph = _chunks(prob, opts, get_backend("hopper"), sizes)
    assert step.graph_steps["replayed"] >= 440
    eager = _chunks(prob, opts, _eager_backend(), sizes)
    for a, b_ in zip(eager, graph):
        _equal(a, b_)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_bland_steps_run_eagerly_between_replays(dtype, card):
    # b = 0 on every 64th row: the first steps are degenerate, Bland's rule
    # comes on at the second, the perturbation at the fourth
    opts = SimplexOptions(dtype=dtype, bland_after=2, perturb_after=4)
    prob = solver.build_problem(*_lp(dtype, card, zero_every=64), opts, card)
    kinds, inner = [], solver.pivot_step

    def traced(prob, state, opts, backend, ctl=None):
        before = dict(step.graph_steps)
        new = inner(prob, state, opts, backend, ctl)
        kinds.append("r" if step.graph_steps["replayed"] > before["replayed"] else "e")
        return new

    solver.pivot_step = traced
    try:
        s_g = solver.solve_state(prob, _fresh(prob, opts), opts, 300, get_backend("hopper"))
    finally:
        solver.pivot_step = inner
    s_e = solver.solve_state(prob, _fresh(prob, opts), opts, 300, _eager_backend())
    _equal(_snap(s_e), _snap(s_g))
    assert re.search("r+e+r", "".join(kinds)), "".join(kinds)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_states_stay_valid(dtype, card):
    opts = SimplexOptions(dtype=dtype)
    prob = solver.build_problem(*_lp(dtype, card), opts, card)
    be = get_backend("hopper")
    s, _ = _steps(prob, opts, be, 5)
    ctl = step.read_control(s, opts, prob, be)
    for _ in range(3):
        kept = {k: getattr(s, k).clone() for k in LEAVES}
        new = step.pivot_step(prob, s, opts, be, ctl)
        ctl = step.read_control(new, opts, prob, be)
        # state k is unchanged by step k + 1
        for k in LEAVES:
            assert torch.equal(getattr(s, k), kept[k]), k
        s = new
    # a state solve_state returns shares no memory with the graphs' buffers
    s1 = solver.solve_state(prob, _fresh(prob, opts), opts, 40, be)
    assert be.step_graphs.detach(s1) is s1
    kept = {k: getattr(s1, k).clone() for k in LEAVES if k != "status"}
    s2 = dataclasses.replace(s1, status=torch.full_like(s1.status, 0))
    solver.solve_state(prob, s2, opts, 80, be)
    for k, v in kept.items():
        assert torch.equal(getattr(s1, k), v), k


def _counts(prob, opts, be, k):
    hopper.reset_launches()
    step.reset_host_reads()
    solver.solve_state(prob, _fresh(prob, opts), opts, k, be)
    return dict(hopper.launches), dict(step.host_reads)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_counts_advance_as_eagerly(dtype, card):
    opts = SimplexOptions(dtype=dtype)
    prob = solver.build_problem(*_lp(dtype, card), opts, card)
    graph = _counts(prob, opts, get_backend("hopper"), 50)
    eager = _counts(prob, opts, _eager_backend(), 50)
    assert graph == eager
    # the head step prices itself, and every step prices the next one
    assert graph[0]["ratio_eta"] == graph[0]["rank1_update"] == 50 and graph[0]["pricing_scan"] == 51


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_capture_under_the_profiler(dtype, card):
    from torch.profiler import ProfilerActivity, profile

    opts = SimplexOptions(dtype=dtype)
    prob = solver.build_problem(*_lp(dtype, card), opts, card)
    step.reset_graph_steps()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s_g, graph = _steps(prob, opts, get_backend("hopper"), 30)
        torch.cuda.synchronize()
    assert step.graph_steps == {"captured": 2, "replayed": 29, "eager": 1, "ahead": 0}
    s_e, eager = _steps(prob, opts, _eager_backend(), 30)
    for a, b_ in zip(eager, graph):
        _equal(a, b_)
    # the replayed kernels are in the trace: 30 rank-1 updates
    ranks = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and "rank1" in e.name]
    assert len(ranks) == 30
