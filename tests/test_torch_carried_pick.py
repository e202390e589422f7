"""The carried pick of the default pivot step (``core.step``): the step
prices the state it returns and runs its rank-1 update with the next ftran
fused in (``rank1_update_ftran``), so the next step starts at its tail.

On the CPU: the plain fused op against the update followed by ``torch.mv``
bit for bit; the carrying loop against the loop without the fused op, bit
for bit, over chunks, a restart and every kind of upkeep; the pick dropped
by each upkeep, by a step with Bland's rule on and by the solve loop on its
way out; the other paths, the collective backend's among them, never carry;
the benchmark's reader of the fused launches. On the card (marker ``card``;
these skip without CUDA, and import no JAX): the fused kernel's update
against the standalone kernel bit for bit, its alpha against ``torch.mv``
and against itself, and the launches of the default and the other paths.
On the card, from the repo root:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_carried_pick.py -q -m card
"""

import contextlib
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from simplex_tpu_torch import SimplexOptions
from simplex_tpu_torch.core import solver, step
from simplex_tpu_torch.core.state import initial_state_slack
from simplex_tpu_torch.dist.sharded import make_collective_backend
from simplex_tpu_torch.kernels import hopper, ops
from simplex_tpu_torch.kernels.dispatch import get_backend
from simplex_tpu_torch.oracle.generator import random_dense_lp

ROOT = Path(__file__).resolve().parents[1]
DTYPES = [torch.float32, torch.float64]
LEAVES = ("basis", "x_b", "y", "c_b", "iters", "status", "degen", "B_inv")


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); this machine has none")
    return torch.device("cuda")


def _bits(t):
    """``t``'s bits: NaN equals NaN, and -0.0 differs from 0.0."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _equal(a, b):
    for k in LEAVES:
        assert torch.equal(_bits(getattr(a, k)), _bits(getattr(b, k))), k


def _rank1_inputs(m, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    B, eta, row, a = (torch.randn(shape, generator=g, dtype=torch.float64) for shape in ((m, m), m, m, m))
    return [t.to(dtype).to(device) for t in (B, eta, row, a)]


# --------------------------------------------------------------------------
# CPU: the plain fused op
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 37, 64])
@pytest.mark.parametrize("fn", [ops.rank1_update_ftran, hopper.rank1_update_ftran], ids=["ops", "hopper"])
def test_plain_fused_op_is_the_update_then_mv(fn, m, dtype):
    B, eta, row, a = _rank1_inputs(m, dtype, "cpu")
    want_B = ops.rank1_update(B.clone(), eta, row)
    want = torch.mv(want_B, a)
    got = fn(B, eta, row, a)
    assert torch.equal(_bits(B), _bits(want_B)) and torch.equal(_bits(got), _bits(want))
    out = torch.empty(m + 2, dtype=dtype)[:m]
    B2 = ops.rank1_update(want_B.clone(), eta, row)
    assert fn(want_B, eta, row, a, out=out) is out
    assert torch.equal(_bits(out), _bits(torch.mv(B2, a)))


def test_fused_op_checks_its_inputs():
    B, eta, row, a = _rank1_inputs(4, torch.float32, "cpu")
    with pytest.raises(ValueError, match="overlap"):
        hopper.rank1_update_ftran(B, eta, B[2], a)  # row aliases B_inv
    with pytest.raises(ValueError, match="overlap"):
        hopper.rank1_update_ftran(B, eta, row, B[1])  # a aliases B_inv
    with pytest.raises(ValueError, match="square"):
        hopper.rank1_update_ftran(B[:2], eta[:2], row, a)  # a row block
    with pytest.raises(ValueError, match="dtype"):
        hopper.rank1_update_ftran(B, eta, row, a.double())
    with pytest.raises(ValueError, match="out"):
        hopper.rank1_update_ftran(B, eta, row, a, out=a)


# --------------------------------------------------------------------------
# CPU: the carrying loop against the loop without the fused op
# --------------------------------------------------------------------------


def _uncarried(be):
    """``be`` without the fused op: its default step does not carry."""
    be.rank1_update_ftran = None
    return be


def _lp(m=48, n=160, seed=11, zero_every=0):
    A, b, c = random_dense_lp(m, n, seed=seed)
    if zero_every:
        b[::zero_every] = 0  # degenerate: the first steps take theta = 0
    return A, b, c


def _chunks(prob, opts, be, sizes):
    """solve_state continued in chunks, restarted from a fresh state at
    each None; the final state of every segment."""
    s, done, finals = initial_state_slack(prob, opts.dtype, perturb=opts.perturb_after > 0), 0, []
    for k in sizes:
        if k is None:
            finals.append(s)
            s, done = initial_state_slack(prob, opts.dtype, perturb=opts.perturb_after > 0), 0
            continue
        s = solver.solve_state(prob, s, opts, done + k, be)
        assert s.carried is None  # the loop drops the pick on its way out
        done = int(s.iters)
        s.status = torch.full_like(s.status, 0)
    return finals + [s]


@contextlib.contextmanager
def _counting(be, *names):
    """Counts the calls of the backend's ops ``names`` inside the block."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        inner = getattr(be, name)

        def wrapped(*a, _name=name, _inner=inner, **k):
            calls[_name] += 1
            return _inner(*a, **k)

        setattr(be, name, wrapped)
    yield calls


UPKEEP = {
    "steady": {},
    # every upkeep kind inside the chunks: refactorization, recompute, the
    # perturbation and Bland's rule (b = 0 on every 8th row: degenerate)
    "upkeep": dict(refactor_every=10, recompute_every=7, perturb_after=2, bland_after=3),
}


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(UPKEEP))
def test_carrying_loop_equals_the_loop_without_it(case, dtype, backend):
    opts = SimplexOptions(dtype=dtype, **UPKEEP[case])
    prob = solver.build_problem(*_lp(zero_every=8 if UPKEEP[case] else 0), opts, "cpu")
    sizes = [7, 13, None, 9, 11]
    be = get_backend(backend)
    with _counting(be, "rank1_update_ftran", "rank1_update") as calls:
        carried = _chunks(prob, opts, be, sizes)
    plain = _chunks(prob, opts, _uncarried(get_backend(backend)), sizes)
    for a, b_ in zip(carried, plain):
        _equal(a, b_)
    assert calls["rank1_update_ftran"] > 0
    if case == "steady":
        assert calls["rank1_update"] == 0


def test_a_default_chunk_prices_once_more_than_it_pivots():
    opts = SimplexOptions()
    prob = solver.build_problem(*_lp(), opts, "cpu")
    be = get_backend("torch")
    with _counting(be, "choose_entering", "rank1_update_ftran", "rank1_update") as calls:
        s = solver.solve_state(prob, initial_state_slack(prob, opts.dtype, perturb=True), opts, 12, be)
    assert int(s.iters) == 12
    # the head step prices itself; every step prices the next one
    assert calls == {"choose_entering": 13, "rank1_update_ftran": 12, "rank1_update": 0}


def _stepped(opts, k=3, **lp):
    """A default problem, its backend, and the state after k default steps
    (a carried pick on it) with its control."""
    be = get_backend("torch")
    prob = solver.build_problem(*_lp(**lp), opts, "cpu")
    s = initial_state_slack(prob, opts.dtype, perturb=opts.perturb_after > 0)
    for _ in range(k):
        s = step.pivot_step(prob, s, opts, be)
    return prob, be, s, step.read_control(s, opts, prob, be)


@pytest.mark.parametrize("kind", ["refactorize", "recompute_xy", "perturb_activate", "perturb_clear"])
def test_every_upkeep_drops_the_pick(kind):
    opts = SimplexOptions()
    prob, be, s, _ = _stepped(opts)
    assert s.carried is not None
    up = {
        "refactorize": lambda: step.refactorize(prob, s, be),
        "recompute_xy": lambda: step.recompute_xy(prob, s),
        "perturb_activate": lambda: step.perturb_activate(prob, s, be, 1e-6),
        "perturb_clear": lambda: step.perturb_clear(s),
    }[kind]()
    assert up.carried is None


def test_a_step_with_blands_rule_on_drops_the_pick():
    opts = SimplexOptions(bland_after=2)
    prob, be, s, ctl = _stepped(opts)
    assert s.carried is not None
    bland = ctl._replace(degen=2)
    assert not step.carries(prob, s, opts, be, bland)
    # the step updates B_inv in place: the second one starts from a copy
    bare = dataclasses.replace(s, carried=None, B_inv=s.B_inv.clone())
    got = step.pivot_step(prob, s, opts, be, bland)
    assert got.carried is None
    # the step prices for itself, under Bland's rule, as from a state without a pick
    _equal(got, step.pivot_step(prob, bare, opts, be, bland))


def test_the_step_graphs_detach_drops_the_pick():
    opts = SimplexOptions()
    prob, _, s, _ = _stepped(opts)
    be = get_backend("hopper")
    assert s.carried is not None and be.step_graphs.detach(s).carried is None


def test_the_collective_backend_never_carries():
    opts = SimplexOptions()
    prob, _, s, ctl = _stepped(opts)
    be = make_collective_backend(None, 0, prob.A.shape[1])
    assert getattr(be, "rank1_update_ftran", None) is None
    assert not step.carries(prob, s, opts, be, ctl)
    for name in ("torch", "hopper"):
        assert step.carries(prob, s, opts, get_backend(name), ctl)


@contextlib.contextmanager
def _fused_calls():
    """Counts the fused op's calls on both backends inside the block."""
    calls = [0]
    with pytest.MonkeyPatch.context() as mp:
        for mod in (ops, hopper):
            inner = mod.rank1_update_ftran

            def wrapped(*a, _inner=inner, **k):
                calls[0] += 1
                return _inner(*a, **k)

            mp.setattr(mod, "rank1_update_ftran", wrapped)
        yield calls


OTHER_PATHS = {
    "steepest": dict(pricing="steepest"), "devex": dict(pricing="devex"),
    "shadow": dict(pricing_dtype="bfloat16"), "segmented": dict(partial_pricing=4, partial_min_segment=8),
    "multi_price": dict(multi_price=8), "deferred": dict(update_defer=4),
}


def _other_path(case, device):
    """A small solve down one path off the default step on ``device``."""
    from simplex_tpu_torch import solve, solve_batched, solve_dual

    m, n = 32, 128
    A, b, c = random_dense_lp(m, n, seed=3)
    if case == "bounded":
        return solve(A, b, c, u=np.full(n, 5.0), device=device)
    if case == "dual":
        rng = np.random.default_rng(2)
        A = np.hstack([rng.uniform(-1, 1, (m, n - m)), np.eye(m)]).astype(np.float32)
        b = rng.uniform(-2, 2, m).astype(np.float32)
        c = np.concatenate([-rng.uniform(0.5, 2, n - m), np.zeros(m)]).astype(np.float32)
        return solve_dual(A, b, c, device=device)
    if case == "batched":
        return solve_batched(np.stack([A, A]), np.stack([b, b]), np.stack([c, c]), device=device)
    return solve(A, b, c, options=SimplexOptions(**OTHER_PATHS[case]), device=device)


@contextlib.contextmanager
def _grown_in_steps(case, count):
    """The growth of ``count()`` over the block; for "dual" over its dual
    steps alone (the primal phase that follows them is the default step)."""
    grown = [0]
    if case != "dual":
        before = count()
        yield grown
        grown[0] = count() - before
        return
    from simplex_tpu_torch.core import dual

    inner = dual.dual_pivot_step

    def wrapped(*a, **k):
        before = count()
        try:
            return inner(*a, **k)
        finally:
            grown[0] += count() - before

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dual, "dual_pivot_step", wrapped)
        yield grown


@pytest.mark.parametrize("case", list(OTHER_PATHS) + ["bounded", "dual", "batched"])
def test_the_other_paths_never_carry(case):
    with _fused_calls() as calls, _grown_in_steps(case, lambda: calls[0]) as grown:
        _other_path(case, "cpu")
    assert grown[0] == 0


def test_the_default_path_carries():
    from simplex_tpu_torch import solve

    with _fused_calls() as calls:
        res = solve(*random_dense_lp(32, 128, seed=3), device="cpu")
    assert calls[0] >= res.iters > 0


# --------------------------------------------------------------------------
# CPU: the benchmark's reader of the fused launches
# --------------------------------------------------------------------------


def _reader():
    from benchmark import cells

    return cells.metric_reader("rank1_ftran_calls_per_pivot.window", ROOT)


def test_the_reader_reads_the_fused_share_of_the_traced_launches(monkeypatch):
    read = _reader()
    assert read({"trace": None}) is None
    summary = {"pivots": 512, "launches": {"rank1_update": 512}}
    monkeypatch.setitem(hopper.launches, "rank1_update", 2048)
    monkeypatch.setattr(hopper, "rank1_layouts", {"plain": 0, "ftran": 2048})
    assert read({"trace": summary}) == 1.0
    monkeypatch.setattr(hopper, "rank1_layouts", {"plain": 1024, "ftran": 1024})
    assert read({"trace": summary}) == 0.5
    # a program without the counter (the parent of the fused kernel)
    monkeypatch.delattr(hopper, "rank1_layouts")
    assert read({"trace": summary}) is None
    monkeypatch.setitem(hopper.launches, "rank1_update", 0)
    assert read({"trace": summary}) is None


# --------------------------------------------------------------------------
# the card: the fused kernel
# --------------------------------------------------------------------------

# 8192: the benchmark's width; 8191: the unvectorised path; 1088 and 1004:
# rows shorter than a CTA's round of 2048 columns, so that some of its
# threads and groups load nothing
WIDTHS = [8192, 8191, 1088, 1004]
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", WIDTHS)
def test_fused_update_is_the_standalone_update_bit_for_bit(m, dtype, card):
    B, eta, row, a = _rank1_inputs(m, dtype, card, seed=m)
    want = hopper.rank1_update(B.clone(), eta, row)
    hopper.reset_launches()
    alpha = hopper.rank1_update_ftran(B, eta, row, a)
    torch.cuda.synchronize()
    assert hopper.launches["rank1_update"] == hopper.rank1_layouts["ftran"] == 1
    assert hopper.rank1_layouts["plain"] == 0
    assert torch.equal(_bits(B), _bits(want))
    # within rounding of the product: each entry against its sum of |terms|
    ref = torch.mv(want, a)
    scale = torch.mv(want.abs(), a.abs())
    assert bool(((alpha - ref).abs() <= RTOL[dtype] * scale).all())


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_two_calls_give_the_same_alpha(dtype, card):
    m = 8192
    B, eta, row, a = _rank1_inputs(m, dtype, card, seed=1)
    B2 = B.clone()
    first = hopper.rank1_update_ftran(B, eta, row, a)
    out = torch.empty(m, dtype=dtype, device=card)
    second = hopper.rank1_update_ftran(B2, eta, row, a, out=out)
    torch.cuda.synchronize()
    assert second is out
    assert torch.equal(_bits(B), _bits(B2)) and torch.equal(_bits(first), _bits(second))


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_the_default_loop_launches_the_fused_kernel(dtype, card):
    from benchmark import generate

    opts = SimplexOptions(dtype=dtype)
    cfg = {"m": 1024, "n": 2048, "dtype": str(dtype).split(".")[1], "column_block": 512}
    prob = solver.build_problem(*generate.dense_canonical(cfg, 7, card), opts, card)
    hopper.reset_launches()
    s = solver.solve_state(prob, initial_state_slack(prob, dtype, perturb=True), opts, 100, get_backend("hopper"))
    assert int(s.iters) == 100
    # the head step's update fuses the next ftran too: every update is fused
    assert hopper.rank1_layouts == {"plain": 0, "ftran": 100}
    assert hopper.launches["rank1_update"] == 100 and hopper.launches["pricing_scan"] == 101


@pytest.mark.card
@pytest.mark.parametrize("case", list(OTHER_PATHS) + ["bounded", "dual", "batched"])
def test_the_other_paths_launch_no_fused_kernel(case, card):
    hopper.reset_launches()
    with _grown_in_steps(case, lambda: hopper.rank1_layouts["ftran"]) as grown:
        _other_path(case, card)
    torch.cuda.synchronize()
    assert grown[0] == 0
    if case != "dual":
        assert hopper.rank1_layouts["plain"] == hopper.launches["rank1_update"]
