"""The general generator of work: set-up, warm-up, the measured window and
the traced stretch of a cell, as its traffic file says.

A traffic file names its ``generator`` and that generator's parameters:

  pivot_window      one solve continued from the slack basis through the
                    program's ``core.solver.solve_state`` in chunks of
                    ``chunk`` pivots, started again from the slack basis
                    after ``restart_after`` pivots, so that the window holds
                    only the steady pivot loop; over four chips the same
                    through the column-sharded loop (``benchmark.sharded``)
  solve_to_optimal  whole ``simplex_tpu_torch.solve()`` calls to OPTIMAL,
                    back to back, over a pool of ``instances`` LPs made in
                    set-up (the same pool for every seed), in an order drawn
                    from the seed, in whole passes over the pool until
                    ``--seconds`` have passed: every run does the same work

Both keep, for the check, the program's own answers: the basis before and
after sampled pivots with the x_b the step produced (steps drawn from the
seed, recorded by wrapping the solve loop's pivot step), each segment's
final state (basis, x_b, y, B_inv), each solve's result.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from benchmark import generate, trace


class Stalled(RuntimeError):
    """The solve loop took more steps than its pivots allow."""


class StepRecorder:
    """Wraps ``simplex_tpu_torch.core.solver.pivot_step`` while installed:
    counts the steps of the current unit of work (a chunk, a solve),
    raises :class:`Stalled` past ``limit`` of them, and keeps copies of the
    basis before and after, and of x_b after, the steps in ``wanted``
    ((unit, step) pairs)."""

    def __init__(self, solver_mod, wanted):
        self.mod, self.inner = solver_mod, solver_mod.pivot_step
        self.wanted = set(wanted)
        self.unit, self.steps, self.limit = None, 0, 0
        self.pivots = []

    def start(self, unit, limit: int) -> None:
        self.unit, self.steps, self.limit = unit, 0, limit

    def __call__(self, prob, state, opts, backend, ctl=None):
        i = self.steps
        self.steps += 1
        if self.steps > self.limit:
            raise Stalled(f"{self.unit}: {self.steps} steps, more than the {self.limit} allowed")
        new = self.inner(prob, state, opts, backend, ctl)
        if (self.unit, i) in self.wanted:
            self.pivots.append({"unit": self.unit, "step": i, "basis0": state.basis.clone(),
                                "basis1": new.basis.clone(), "x_b1": new.x_b.clone()})
        return new

    def __enter__(self):
        self.mod.pivot_step = self
        return self

    def __exit__(self, *exc):
        self.mod.pivot_step = self.inner


class Clock:
    """Set-up time from ``start`` (the process's start), in named parts."""

    def __init__(self, start: Optional[float] = None):
        self.start = time.perf_counter() if start is None else start
        self.last, self.parts = self.start, []

    def stamp(self, label: str) -> float:
        now = time.perf_counter()
        self.parts.append((label, now - self.last))
        self.last = now
        return now - self.start


@dataclasses.dataclass
class Run:
    """What a generator hands back: the window's work and wall time, set-up,
    the records for the check, the traced stretch's summary."""

    setup_s: float = 0.0
    wall_s: float = 0.0
    setup_parts: list = dataclasses.field(default_factory=list)
    unit_s: list = dataclasses.field(default_factory=list)  # (pivots, seconds) of each chunk or solve
    pivots: int = 0
    solves: int = 0
    iters: list = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0
    records: dict = dataclasses.field(default_factory=dict)
    stalled: Optional[str] = None
    traced: Optional[dict] = None
    inputs: object = None  # instance -> (A, b, c), made again from the seed
    source: object = None  # instance -> (column source, b, c), where one card never holds A whole


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def options(cell, overrides: Optional[dict] = None):
    from simplex_tpu_torch import SimplexOptions

    kw = {**cell.traffic.get("options", {}), **(overrides or {})}
    return SimplexOptions(**kw, dtype=getattr(torch, cell.config["dtype"]))


def sample_steps(seed: int, units: int, below: int, salt: int):
    """One (unit, step) pair for each of ``units`` units, the step drawn
    from the seed below ``below``."""
    g = torch.Generator().manual_seed(generate.stream_seed(seed, salt))
    steps = torch.randint(0, below, (units,), generator=g).tolist()
    return list(zip(range(units), steps))


def launches():
    from simplex_tpu_torch.kernels import hopper

    return dict(hopper.launches)


def _traced_summary(out, device, pivots: int, before: dict, rows: int, cols: int) -> dict:
    """The traced stretch's summary (``trace.summarize``) with its pivots,
    the kernels' launches in it and the (rows, cols) of A this card holds."""
    recs = trace.device_records(out["prof"], torch.device(device).type == "cuda")
    summary = trace.summarize(recs, out["wall_s"])
    after = launches()
    summary.update(pivots=pivots, launches={k: after[k] - before.get(k, 0) for k in after}, rows=rows, cols=cols)
    return summary


def _single(cell, seed, device, opts):
    """(problem, backend, fresh start state, columns held, stop rule) of
    the single-card solve."""
    from simplex_tpu_torch.core import solver
    from simplex_tpu_torch.core.state import initial_state_slack
    from simplex_tpu_torch.kernels.dispatch import get_backend

    A, b, c = generate.dense_canonical(cell.config, seed, device)
    prob = solver.build_problem(A, b, c, opts, device)

    def fresh():
        return initial_state_slack(
            prob, opts.dtype, perturb=opts.perturb_after > 0, update_defer=opts.resolve_defer(),
            multi_price=opts.multi_price, pricing=opts.pricing,
        )

    return prob, get_backend(opts.backend), fresh, cell.config["n"], lambda stop: stop


def _column_shard(cell, seed, device, opts, rank: int, size: int, group):
    """The same for one rank of the column-sharded solve
    (``simplex_tpu_torch.dist.sharded``): the rank's own columns, made on
    its card; the state of ``solve_sharded``'s start; rank 0 decides when
    the window stops and tells every rank."""
    import torch.distributed as dist

    from simplex_tpu_torch.core.state import Problem, with_pricing_shadow
    from simplex_tpu_torch.dist import sharded as shd

    cfg = cell.config
    m, n = cfg["m"], cfg["n"]
    bounds = shd.shard_bounds(n, size)
    lo, hi = int(bounds[rank]), int(bounds[rank + 1])
    A, b, c = generate.dense_canonical(cfg, seed, device, lo, hi)
    prob = with_pricing_shadow(Problem(A=A, b=b, c=c[lo:hi].contiguous()), opts.pricing_dtype, opts.pricing)
    backend = shd.make_collective_backend(group, lo, hi - lo, n=n, kernels=opts.backend, dtype=opts.dtype)
    basis0 = torch.arange(n - m, n, dtype=torch.int32, device=device)

    def fresh():
        return shd._initial_state_sharded(prob, basis0, backend, opts)

    def agree(stop: bool) -> bool:
        flag = torch.tensor([int(stop)], device=device)
        dist.broadcast(flag, src=dist.get_global_rank(group, 0), group=group)
        return bool(flag.item())

    return prob, backend, fresh, hi - lo, agree


def pivot_window(cell, seed: int, seconds: float, trace_on: bool, device, clock: Clock,
                 overrides: Optional[dict] = None, faults=None, world=None) -> Run:
    """The ``pivot_window`` generator on one device; ``world`` = (rank, size,
    group) runs this rank's part of the column-sharded loop."""
    from simplex_tpu_torch.config import pin_full_fp32
    from simplex_tpu_torch.core import solver
    from simplex_tpu_torch.status import SolveStatus

    tr, cfg = cell.traffic, cell.config
    chunk, restart = int(tr["chunk"]), int(tr["restart_after"])
    opts = options(cell, overrides)
    pin_full_fp32()
    if world is None:
        prob, backend, fresh, cols, agree = _single(cell, seed, device, opts)
    else:
        prob, backend, fresh, cols, agree = _column_shard(cell, seed, device, opts, *world)
    sync(device)
    clock.stamp("inputs made")

    if faults:
        faults.install(solver)
    rec = StepRecorder(solver, sample_steps(seed, int(tr["sample_chunks"]), chunk, 1))

    def run_chunk(s, done, unit):
        rec.start(unit, 2 * chunk + 64)
        s = solver.solve_state(prob, s, opts, done + chunk, backend)
        it, status = torch.stack([s.iters, s.status]).tolist()
        if status == SolveStatus.MAX_ITER:
            s.status = torch.full_like(s.status, int(SolveStatus.RUNNING))
        return s, it, status

    def final(s):
        return {"basis": s.basis, "x_b": s.x_b, "y": s.y, "B_inv": s.B_inv}

    run, finals = Run(), []
    try:
        with rec:
            s, _, _ = run_chunk(fresh(), 0, "warm")  # the first launches of every kernel
            s, done, finals = fresh(), 0, []
            sync(device)
            agree(True)  # every rank starts the window together
            run.setup_s = clock.stamp("warm-up chunk")
            run.setup_parts = clock.parts
            t0 = t1 = time.perf_counter()
            k = 0
            while True:
                s, it, status = run_chunk(s, done, k)
                t2 = time.perf_counter()
                run.unit_s.append((it - done, t2 - t1))
                run.pivots += it - done
                done, k, t1 = it, k + 1, t2
                if done >= restart or status != SolveStatus.MAX_ITER:
                    finals.append(final(s))
                    s, done = fresh(), 0
                if agree(time.perf_counter() - t0 >= seconds):
                    break
            sync(device)
            run.wall_s = time.perf_counter() - t0
            run.memory_peak_bytes = peak_bytes(device)
            if done > 0:
                finals.append(final(s))
            if trace_on:
                # from a fresh state: the last state's B_inv is a record now
                s = fresh()
                before = launches()
                with trace.profiled(device) as out:
                    s, it, _ = run_chunk(s, 0, "trace")
                run.traced = _traced_summary(out, device, it, before, cfg["m"], cols)
    except Stalled as e:
        run.stalled = str(e)
        finals = []
    finally:
        if faults:
            faults.remove(solver)
    run.records = {"pivots": rec.pivots, "states": finals, "solves": []}
    run.inputs = lambda instance: generate.dense_canonical(cfg, seed, device)
    return run


def solve_to_optimal(cell, seed: int, seconds: float, trace_on: bool, device, clock: Clock,
                     overrides: Optional[dict] = None, faults=None) -> Run:
    """The ``solve_to_optimal`` generator on one device."""
    from simplex_tpu_torch import solve
    from simplex_tpu_torch.core import solver

    tr, cfg = cell.traffic, cell.config
    opts = options(cell, overrides)
    pool = [generate.dense_canonical(cfg, instance_seed(tr, i), device) for i in range(int(tr["instances"]))]
    sync(device)
    clock.stamp("inputs made")
    g = torch.Generator().manual_seed(generate.stream_seed(seed, 2))
    order = torch.randperm(len(pool), generator=g).tolist()
    if faults:
        faults.install(solver)
    rec = StepRecorder(solver, sample_steps(seed, int(tr["sample_solves"]), int(tr["sample_steps_below"]), 3))
    limit = int(tr["max_steps_per_solve"])
    run, results = Run(), []
    try:
        with rec:
            rec.start("warm", limit)
            # the same LP for every seed, so that set-up does the same work
            solve(*pool[0], options=opts, device=device)
            sync(device)
            run.setup_s = clock.stamp("warm-up solve")
            run.setup_parts = clock.parts
            t0 = t1 = time.perf_counter()
            j = 0
            while True:
                i = order[j % len(pool)]
                rec.start(j, limit)
                res = solve(*pool[i], options=opts, device=device)
                t2 = time.perf_counter()
                run.unit_s.append((res.iters, t2 - t1))
                t1 = t2
                results.append({"instance": i, "result": res})
                run.iters.append(res.iters)
                j += 1
                # whole passes over the pool: every run does the same work
                if j % len(pool) == 0 and t2 - t0 >= seconds:
                    break
            sync(device)
            run.wall_s = time.perf_counter() - t0
            run.solves = j
            run.memory_peak_bytes = peak_bytes(device)
            if trace_on:
                i = order[j % len(pool)]
                rec.start("trace", limit)
                before = launches()
                with trace.profiled(device) as out:
                    res = solve(*pool[i], options=opts, device=device)
                run.traced = _traced_summary(out, device, res.iters, before, cfg["m"], cfg["n"])
    except Stalled as e:
        run.stalled = str(e)
    finally:
        if faults:
            faults.remove(solver)
    # a pivot sampled in a solve that did not finish has no result to name its LP
    pivots = [{**p, "instance": results[p["unit"]]["instance"]} for p in rec.pivots if p["unit"] < len(results)]
    run.records = {"pivots": pivots, "states": [], "solves": results}
    run.inputs = lambda instance: generate.dense_canonical(cfg, instance_seed(tr, instance), device)
    return run


def instance_seed(traffic: dict, i: int) -> int:
    """The seed of LP ``i`` of a solve_to_optimal pool: fixed by the
    traffic file, the same for every run seed, so that every run solves
    the same set of LPs (in its own order)."""
    return generate.stream_seed(int(traffic["instance_seed"]), 1000 + i)


GENERATORS = {"pivot_window": pivot_window, "solve_to_optimal": solve_to_optimal}
