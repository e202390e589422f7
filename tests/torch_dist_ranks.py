"""A pool of gloo CPU ranks for the port's distributed tests.

``RankPool(world)`` spawns ``world`` processes once, joins them into one
gloo process group and feeds every rank the same cases: ``pool.run(name,
*args)`` calls ``name(rank, world, *args)`` (a function of this module) on
each rank and returns the per-rank results in rank order, or raises with
every failing rank's traceback. A case for fewer ranks builds a mesh over
ranks 0 .. R-1 (all ranks take part in making it); the others return None.

This module imports torch and the port only, so the ranks start without
jax.
"""

from __future__ import annotations

import datetime
import queue
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from simplex_tpu_torch.dist.mesh import free_port

# a rank waits this long in a collective whose partner failed, then raises
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


def _serve(rank, world, port, tasks, results):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        timeout=COLLECTIVE_TIMEOUT,
    )
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            name, args = task
            try:
                out = ("ok", globals()[name](rank, world, *args))
            except Exception:
                out = ("err", traceback.format_exc())
            results.put((rank, out))
    finally:
        dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int):
        ctx = mp.get_context("spawn")
        port = free_port()
        self.world = world
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        self.procs = [
            ctx.Process(target=_serve, args=(r, world, port, self.tasks[r], self.results), daemon=True)
            for r in range(world)
        ]
        for p in self.procs:
            p.start()

    def run(self, name: str, *args, timeout: float = 240.0) -> list:
        for q in self.tasks:
            q.put((name, args))
        out, errors = [None] * self.world, []
        for _ in range(self.world):
            try:
                rank, (kind, val) = self.results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"{name}: a rank did not answer within {timeout} s") from None
            if kind == "err":
                errors.append(f"rank {rank}:\n{val}")
            out[rank] = val
        if errors:
            raise RuntimeError(f"{name} failed on {len(errors)} rank(s):\n" + "\n".join(errors))
        return out

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()


# ---- the cases, run on every rank ----------------------------------------

_meshes: dict = {}


def _mesh(R: int, axis: str):
    """The mesh over ranks 0 .. R-1 (made once; every rank takes part)."""
    from simplex_tpu_torch.dist.mesh import make_mesh

    if (R, axis) not in _meshes:
        _meshes[R, axis] = make_mesh((axis,), devices=list(range(R)), device="cpu")
    mesh = _meshes[R, axis]
    return mesh if mesh.get_coordinate() is not None else None


def sharded(rank, world, R, A, b, c, options, basis0=None):
    """``solve_sharded`` on R ranks: the result, its pivot steps, and the
    collectives and host reads of the run."""
    from simplex_tpu_torch.core import solver, step
    from simplex_tpu_torch.dist import sharded as sh

    mesh = _mesh(R, "cols")
    if mesh is None:
        return None
    steps = [0]
    inner = solver.pivot_step

    def counted(*a, **k):
        steps[0] += 1
        return inner(*a, **k)

    sh.reset_collectives()
    step.reset_host_reads()
    solver.pivot_step = counted
    try:
        res = sh.solve_sharded(A, b, c, mesh, basis0=basis0, options=options, device="cpu")
    finally:
        solver.pivot_step = inner
    return dict(res=res, steps=steps[0], collectives=dict(sh.collectives), reads=dict(step.host_reads))


def sharded_error(rank, world, R, A, b, c, options):
    """The exception ``solve_sharded`` raises on R ranks, as (type, text)."""
    from simplex_tpu_torch.dist.sharded import solve_sharded

    mesh = _mesh(R, "cols")
    if mesh is None:
        return None
    try:
        solve_sharded(A, b, c, mesh, options=options, device="cpu")
    except Exception as e:  # the case's point: which error, on every rank
        return type(e).__name__, str(e)
    return None


def sharded_warns(rank, world, R, A, b, c, options):
    """``solve_sharded``'s result and the warnings the port logged."""
    import logging

    from simplex_tpu_torch.dist.sharded import solve_sharded

    mesh = _mesh(R, "cols")
    if mesh is None:
        return None
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    log = logging.getLogger("simplex_tpu_torch")
    h = Keep(level=logging.WARNING)
    log.addHandler(h)
    try:
        res = solve_sharded(A, b, c, mesh, options=options, device="cpu")
    finally:
        log.removeHandler(h)
    return dict(res=res, warnings=seen)


def batched(rank, world, R, As, bs, cs, options):
    from simplex_tpu_torch import solve_batched

    mesh = _mesh(R, "batch")
    if mesh is None:
        return None
    return solve_batched(As, bs, cs, options=options, mesh=mesh, device="cpu")


def batched_error(rank, world, R, As, bs, cs, u):
    """The exception ``solve_batched(mesh=, u=u)`` raises on R ranks, as
    (type, text)."""
    from simplex_tpu_torch import solve_batched

    mesh = _mesh(R, "batch")
    if mesh is None:
        return None
    try:
        solve_batched(As, bs, cs, u=u, mesh=mesh, device="cpu")
    except Exception as e:  # the case's point: which error, on every rank
        return type(e).__name__, str(e)
    return None


def reoptimized(rank, world, R, A, bs, c, prev, options):
    from simplex_tpu_torch import reoptimize_batched

    mesh = _mesh(R, "batch")
    if mesh is None:
        return None
    return reoptimize_batched(A, bs, c, prev, options=options, mesh=mesh, device="cpu")
