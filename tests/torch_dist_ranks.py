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

import collections
import datetime
import queue
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from simplex_tpu_torch.dist.card_check import count_calls
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
    sh.reset_collectives()
    step.reset_host_reads()
    with count_calls(solver, "pivot_step") as steps:
        res = sh.solve_sharded(A, b, c, mesh, basis0=basis0, options=options, device="cpu")
    return dict(res=res, steps=steps[0], collectives=collections.Counter(sh.collectives), reads=dict(step.host_reads))


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


def pdhg_sharded(rank, world, R, A, b, c, kw):
    """``solve_pdhg_sharded`` on R ranks, with its collectives."""
    from simplex_tpu_torch.dist import sharded as sh
    from simplex_tpu_torch.fo.sharded import solve_pdhg_sharded

    mesh = _mesh(R, "cols")
    if mesh is None:
        return None
    sh.reset_collectives()
    res = solve_pdhg_sharded(A, b, c, mesh, device="cpu", **kw)
    return dict(res=res, collectives=collections.Counter(sh.collectives))


def pdhg_cert_products(rank, world, R, A, b, c, u, rays):
    """The sharded certificate's products (``fo/sharded.py`` ``_ShardCert``)
    on R ranks, each rank over its own columns of A: for each (xhat, yhat)
    in ``rays`` the primal pair, the dual pair and the polished xhat."""
    import numpy as np

    from simplex_tpu_torch.dist.sharded import shard_bounds
    from simplex_tpu_torch.fo import sharded as fs

    mesh = _mesh(R, "cols")
    if mesh is None:
        return None
    bounds = shard_bounds(A.shape[1], R)
    sh = fs._Shard(mesh.get_group("cols"), int(bounds[rank]), int(bounds[rank + 1]))
    ops = fs._ShardCert(sh, A, np.asarray(b, np.float64), -np.asarray(c, np.float64), u, "cpu")
    return [(ops.primal(x), ops.dual(y), ops.polish(x, ~np.isfinite(u))) for x, y in rays]


def pdhg_sharded_setup(rank, world, R, A, b, c, u):
    """The sharded PDHG's set-up on R ranks: the rank's scaled data (As,
    bs, cs, dr, dc, b_scale, c_scale, us, tau0, sigma0) as numpy arrays, and
    its columns [lo, hi)."""
    from simplex_tpu_torch.fo import sharded as fs

    mesh = _mesh(R, "cols")
    if mesh is None:
        return None
    sh, data, _ = fs.prepare(A, b, c, mesh, u=u, device="cpu")
    return [v.numpy() for v in data], (sh.lo, sh.hi)


def pdhg_sharded_window(rank, world, R, data, leaves, tol, check_every):
    """One window of the sharded PDHG on R ranks from a carried global
    state (the reference's 15 leaves) on the reference's scaled data
    (global As, bs, cs, dr, dc, b_scale, c_scale, us): the global state
    after it, x / sx / xr gathered."""
    import numpy as np
    import torch

    from simplex_tpu_torch.dist.sharded import shard_bounds
    from simplex_tpu_torch.fo import sharded as fs

    mesh = _mesh(R, "cols")
    if mesh is None:
        return None
    group = mesh.get_group("cols")
    n = len(data["cs"])
    bounds = shard_bounds(n, R)
    lo, hi = int(bounds[rank]), int(bounds[rank + 1])
    sh = fs._Shard(group, lo, hi)

    def t(k, cols=False):
        v = np.asarray(data[k])
        return torch.as_tensor(np.ascontiguousarray(v[..., lo:hi] if cols else v))

    state = fs.pdhg_sharded_state_from_numpy(leaves, lo, hi, "cpu")
    out = fs._window(sh, t("As", True), t("bs"), t("cs", True), t("dr"), t("dc", True), t("b_scale"),
                     t("c_scale"), t("us", True), state, tol, check_every)

    def whole(v):
        full = torch.zeros(n)
        full[lo:hi] = v
        torch.distributed.all_reduce(full, group=group)
        return full

    return {f: np.asarray((whole(v) if f in fs._SHARDED else v).numpy()) for f, v in zip(fs.STATE_LEAVES, out)}


def _mesh2(R: int, C: int):
    """The (rows R, cols C) mesh over ranks 0 .. R C - 1 (made once)."""
    from simplex_tpu_torch.dist.mesh import COLS_AXIS, ROWS_AXIS, make_mesh

    if (R, C) not in _meshes:
        _meshes[R, C] = make_mesh((ROWS_AXIS, COLS_AXIS), shape=(R, C), devices=list(range(R * C)), device="cpu")
    mesh = _meshes[R, C]
    return mesh if mesh.get_coordinate() is not None else None


def sharded2d(rank, world, R, C, A, b, c, options, basis0=None):
    """``solve_sharded_2d`` on an R x C mesh: the result, its pivot steps,
    collectives, host reads and launches."""
    from simplex_tpu_torch.core import step
    from simplex_tpu_torch.dist import sharded as sh
    from simplex_tpu_torch.dist import sharded2d as s2
    from simplex_tpu_torch.kernels import hopper

    mesh = _mesh2(R, C)
    if mesh is None:
        return None
    sh.reset_collectives()
    step.reset_host_reads()
    hopper.reset_launches()
    with count_calls(s2, "_step") as steps:
        res = s2.solve_sharded_2d(A, b, c, mesh, basis0=basis0, options=options, device="cpu")
    return dict(res=res, steps=steps[0], collectives=collections.Counter(sh.collectives), reads=dict(step.host_reads))


def sharded2d_error(rank, world, R, C, A, b, c, options):
    """The exception ``solve_sharded_2d`` raises on an R x C mesh, as
    (type, text)."""
    from simplex_tpu_torch.dist.sharded2d import solve_sharded_2d

    mesh = _mesh2(R, C)
    if mesh is None:
        return None
    try:
        solve_sharded_2d(A, b, c, mesh, options=options, device="cpu")
    except Exception as e:  # the case's point: which error, on every rank
        return type(e).__name__, str(e)
    return None


def sharded2d_chunk(rank, world, R, C, A, b, c, options, leaves, max_iter):
    """One chunk (``cont``) of the 2-D loop on an R x C mesh from a global
    state with the reference's keys: the rank's final shards, its row and
    column ranges."""
    import numpy as np

    from simplex_tpu_torch.dist import sharded2d as s2

    mesh = _mesh2(R, C)
    if mesh is None:
        return None
    cx = s2.make_context(A, b, c, mesh, options, device="cpu")
    s = s2.cont(cx, s2.state_2d_from_numpy(leaves, cx), max_iter)
    return dict(state={k: np.asarray(v.numpy()) for k, v in s.items()},
                rows=(cx.row_base, cx.row_base + cx.m_loc), cols=(cx.lo, cx.hi))


def checkpointed2d(rank, world, R, C, A, b, c, options, path, resume=True, fail_at=None):
    """``solve_sharded_2d_with_checkpoints`` on an R x C mesh; ``fail_at``
    makes that chunk call raise on every rank. Returns the result and the
    chunks' pivot counts, or the error as (type, text)."""
    from simplex_tpu_torch.dist import checkpoint2d as ck

    mesh = _mesh2(R, C)
    if mesh is None:
        return None
    chunks, calls = [], [0]
    inner = ck._run_chunk

    def run(fn, *a):
        calls[0] += 1
        if calls[0] == fail_at:
            raise RuntimeError("injected: chunk failed")
        return inner(fn, *a)

    ck._run_chunk = run
    try:
        res = ck.solve_sharded_2d_with_checkpoints(
            A, b, c, mesh, path=path, options=options, resume=resume, device="cpu",
            on_chunk=lambda s: chunks.append(int(s["iters"])),
        )
    except RuntimeError as e:
        return dict(error=str(e), chunks=chunks)
    finally:
        ck._run_chunk = inner
    return dict(res=res, chunks=chunks)

