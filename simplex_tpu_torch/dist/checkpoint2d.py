"""Chunked 2-D sharded solves with light snapshots, and their resume.

The counterpart of ``simplex_tpu.dist.checkpoint2d``. The 2-D solve
(:mod:`~simplex_tpu_torch.dist.sharded2d`) runs in chunks of
``options.checkpoint_every`` pivots (1024 when 0); the state, the
row-sharded inverse with it, stays on the devices from one chunk to the
next. After each chunk a LIGHT snapshot (the basis and three counters, the
reference's ``.npz`` format, so that a snapshot written by either package
resumes in the other) goes to ``path``. A call that finds ``path`` resumes
from it: the inverse is rebuilt on the mesh by the distributed
Newton-Schulz (``sharded2d.resume``), whatever the basis.

The reference's retry loop (a chunk re-run after a TPU runtime's
UNAVAILABLE error, ``simplex_tpu/dist/checkpoint2d.py:166-188``) is not
ported, as in the single solve's ``solve_with_checkpoints``: a failed call
raises on every rank and keeps its last snapshot, and the next call resumes
from it. ``_run_chunk`` stays the one place a chunk is run, so that a test
can make a chunk fail.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from simplex_tpu_torch.config import DEFAULT_OPTIONS, SimplexOptions
from simplex_tpu_torch.core.checkpoint import load_light_snapshot, save_light_snapshot
from simplex_tpu_torch.core.solver import SolveResult
from simplex_tpu_torch.dist import sharded2d as _s2
from simplex_tpu_torch.logging import fields, get_logger
from simplex_tpu_torch.status import SolveStatus

__all__ = ["load_light_snapshot", "save_light_snapshot", "solve_sharded_2d_with_checkpoints"]

_log = get_logger("dist.checkpoint2d")


def _run_chunk(fn, *args):
    """Run one chunk (the indirection tests use to make a chunk fail)."""
    return fn(*args)


def _save(cx: _s2.Ctx, path: str, state: dict) -> None:
    """The light snapshot of ``state``: the whole basis (one SUM over
    "rows") and the counters, written by every rank to a file of its own
    and renamed onto ``path`` (atomic, so ranks that share a file system
    leave one whole file); then every rank waits for the others."""
    basis = _s2.basis_full(cx, state).cpu().numpy()
    tmp = f"{path}.{cx.slot}.tmp"
    save_light_snapshot(
        tmp, basis, int(state["iters"]), int(state["degen"]), int(state["status"])
    )
    os.replace(tmp, path)
    dist.barrier(group=cx.everyone)


def solve_sharded_2d_with_checkpoints(
    A,
    b,
    c,
    mesh,
    *,
    path,
    basis0=None,
    options: SimplexOptions = DEFAULT_OPTIONS,
    resume: bool = True,
    on_chunk: Optional[Callable[[dict], None]] = None,
    device=None,
) -> SolveResult:
    """:func:`~simplex_tpu_torch.dist.sharded2d.solve_sharded_2d` in chunks
    of ``options.checkpoint_every`` pivots with a light snapshot at
    ``path`` after each; with ``resume`` and an existing ``path`` the solve
    continues from it. ``on_chunk(state)`` (the rank's state dict) runs
    after each snapshot. Every rank of ``mesh`` calls it with the same
    arguments and returns the same result."""
    cx = _s2.make_context(A, b, c, mesh, options, device)
    m, n = cx.m, cx.n
    b, c = (np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for v in (b, c))
    chunk = options.checkpoint_every if options.checkpoint_every > 0 else 1024
    max_iter = cx.opts.resolve_max_iter(m, n)
    path = os.fspath(path)
    basis0 = np.arange(n - m, n) if basis0 is None else np.asarray(basis0)
    if resume and os.path.exists(path):
        snap_basis, snap_iters, snap_degen = load_light_snapshot(path, m, n)
        mode = "resume"
    else:
        mode, snap_iters = "start", 0

    state = None
    while True:
        cur = snap_iters if state is None else int(state["iters"])
        limit = min(cur + chunk, max_iter)
        if mode == "start":
            state = _run_chunk(_s2.start, cx, basis0, limit)
        elif mode == "resume":
            state = _run_chunk(_s2.resume, cx, snap_basis, snap_iters, snap_degen, limit)
        else:  # the previous chunk's state goes on as it is
            state["status"] = torch.full_like(state["status"], int(SolveStatus.RUNNING))
            state = _run_chunk(_s2.cont, cx, state, limit)
        mode = "cont"
        status = SolveStatus(int(state["status"]))
        _save(cx, path, state)
        _log.info("2-D chunk complete", extra=fields(iters=int(state["iters"]), status=status.name))
        if on_chunk is not None:
            on_chunk(state)
        # MAX_ITER at a chunk's end means: go on
        if status != SolveStatus.MAX_ITER or int(state["iters"]) >= max_iter:
            break
    return _s2.result(cx, state, b, c)
