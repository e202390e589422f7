"""A cell on several cards: one process a rank, joined over NCCL.

The process that runs the benchmark is rank 0; it starts ranks 1 .. N-1
(``multiprocessing``'s spawn), each on its own card, gives them a
rendezvous on ``127.0.0.1`` and runs the cell's generator with them in
lockstep (``drive.pivot_window`` with ``world``: each rank makes and holds
its own columns). The other ranks send back their peak memory, window
counts and traced stretch, and end before rank 0 judges the replicated
answers it holds against the reference, which makes A's columns again on
rank 0's card, a block at a time. Every process started here has ended
when :func:`run` returns.
"""

from __future__ import annotations

import traceback

import torch

from benchmark import drive, generate
from benchmark.reference import simplex64

JOIN_S = 600.0


def _join(rank: int, size: int, port: int, device_type: str):
    import torch.distributed as dist

    from simplex_tpu_torch.dist.mesh import COLS_AXIS, initialize_multihost, make_mesh

    initialize_multihost(f"127.0.0.1:{port}", size, rank, backend="nccl" if device_type == "cuda" else "gloo")
    mesh = make_mesh(device=device_type)
    dev = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else torch.device("cpu")
    return dist, mesh.get_group(COLS_AXIS), dev


def _rank(rank, size, port, device_type, cell, seed, seconds, trace_on, clock, overrides, faults):
    dist, group, dev = _join(rank, size, port, device_type)
    clock.stamp("process group")
    try:
        run = drive.pivot_window(cell, seed, seconds, trace_on, dev, clock, overrides, faults,
                                 world=(rank, size, group))
    finally:
        dist.destroy_process_group()
    return run, dev


def _worker(rank, size, port, device_type, cell, seed, seconds, trace_on, overrides, faults, queue):
    """Ranks 1 .. N-1: run, then send back what rank 0 reports."""
    try:
        run, _ = _rank(rank, size, port, device_type, cell, seed, seconds, trace_on, drive.Clock(), overrides,
                       faults)
        queue.put({"rank": rank, "memory_peak_bytes": run.memory_peak_bytes, "traced": run.traced,
                   "stalled": run.stalled, "pivots": run.pivots, "setup_parts": run.setup_parts})
    except Exception:
        queue.put({"rank": rank, "error": traceback.format_exc()})


def run(cell, seed: int, seconds: float, trace_on: bool, device, clock, overrides=None, faults=None):
    """Run ``cell`` over ``cell.chips`` ranks; rank 0's :class:`drive.Run`
    with every rank's peak memory and traced stretch merged in."""
    import multiprocessing as mp

    from simplex_tpu_torch.dist.mesh import free_port

    if cell.traffic["generator"] != "pivot_window":
        raise ValueError(f"no column-sharded form of the {cell.traffic['generator']!r} generator")
    size, device_type = cell.chips, torch.device(device).type
    port = free_port()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, size, port, device_type, cell, seed, seconds, trace_on,
                                               overrides, faults, queue), daemon=True)
             for r in range(1, size)]
    for p in procs:
        p.start()
    try:
        run0, dev = _rank(0, size, port, device_type, cell, seed, seconds, trace_on, clock, overrides, faults)
        others = sorted((queue.get(timeout=JOIN_S) for _ in procs), key=lambda o: o["rank"])
    finally:
        for p in procs:
            p.join(timeout=JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
    errors = [o["error"] for o in others if "error" in o]
    if errors:
        raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    run0.memory_peak_bytes = max([run0.memory_peak_bytes] + [o["memory_peak_bytes"] for o in others])
    run0.stalled = run0.stalled or next((o["stalled"] for o in others if o["stalled"]), None)
    if run0.traced is not None:
        ranks = [run0.traced] + [o["traced"] for o in others]
        run0.traced = {"ranks": ranks, "breakdown": ranks[0]["breakdown"],
                       "busy_s": sum(t["busy_s"] for t in ranks) / len(ranks),
                       "window_s": sum(t["window_s"] for t in ranks) / len(ranks)}
    cfg = cell.config
    m, n, block = cfg["m"], cfg["n"], cfg["column_block"]
    dtype = getattr(torch, cfg["dtype"])

    def source(instance):
        cols = simplex64.ColumnSource(
            lambda lo, hi: generate.columns(m, n, lo, hi, seed, block, dev, dtype), m, n, block, dev)
        return cols, generate.rhs(m, seed, dev, dtype), generate.costs(m, n, seed, dev, dtype)

    run0.source = source
    return run0
