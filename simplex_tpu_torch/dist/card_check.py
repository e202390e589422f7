"""The distributed modes on several cards of one host, against one card.

    python -m simplex_tpu_torch.dist.card_check [--mode 1d|2d|pdhg] [--rows 2]
        [--ranks 4] [--m 32768 --n 131072] [--window 512] [--out FILE]
        [--device cuda] [--collectives-only] [--dtype float32|float64]

Needs ``--ranks`` CUDA cards (``--device cpu`` rehearses the run on gloo CPU
ranks at a small size: no device numbers). It builds the kernels, writes
``random_dense_lp(m, n, seed=0)`` once into a ``np.memmap`` (under
``/dev/shm`` when it has room, else under ``build/card_check/``) that
every rank opens as the full A, and starts one process a card, joined over
NCCL. The ranks then run

  0. the pivot step's two collectives alone on tensors of its shapes, back
     to back and paced as in the pivot loop (``--collectives-only`` stops
     here, and writes no instance);
  1. ``solve_sharded`` over the first ``--window`` pivots (the bench's
     512-pivot window), timed on the host clock between barriers, the
     whole call and its pivot loop alone (set-up, the load of the rank's
     columns and the polish left out): pivots/s, the kernels' launches,
     the collectives and the host reads a pivot step;
  2. the same solve over a shorter stretch with its pivot loop under
     ``torch.profiler``: the device time a pivot of the NCCL kernels (the
     collectives, waits for the other ranks included) and of all kernels,
     on every rank's card;
  3. on rank 0 alone (the others wait), the single-card ``solve`` of the
     whole matrix over the same window, timed and profiled the same way:
     pivots/s on one card, and its status, pivots, basis and z, which the
     sharded solve must equal.

``--mode 2d --rows R`` runs the 2-D solve (``dist/sharded2d.py``) on an
(R, ranks / R) mesh first, over the same window and profiled the same way
(its pivot loop alone between barriers: pivots/s, the device time and the
NCCL kernels' time a step on every card, its collectives a step), then
steps 1-3 as above, so that the record holds the 2-D loop beside the 1-D
loop over the same ranks and one card. ``--mode pdhg`` runs
``--window`` PDHG iterations (windows of 128, tolerance 0 so that none
stops early) of the column-sharded PDHG (``fo/sharded.py``) over the ranks,
then on rank 0's card alone of the same scheme at world size 1 and of
``solve_pdhg``, the iterations alone timed between barriers (set-up out),
and one window of each under the profiler: iterations/s, device and NCCL
time an iteration; then ``solve_pdhg_sharded`` itself over the ranks to
MAX_ITER, whose exit certifies from the shards.

``--dtype float64`` runs the simplex modes in float64 (each rank moves its
columns to the card as doubles: 8 GiB a rank at the default size, B_inv
8 GiB more in the 1-D mode; the collectives alone take the float64 keys,
an all-gather of (key, index) pairs, and a SUM of doubles). The last line
of standard output is one JSON record (also written to ``--out``), with
the dtype and every card's ``nvidia-smi`` name and power limit. Exit
code 0 only when every rank ran and the answers match: the 1-D window the
single solve's; the 2-D window on every rank the same basis and z, all its
pivots taken, the single solve's basis and its z within ``TWO_D_Z_TOL``;
sharded PDHG's replicated state the same on every rank, its KKT errors
within ``PDHG_WORLD1_TOL`` of the world-1 run's, and the entry's run
MAX_ITER with the same z on every rank.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

PROFILED_PIVOTS = 64
# the 2-D window's z against the single solve's on the same basis: each
# polishes it in f64, the 2-D solve preconditioned by its row-sharded inverse
TWO_D_Z_TOL = 1e-9
COLLECTIVE_ITERS = 200
# device milliseconds of a four-card pivot step at 32768 x 131072 before
# its two collectives (the shard's pricing pass) and after them (the ftran
# and the rank-1 update): the pacing of the collectives measured alone
PACED_MS = (1.5, 4.3)


def dense_lp_memmap(m: int, n: int, seed: int, directory: Path):
    """``random_dense_lp(m, n, seed)`` with A written row block by row
    block into ``directory/A.npy`` (a float32 ``.npy`` to open as a memmap)
    from the same random stream, so that no float64 copy of A is ever held.
    Returns the A path, b and c."""
    if n <= m:
        raise ValueError(f"need n > m, got m={m} n={n}")
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / "A.npy"
    A = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32, shape=(m, n))
    rng = np.random.default_rng(seed)
    k = n - m
    rows = max(1, (1 << 26) // k)
    for r0 in range(0, m, rows):
        r1 = min(m, r0 + rows)
        A[r0:r1, :k] = rng.uniform(0.1, 1.0, size=(r1 - r0, k))
        A[r0:r1, k:] = 0.0
        A[np.arange(r0, r1), k + np.arange(r0, r1)] = 1.0
    A.flush()
    del A
    b = rng.uniform(1.0, 2.0, size=m).astype(np.float32)
    c = np.concatenate([rng.uniform(0.1, 1.0, size=k), np.zeros(m)]).astype(np.float32)
    return path, b, c


def _work_dir(nbytes: int) -> Path:
    shm = Path("/dev/shm")
    if shm.is_dir() and shutil.disk_usage(shm).free > 1.2 * nbytes:
        return shm / f"simplex_card_check_{os.getpid()}"
    return Path(__file__).resolve().parents[2] / "build" / "card_check"


def _sync() -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def count_calls(mod, name: str):
    """Calls of ``mod.name`` (a solver's pivot step) counted while the
    block runs; yields a one-item list holding the count."""
    inner, calls = getattr(mod, name), [0]

    def counted(*a, **k):
        calls[0] += 1
        return inner(*a, **k)

    setattr(mod, name, counted)
    try:
        yield calls
    finally:
        setattr(mod, name, inner)


def _run(fn, barrier: bool, profiled: bool = False, two_d: bool = False):
    """``fn()`` (a solve) with its seconds between synchronizes, the seconds
    of its pivot loops alone, the launch, collective, host-read and
    pivot-step counters of the call (set to 0 before it), and with
    ``profiled`` its pivot loops under ``torch.profiler``. With ``barrier``
    every rank meets at both ends of the call and of each loop. ``two_d``:
    the loop and step of ``dist/sharded2d.py``, else of ``core/solver.py``.
    Returns (result, record, profile or None)."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from simplex_tpu_torch.core import solver, step
    from simplex_tpu_torch.dist import sharded, sharded2d
    from simplex_tpu_torch.kernels import hopper

    mod, step_name, loop_name = (sharded2d, "_step", "_loop") if two_d else (solver, "pivot_step", "_pivot_loop")

    def meet():
        _sync()
        if barrier:
            dist.barrier()
            _sync()

    loop_s, profs = [0.0], []
    inner_loop = getattr(mod, loop_name)

    def loop(*a, **k):
        meet()
        t0 = time.perf_counter()
        if profiled:
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_initialized() else [])
            with profile(activities=acts) as prof:
                out = inner_loop(*a, **k)
                _sync()
            profs.append(prof)
        else:
            out = inner_loop(*a, **k)
        meet()
        loop_s[0] += time.perf_counter() - t0
        return out

    hopper.reset_launches()
    step.reset_host_reads()
    sharded.reset_collectives()
    setattr(mod, loop_name, loop)
    try:
        with count_calls(mod, step_name) as steps:
            meet()
            t0 = time.perf_counter()
            res = fn()
            meet()
            wall = time.perf_counter() - t0
    finally:
        setattr(mod, loop_name, inner_loop)
    rec = dict(res=res, wall=wall, loop=loop_s[0], launches=dict(hopper.launches),
               collectives=collections.Counter(sharded.collectives), reads=dict(step.host_reads), steps=steps[0])
    return res, rec, (profs[0] if profs else None)


def _device_us(prof, steps: int, cuda: bool) -> dict:
    """Device microseconds and operations a pivot step from a profiled
    pivot loop: the NCCL kernels (the collectives), and every device
    operation (CPU ops in a rehearsal). The profiler's ``nccl:`` ranges,
    which span those kernels, are not operations of their own."""
    import torch

    dev_us, n_ops = collections.Counter(), 0
    for evt in prof.key_averages():
        if cuda and evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if evt.key.startswith("nccl:"):
            continue
        t = getattr(evt, "self_device_time_total", None)
        dev_us[evt.key[:90]] += evt.self_cuda_time_total if t is None else t
        n_ops += evt.count
    nccl = sum(v for k, v in dev_us.items() if "nccl" in k.lower())
    return {"collectives_us": nccl / steps, "device_us": sum(dev_us.values()) / steps,
            "device_ops": n_ops / steps,
            "top_us": {k: round(v / steps, 2) for k, v in dev_us.most_common(6)}}


def _collectives_alone(m: int, dev, group, dtype=None) -> dict:
    """The pivot step's two collectives alone, on tensors of its shapes (two
    keys under the MIN of ``dtype``'s keys, ``dist.sharded.key_codec``, and
    m + 1 ``dtype`` values under SUM; default float32): host-clock microseconds
    an iteration back to back, and paced as in the pivot loop (device work
    of ``PACED_MS`` before and after them and one host read an iteration)
    less the same paced loop without them."""
    import torch
    import torch.distributed as dist

    from simplex_tpu_torch.dist.sharded import key_codec

    dtype = dtype or torch.float32
    cuda = dev.type == "cuda"
    codec = key_codec(dtype)
    keys = codec.pack(torch.zeros(2, dtype=dtype, device=dev), 0)
    col = torch.zeros(m + 1, dtype=dtype, device=dev)
    per_ms = 0.0
    if cuda:
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        t0.record()
        torch.cuda._sleep(20_000_000)
        t1.record()
        t1.synchronize()
        per_ms = 20_000_000 / t0.elapsed_time(t1)  # sleep cycles a millisecond

    def work(ms):
        if cuda:
            torch.cuda._sleep(int(ms * per_ms))

    def loop(collect: bool, paced: bool) -> float:
        def once():
            if paced:
                work(PACED_MS[0])
            if collect:
                codec.reduce(keys, group, "alone")
                dist.all_reduce(col, op=dist.ReduceOp.SUM, group=group)
            if paced:
                work(PACED_MS[1])
                keys.tolist()

        for _ in range(10):
            once()
        _sync()
        dist.barrier(group=group)
        _sync()
        t0 = time.perf_counter()
        for _ in range(COLLECTIVE_ITERS):
            once()
        _sync()
        return 1e6 * (time.perf_counter() - t0) / COLLECTIVE_ITERS

    back = loop(True, False)
    paced, idle = loop(True, True), loop(False, True)
    return {"back_to_back_us": back, "paced_us": paced - idle, "paced_loop_us": paced,
            "paced_without_us": idle}


PDHG_WINDOW = 128  # iterations a PDHG check window
# the four-rank state's KKT errors (relative residuals and gap) after the
# timed windows against the world-1 run of the same scheme: the ranks split
# each A x into partial sums, so the iterates part in the last bits
PDHG_WORLD1_TOL = 1e-3
PDHG_MAX_ITER = 256  # solve_pdhg_sharded to MAX_ITER: its exit certificate on the shards


def _pdhg_agree(state, group) -> bool:
    """Whether every rank holds the same replicated leaves of a sharded PDHG
    state (y, sy, yr and the scalars): one MAX and one MIN over ``group``."""
    import torch
    import torch.distributed as dist

    from simplex_tpu_torch.fo import sharded as fs

    v = torch.cat([state[i].double().reshape(-1) for i, f in enumerate(fs.STATE_LEAVES) if f not in fs._SHARDED])
    hi, lo = v.clone(), v.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    return bool(torch.equal(hi, lo))


def _pdhg_runs(A, b, c, mesh, dev, rank: int, iters: int, cuda: bool) -> dict:
    """``iters`` iterations of the sharded PDHG over the ranks, then on
    rank 0 alone the same scheme at world size 1 and the single card's
    ``solve_pdhg`` (the others wait): seconds of the iterations alone
    (between barriers, set-up out), iterations/s, one window of each under
    the profiler, whether the ranks' states agree and the four-rank KKT
    errors against the world-1 run's; last ``solve_pdhg_sharded`` itself
    to MAX_ITER over the ranks, whose exit certifies from the shards (its
    seconds, status and the host memory its certificate took)."""
    import tracemalloc

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from simplex_tpu_torch.dist import sharded
    from simplex_tpu_torch.fo import pdhg
    from simplex_tpu_torch.fo import sharded as fs

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    rec = {}
    windows = iters // PDHG_WINDOW

    def timed(run_window, state, barrier=True):
        _sync()
        if barrier:
            dist.barrier()
        _sync()
        t0 = time.perf_counter()
        for _ in range(windows):
            state = run_window(state)
        _sync()
        if barrier:
            dist.barrier()
        secs = time.perf_counter() - t0
        with profile(activities=acts) as prof:
            run_window(state)
            _sync()
        return state, secs, prof

    def sharded_windows(sh, data, barrier=True):
        As, bs, cs, dr, dc, b_scale, c_scale, us, tau0, sigma0 = data
        state = fs._initial_state(len(b), sh.hi - sh.lo, dev, tau0, sigma0)
        return timed(lambda st: fs._window(sh, As, bs, cs, dr, dc, b_scale, c_scale, us, st, 0.0, PDHG_WINDOW),
                     state, barrier)

    def kkt(state):
        return [float(state[i]) for i in (6, 7, 8)]  # rp, rd, gp

    def free():
        if cuda:
            torch.cuda.empty_cache()

    group = mesh.get_group()
    one_rank = dist.new_group([0])  # every rank takes part in making it
    sh, data, _ = fs.prepare(A, b, c, mesh, device=dev)
    sharded.reset_collectives()
    state, secs, prof = sharded_windows(sh, data)
    rec["sharded"] = {"seconds": secs, "iterations_per_s": iters / secs,
                      "collectives": {k: v for k, v in sharded.collectives.items() if v},
                      "profile": _device_us(prof, PDHG_WINDOW, cuda), "kkt": kkt(state),
                      "ranks_agree": _pdhg_agree(state, group)}
    del sh, data, state
    free()
    if rank == 0:
        sh, data, _ = fs.prepare_on(A, b, c, one_rank, device=dev)
        state, secs, _ = sharded_windows(sh, data, barrier=False)
        rec["world1"] = {"seconds": secs, "iterations_per_s": iters / secs, "kkt": kkt(state)}
        del sh, data, state
        free()
        A_d = pdhg._as_device_A(A, torch.float32, dev)
        b_t = torch.as_tensor(b, device=dev).float()
        cmin = -torch.as_tensor(c, device=dev).float()
        As, dr, dc, bs, cs, tau0, sigma0, b_scale, c_scale = pdhg._pdhg_setup(A_d, b_t, cmin, torch.float32)
        del A_d
        us = torch.full_like(cs, float("inf"))
        state = pdhg._initial_state(len(b), len(c), torch.float32, dev, tau0, sigma0)
        state, secs, prof = timed(
            lambda st: pdhg._pdhg_window(As, bs, cs, dr, dc, b_scale, c_scale, us, st, 0.0, PDHG_WINDOW, True),
            state, barrier=False)
        rec["single"] = {"seconds": secs, "iterations_per_s": iters / secs,
                         "profile": _device_us(prof, PDHG_WINDOW, cuda)}
        del As, state
        free()
    dist.barrier()
    # the whole entry to MAX_ITER: the exit's certificate runs on each
    # rank's own columns; its host allocations traced alone
    inner, cert_peak = fs.finish, [0]

    def traced(*a, **k):
        tracemalloc.start()
        try:
            return inner(*a, **k)
        finally:
            cert_peak[0] = tracemalloc.get_traced_memory()[1]
            tracemalloc.stop()

    fs.finish = traced
    try:
        _sync()
        t0 = time.perf_counter()
        res = fs.solve_pdhg_sharded(A, b, c, mesh, tol=0.0, max_iter=PDHG_MAX_ITER, device=dev)
        _sync()
        wall = time.perf_counter() - t0
    finally:
        fs.finish = inner
    rec["max_iter"] = {"status": res.status.name, "iters": res.iters, "z": res.z, "seconds": wall,
                       "kkt": [res.primal_res, res.dual_res, res.gap], "certificate_host_peak_bytes": cert_peak[0]}
    free()
    dist.barrier()
    return rec


def _rank(rank: int, world: int, port: int, dev_type: str, a_path: str, b, c, window: int, mode: str,
          rows: int, dtype: str, out) -> None:
    import traceback

    import torch
    import torch.distributed as dist

    from simplex_tpu_torch import SimplexOptions, solve, solve_sharded
    from simplex_tpu_torch.dist.mesh import COLS_AXIS, ROWS_AXIS, initialize_multihost, make_mesh
    from simplex_tpu_torch.dist.sharded2d import solve_sharded_2d

    cuda = dev_type == "cuda"
    initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="nccl" if cuda else "gloo")
    try:
        mesh = make_mesh(device=dev_type)
        dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
        rec = {"rank": rank, "card": torch.cuda.get_device_name(dev) if cuda else "cpu"}
        dt = getattr(torch, dtype)
        if mode != "pdhg":
            rec["collectives_alone"] = _collectives_alone(len(b), dev, mesh.get_group(COLS_AXIS), dt)
        if a_path is None:
            out.put((rank, "ok", rec))
            return
        A = np.load(a_path, mmap_mode="r")
        if mode == "pdhg":
            rec["pdhg"] = _pdhg_runs(A, b, c, mesh, dev, rank, window, cuda)
            out.put((rank, "ok", rec))
            return
        opts = SimplexOptions(max_iter=window, dtype=dt)
        short = SimplexOptions(max_iter=PROFILED_PIVOTS, dtype=dt)
        if mode == "2d":
            mesh2 = make_mesh((ROWS_AXIS, COLS_AXIS), shape=(rows, world // rows), device=dev_type)
            _, rec["two_d"], _ = _run(
                lambda: solve_sharded_2d(A, b, c, mesh2, options=opts), barrier=True, two_d=True)
            _, short_rec, prof = _run(
                lambda: solve_sharded_2d(A, b, c, mesh2, options=short), barrier=True, profiled=True, two_d=True)
            rec["two_d_profile"] = _device_us(prof, short_rec["steps"], cuda)
            if cuda:
                torch.cuda.empty_cache()
        _, rec["sharded"], _ = _run(lambda: solve_sharded(A, b, c, mesh, options=opts), barrier=True)
        _, short_rec, prof = _run(
            lambda: solve_sharded(A, b, c, mesh, options=short), barrier=True, profiled=True)
        rec["profile"] = _device_us(prof, short_rec["steps"], cuda)
        if cuda:
            torch.cuda.empty_cache()
        if rank == 0:
            _, rec["single"], _ = _run(lambda: solve(A, b, c, options=opts, device=dev), barrier=False)
            _, short_rec, prof = _run(
                lambda: solve(A, b, c, options=short, device=dev), barrier=False, profiled=True)
            rec["single_profile"] = _device_us(prof, short_rec["steps"], cuda)
        dist.barrier()
        out.put((rank, "ok", rec))
    except Exception:
        out.put((rank, "err", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--m", type=int, default=32768)
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--window", type=int, default=512)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--collectives-only", action="store_true",
                    help="only the two collectives alone, at the instance's m (no LP)")
    ap.add_argument("--mode", choices=["1d", "2d", "pdhg"], default="1d",
                    help="1d: the column-sharded solve; 2d: the 2-D solve first, then the 1-D one; "
                         "pdhg: the column-sharded PDHG against one card's")
    ap.add_argument("--rows", type=int, default=2, help="the 2-D mesh's rows axis (--mode 2d)")
    ap.add_argument("--dtype", choices=["float32", "float64"], default="float32",
                    help="the simplex modes' working dtype (PDHG runs in float32 either way)")
    args = ap.parse_args(argv)
    if args.mode == "2d" and (args.ranks % args.rows or args.m % args.rows):
        print(f"card_check: --rows {args.rows} must divide --ranks and --m", file=sys.stderr)
        return 1
    import torch
    import torch.multiprocessing as mp

    from simplex_tpu_torch.bench.profile_general import card_line
    from simplex_tpu_torch.dist.mesh import free_port
    from simplex_tpu_torch.kernels import _build

    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            print(f"card_check: want {args.ranks} CUDA cards, have {torch.cuda.device_count()}", file=sys.stderr)
            return 1
        cards = card_line().splitlines()
        _build.build()
    else:
        cards = ["cpu (a rehearsal: no device numbers)"]
    print("cards:", "; ".join(cards), flush=True)
    t0 = time.perf_counter()
    work = _work_dir(4 * args.m * args.n)
    if args.collectives_only:
        a_path, b, c = None, np.zeros(args.m, np.float32), None
    else:
        a_path, b, c = dense_lp_memmap(args.m, args.n, 0, work)
        print(f"random_dense_lp({args.m}, {args.n}, seed=0) into {a_path} in {time.perf_counter() - t0:.1f} s",
              flush=True)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [
        ctx.Process(target=_rank,
                    args=(r, args.ranks, port, args.device, a_path and str(a_path), b, c, args.window, args.mode,
                          args.rows, args.dtype, out))
        for r in range(args.ranks)
    ]
    for p in procs:
        p.start()
    recs, errors = {}, []
    try:
        for _ in procs:
            rank, kind, val = out.get(timeout=1800)
            if kind == "ok":
                recs[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
        shutil.rmtree(work, ignore_errors=True)
    if errors:
        print("\n".join(errors), file=sys.stderr)
        return 1
    if args.mode == "pdhg":
        pd = {r: recs[r]["pdhg"] for r in range(args.ranks)}
        mx = {r: pd[r]["max_iter"] for r in pd}
        kkt_diff = max(abs(p - q) for p, q in zip(pd[0]["sharded"]["kkt"], pd[0]["world1"]["kkt"]))
        record = {
            "instance": f"random_dense_lp({args.m}, {args.n}, seed=0)", "mode": "pdhg", "cards": cards,
            "iterations": args.window, "window": PDHG_WINDOW,
            "ranks_agree": all(pd[r]["sharded"]["ranks_agree"] for r in pd),
            "sharded_iterations_per_s": pd[0]["sharded"]["iterations_per_s"],
            "world1_iterations_per_s": pd[0]["world1"]["iterations_per_s"],
            "single_card_iterations_per_s": pd[0]["single"]["iterations_per_s"],
            "sharded_seconds": {r: pd[r]["sharded"]["seconds"] for r in pd},
            "single_card_seconds": pd[0]["single"]["seconds"],
            "sharded_kkt": pd[0]["sharded"]["kkt"], "world1_kkt": pd[0]["world1"]["kkt"],
            "kkt_diff_from_world1": kkt_diff, "kkt_tol": PDHG_WORLD1_TOL,
            "sharded_collectives": pd[0]["sharded"]["collectives"],
            "device_us_per_iteration": {r: pd[r]["sharded"]["profile"] for r in pd},
            "single_card_device_us_per_iteration": pd[0]["single"]["profile"],
            "max_iter_run": mx[0],
            "max_iter_certificate_host_peak_bytes": {r: mx[r]["certificate_host_peak_bytes"] for r in mx},
        }
        ok = (record["ranks_agree"] and kkt_diff <= PDHG_WORLD1_TOL and mx[0]["status"] == "MAX_ITER"
              and mx[0]["iters"] == PDHG_MAX_ITER and all(mx[r]["z"] == mx[0]["z"] for r in mx))
        return _emit(record, args.out, ok)
    alone = {r: recs[r]["collectives_alone"] for r in range(args.ranks)}
    if args.collectives_only:
        return _emit({"m": args.m, "dtype": args.dtype, "cards": cards, "collectives_alone": alone}, args.out, True)
    sh = [recs[r]["sharded"] for r in range(args.ranks)]
    one = recs[0]["single"]
    res, ref = sh[0]["res"], one["res"]
    agree = all(s["res"].z == res.z and np.array_equal(s["res"].basis, res.basis) for s in sh)
    match = (
        res.status == ref.status and res.iters == ref.iters
        and np.array_equal(res.basis, ref.basis) and res.z == ref.z
    )
    k = sh[0]["steps"]
    record = {
        "instance": f"random_dense_lp({args.m}, {args.n}, seed=0)",
        "dtype": args.dtype,
        "window": args.window,
        "cards": cards,
        "ranks_agree": bool(agree),
        "matches_single_card": bool(match),
        "status": res.status.name, "pivots": int(res.iters), "z": res.z, "single_z": ref.z,
        "sharded_pivots_per_s": res.iters / sh[0]["loop"],
        "single_card_pivots_per_s": ref.iters / one["loop"],
        "sharded_loop_s": sh[0]["loop"], "single_card_loop_s": one["loop"],
        "sharded_wall_s": sh[0]["wall"], "single_card_wall_s": one["wall"],
        "sharded_launches_per_step": {n_: v / k for n_, v in sh[0]["launches"].items() if v},
        "sharded_collectives_per_step": {n_: v / k for n_, v in sh[0]["collectives"].items() if v},
        "sharded_reads": sh[0]["reads"], "single_reads": one["reads"],
        "profiled_pivots": PROFILED_PIVOTS,
        "device_us_per_step": {r: recs[r]["profile"] for r in range(args.ranks)},
        "single_card_device_us_per_step": recs[0]["single_profile"],
        "collectives_alone": alone,
    }
    ok = agree and match
    if args.mode == "2d":
        td = [recs[r]["two_d"] for r in range(args.ranks)]
        r2, k2 = td[0]["res"], td[0]["steps"]
        agree2 = all(t["res"].z == r2.z and np.array_equal(t["res"].basis, r2.basis) for t in td)
        record.update({
            "mode": "2d", "mesh": [args.rows, args.ranks // args.rows],
            "two_d_ranks_agree": bool(agree2),
            "two_d_status": r2.status.name, "two_d_pivots": int(r2.iters), "two_d_z": r2.z,
            "two_d_matches_single_card": bool(
                r2.iters == ref.iters and np.array_equal(r2.basis, ref.basis)
                and abs(r2.z - ref.z) <= TWO_D_Z_TOL * max(1.0, abs(ref.z))),
            "two_d_z_diff": abs(r2.z - ref.z),
            "two_d_pivots_per_s": r2.iters / td[0]["loop"], "two_d_loop_s": td[0]["loop"],
            "two_d_wall_s": td[0]["wall"],
            "two_d_launches_per_step": {n_: v / k2 for n_, v in td[0]["launches"].items() if v},
            "two_d_collectives_per_step": {n_: v / k2 for n_, v in td[0]["collectives"].items() if v},
            "two_d_reads": td[0]["reads"],
            "two_d_device_us_per_step": {r: recs[r]["two_d_profile"] for r in range(args.ranks)},
        })
        ok = ok and agree2 and r2.iters == args.window and record["two_d_matches_single_card"]
    return _emit(record, args.out, ok)


def _emit(record: dict, out, ok: bool) -> int:
    """Print the record as the last line (and write it to ``out``); the
    exit code."""
    line = json.dumps(record)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
