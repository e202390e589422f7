"""The column-sharded solve on several cards of one host, against one card.

    python -m simplex_tpu_torch.dist.card_check [--ranks 4] [--m 32768 --n 131072]
        [--window 512] [--out FILE] [--device cuda] [--collectives-only]

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

The last line of standard output is one JSON record (also written to
``--out``), with every card's ``nvidia-smi`` name and power limit. Exit
code 0 only when every rank ran and the answers match.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

PROFILED_PIVOTS = 64
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


def _run(fn, barrier: bool, profiled: bool = False):
    """``fn()`` (a solve) with its seconds between synchronizes, the seconds
    of its pivot loops alone, the launch, collective, host-read and
    pivot-step counters of the call (set to 0 before it), and with
    ``profiled`` its pivot loops under ``torch.profiler``. With ``barrier``
    every rank meets at both ends of the call and of each loop. Returns
    (result, record, profile or None)."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from simplex_tpu_torch.core import solver, step
    from simplex_tpu_torch.dist import sharded
    from simplex_tpu_torch.kernels import hopper

    def meet():
        _sync()
        if barrier:
            dist.barrier()
            _sync()

    steps, loop_s, profs = [0], [0.0], []
    inner_step, inner_loop = solver.pivot_step, solver._pivot_loop

    def count(*a, **k):
        steps[0] += 1
        return inner_step(*a, **k)

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
    solver.pivot_step, solver._pivot_loop = count, loop
    try:
        meet()
        t0 = time.perf_counter()
        res = fn()
        meet()
        wall = time.perf_counter() - t0
    finally:
        solver.pivot_step, solver._pivot_loop = inner_step, inner_loop
    rec = dict(res=res, wall=wall, loop=loop_s[0], launches=dict(hopper.launches),
               collectives=dict(sharded.collectives), reads=dict(step.host_reads), steps=steps[0])
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


def _collectives_alone(m: int, dev, group) -> dict:
    """The pivot step's two collectives alone, on tensors of its shapes (two
    int64 keys under MIN, m + 1 floats under SUM): host-clock microseconds
    an iteration back to back, and paced as in the pivot loop (device work
    of ``PACED_MS`` before and after them and one host read an iteration)
    less the same paced loop without them."""
    import torch
    import torch.distributed as dist

    cuda = dev.type == "cuda"
    keys = torch.zeros(2, dtype=torch.int64, device=dev)
    col = torch.zeros(m + 1, dtype=torch.float32, device=dev)
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
                dist.all_reduce(keys, op=dist.ReduceOp.MIN, group=group)
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


def _rank(rank: int, world: int, port: int, dev_type: str, a_path: str, b, c, window: int, out) -> None:
    import traceback

    import torch
    import torch.distributed as dist

    from simplex_tpu_torch import SimplexOptions, solve, solve_sharded
    from simplex_tpu_torch.dist.mesh import COLS_AXIS, initialize_multihost, make_mesh

    cuda = dev_type == "cuda"
    initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="nccl" if cuda else "gloo")
    try:
        mesh = make_mesh(device=dev_type)
        dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
        rec = {"rank": rank, "card": torch.cuda.get_device_name(dev) if cuda else "cpu"}
        rec["collectives_alone"] = _collectives_alone(len(b), dev, mesh.get_group(COLS_AXIS))
        if a_path is None:
            out.put((rank, "ok", rec))
            return
        A = np.load(a_path, mmap_mode="r")
        opts = SimplexOptions(max_iter=window)
        short = SimplexOptions(max_iter=PROFILED_PIVOTS)
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
    args = ap.parse_args(argv)
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
                    args=(r, args.ranks, port, args.device, a_path and str(a_path), b, c, args.window, out))
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
    alone = {r: recs[r]["collectives_alone"] for r in range(args.ranks)}
    if args.collectives_only:
        return _emit({"m": args.m, "cards": cards, "collectives_alone": alone}, args.out, True)
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
    return _emit(record, args.out, agree and match)


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
