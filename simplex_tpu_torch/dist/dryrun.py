"""Every distributed mode of the port to OPTIMAL against HiGHS, over N ranks.

    python -m simplex_tpu_torch.dist.dryrun --ranks 4 [--device cpu]

The counterpart of the reference's ``dryrun_multichip``
(``__graft_entry__.py:58-260``): one process a rank, joined over NCCL with
a card each (gloo on the CPU, or when there are more ranks than cards and
they share them: NCCL refuses a card twice), then on tiny instances

  1. the column-sharded solve, dense and sparse (scipy CSC);
  2. the batched solve split over the ranks (2N copies of one LP);
  3. warm serving: 2N rhs scenarios re-solved from the cold basis by
     ``reoptimize_batched`` over the ranks, each against HiGHS;
  4. for an even N, the 2-D solve on a (2, N / 2) mesh under the flagship
     recipe (bf16 shadow, segments, deferred updates, refactorization,
     multiple pricing), dense and sparse, and its chunked solve stopped
     halfway along the default path (the reference stops after 8 pivots,
     which a (2, 2) mesh's 16 x 32 instance does not reach) and resumed
     from the light snapshot;
  5. column-sharded PDHG, dense and sparse, to 1e-5 (gap 1e-3).

Each answer must be OPTIMAL within 1e-4 of HiGHS (PDHG 1e-3). Rank 0
prints the reference's one-line summary last; the exit code is 0 only when
every rank passed.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import traceback

import numpy as np

GAP = 1e-4  # fp32 on tiny LPs against HiGHS in f64
PDHG_GAP = 1e-3


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def run_modes(N: int, device: str) -> str:
    """The dryrun's modes on this rank (every rank of the process group
    calls it); returns the summary line."""
    import scipy.sparse as sps
    import torch

    from simplex_tpu_torch import SimplexOptions, SolveStatus, reoptimize_batched, solve, solve_batched
    from simplex_tpu_torch.dist.checkpoint2d import solve_sharded_2d_with_checkpoints
    from simplex_tpu_torch.dist.mesh import BATCH_AXIS, COLS_AXIS, ROWS_AXIS, make_mesh
    from simplex_tpu_torch.dist.sharded import solve_sharded
    from simplex_tpu_torch.dist.sharded2d import solve_sharded_2d
    from simplex_tpu_torch.fo.sharded import solve_pdhg_sharded
    from simplex_tpu_torch.oracle.generator import random_dense_lp
    from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy

    OPT = SolveStatus.OPTIMAL
    mesh = make_mesh((COLS_AXIS,), device=device)
    bmesh = make_mesh((BATCH_AXIS,), device=device)
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device("cpu")
    opts = SimplexOptions()

    m, n = 8, 8 * N
    A, b, c = random_dense_lp(m, n, seed=0, dtype=np.float32)
    ref = solve_scipy(A, b, c)
    _check(ref.status == OPT, f"HiGHS: {ref.status!r}")
    res = solve_sharded(A, b, c, mesh, options=opts, device=dev)
    gap1 = relative_gap(res.z, ref.z)
    _check(res.status == OPT and gap1 < GAP, f"1-D sharded: {res.status!r}, z {res.z} vs {ref.z}")
    ress = solve_sharded(sps.csc_matrix(A), b, c, mesh, options=opts, device=dev)
    gap1s = relative_gap(ress.z, ref.z)
    _check(ress.status == OPT and gap1s < GAP, f"sparse 1-D sharded: {ress.status!r}, z {ress.z} vs {ref.z}")

    B = 2 * N
    bres = solve_batched(np.stack([A] * B), np.stack([b] * B), np.stack([c] * B), options=opts, mesh=bmesh,
                         device=dev)
    _check(all(int(s) == int(OPT) for s in bres.status), f"batched statuses {bres.status}")
    gapb = max(relative_gap(float(z), ref.z) for z in bres.z)
    _check(gapb < GAP, f"batched objectives off: {bres.z} vs {ref.z}")

    cold = solve(A, b, c, options=opts, device=dev)
    _check(cold.status == OPT, f"cold solve: {cold.status!r}")
    rng = np.random.default_rng(3)
    bsw = (np.asarray(b, np.float64)[None, :] * (1 + 0.1 * rng.uniform(-1, 1, (B, m)))).astype(np.float32)
    wres = reoptimize_batched(A, bsw, c, cold, options=opts, mesh=bmesh, device=dev)
    gapw = 0.0
    for i in range(B):
        refw = solve_scipy(A, bsw[i], c)
        _check(int(wres.status[i]) == int(refw.status), f"warm scenario {i}: {wres.status[i]} vs {refw.status!r}")
        if refw.status == OPT:
            gapw = max(gapw, relative_gap(float(wres.z[i]), refw.z))
    _check(gapw < GAP, f"warm scenario objectives off: {gapw}")

    two_d = ""
    if N >= 2 and N % 2 == 0:
        R, C = 2, N // 2
        mesh2 = make_mesh((ROWS_AXIS, COLS_AXIS), shape=(R, C), device=device)
        # 8 structural columns a rank beside the slacks (the reference's
        # 8 R C columns leave none at N = 2)
        m2, n2 = 8 * R, 8 * R + 8 * R * C
        A2, b2, c2 = random_dense_lp(m2, n2, seed=1, dtype=np.float32)
        ref2 = solve_scipy(A2, b2, c2)
        _check(ref2.status == OPT, f"HiGHS 2-D: {ref2.status!r}")
        opts2d = SimplexOptions(
            pricing_dtype="bfloat16", update_defer=4, partial_pricing=2, partial_min_segment=2,
            refactor_every=16, multi_price=4,
        )
        res2d = solve_sharded_2d(A2, b2, c2, mesh2, options=opts2d, device=dev)
        gap2 = relative_gap(res2d.z, ref2.z)
        _check(res2d.status == OPT and gap2 < GAP, f"2-D: {res2d.status!r}, z {res2d.z} vs {ref2.z}")
        res2s = solve_sharded_2d(sps.csc_matrix(A2), b2, c2, mesh2, options=opts2d, device=dev)
        gap2s = relative_gap(res2s.z, ref2.z)
        _check(res2s.status == OPT and gap2s < GAP, f"sparse 2-D: {res2s.status!r}, z {res2s.z} vs {ref2.z}")
        # every rank needs the same path: rank 0 makes the directory
        obj = [tempfile.mkdtemp(prefix="simplex_dryrun_") if torch.distributed.get_rank() == 0 else None]
        torch.distributed.broadcast_object_list(obj, src=0)
        ckpt = f"{obj[0]}/c2d.npz"
        # stopped halfway along the default path, in chunks of a quarter
        half = solve_sharded_2d(A2, b2, c2, mesh2, device=dev).iters // 2
        part = solve_sharded_2d_with_checkpoints(
            A2, b2, c2, mesh2, path=ckpt, options=SimplexOptions(checkpoint_every=max(1, half // 2), max_iter=half),
            device=dev)
        _check(part.status == SolveStatus.MAX_ITER, f"2-D chunked part: {part.status!r}")
        resck = solve_sharded_2d_with_checkpoints(
            A2, b2, c2, mesh2, path=ckpt, options=SimplexOptions(checkpoint_every=max(1, half // 2)), device=dev)
        torch.distributed.barrier()
        if torch.distributed.get_rank() == 0:
            shutil.rmtree(obj[0], ignore_errors=True)
        gapck = relative_gap(resck.z, ref2.z)
        _check(resck.status == OPT and gapck < GAP, f"2-D resumed: {resck.status!r}, z {resck.z} vs {ref2.z}")
        two_d = (f"; 2d flagship z={res2d.z:.4f} gap={gap2:.1e} (sparse {gap2s:.1e})"
                 f"; 2d chunk-resume gap={gapck:.1e}")

    mp, np_ = 8, 8 * N
    Ap, bp, cp = random_dense_lp(mp, np_, seed=2, dtype=np.float32)
    refp = solve_scipy(Ap, bp, cp)
    resp = solve_pdhg_sharded(Ap, bp, cp, mesh, tol=1e-5, device=dev)
    gapp = relative_gap(resp.z, refp.z)
    _check(resp.status == OPT and gapp < PDHG_GAP, f"sharded PDHG: {resp.status!r}, z {resp.z} vs {refp.z}")
    resps = solve_pdhg_sharded(sps.csr_matrix(Ap), bp, cp, mesh, tol=1e-5, device=dev)
    gapps = relative_gap(resps.z, refp.z)
    _check(resps.status == OPT and gapps < PDHG_GAP, f"sparse sharded PDHG: {resps.status!r}, z {resps.z}")
    return (
        f"dryrun_multichip({N}): 1d z={res.z:.4f} gap={gap1:.1e} (sparse {gap1s:.1e}); "
        f"batched ok ({B} LPs, max gap {gapb:.1e}); warm-serving ok ({B} scenarios, max gap {gapw:.1e})"
        + two_d + f"; sharded pdhg gap={gapp:.1e} (sparse {gapps:.1e})"
    )


def transport(device: str, ranks: int) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    import torch

    return "nccl" if device == "cuda" and ranks <= torch.cuda.device_count() else "gloo"


def _rank(rank: int, world: int, port: int, device: str, backend: str, out) -> None:
    import torch
    import torch.distributed as dist

    from simplex_tpu_torch.dist.mesh import initialize_multihost

    if device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    initialize_multihost(f"127.0.0.1:{port}", world, rank, backend=backend)
    try:
        out.put((rank, "ok", run_modes(world, device)))
    except Exception:
        out.put((rank, "err", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    import torch
    import torch.multiprocessing as mp

    from simplex_tpu_torch.dist.mesh import free_port

    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: no CUDA device (--device cpu runs on the CPU)", file=sys.stderr)
        return 1
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    backend = transport(args.device, args.ranks)
    procs = [ctx.Process(target=_rank, args=(r, args.ranks, port, args.device, backend, out))
             for r in range(args.ranks)]
    for p in procs:
        p.start()
    lines, errors = {}, []
    try:
        for _ in procs:
            rank, kind, val = out.get(timeout=900)
            if kind == "ok":
                lines[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    if errors:
        print("\n".join(errors), file=sys.stderr)
        return 1
    print(lines[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
