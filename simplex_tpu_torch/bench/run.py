"""The port's benchmark entry point: ``bench.py``'s eight modes on the card.

    python -m simplex_tpu_torch.bench.run [--mode MODE] [--m M] [--n N]
        [--pivots K] [--small] [--backend hopper|torch] [--device cuda] ...

Takes ``bench.py``'s flags one for one with the same defaults (``--backend``
names the port's op sets, ``hopper`` = the CUDA kernels, ``torch`` = their
plain versions) and prints ONE JSON line on stdout; details go to stderr.
Each mode builds the instance ``bench.py`` builds (same generator, seed and
recipe), holds the same work inside its timed window, and prints ``bench.py``'s
record: the same ``metric`` name, ``value``, ``unit``, ``vs_baseline`` and
extra fields. The record adds:

  impl      "simplex_tpu_torch", so that the port's records never mix with
            the JAX package's
  backend   the op set that ran
  card      the ``nvidia-smi`` name and power limit, null off the card
  launches  each hand-written kernel's launches over the timed window(s)
            (``hopper.launches``)
  feas_err  where the mode's result is a ``SolveResult`` (full, parity,
            sparse) or a batch of them (reopt: the worst scenario's)

``vs_baseline`` keeps ``bench.py``'s definitions, among them the roofline
estimate of the CUDA reference on its own card:

  per-pivot HBM traffic (fp32, m=8192, n=16384):
    pricing GEMM reads D (m+1) x n      = 512 MB
    ftran GEMV reads B_inv m x m        = 256 MB
    rank-1 GER reads+writes B_inv       = 512 MB
    ----------------------------------- ~1.28 GB / pivot
  GTX 1050 Ti HBM bandwidth 112 GB/s  ->  ~11.4 ms/pivot  ->  ~87 pivots/s

The defaults run ``bench.py``'s flagship option set: bf16 pricing shadow,
segmented pricing over 8 segments, deferred rank-16 updates and 64-candidate
multiple pricing. ``--device`` defaults to ``cuda``; without a card that
raises before anything is built (no run falls back to the CPU).
``--device cpu`` runs the same code on CPU tensors at small sizes (the
kernels' plain versions; its times are CPU times).

Every window starts and ends with ``torch.cuda.synchronize()``. A window's
"warm-up" run is the same call once before it, which on a cold
``build/kernels/`` includes the kernels' nvcc build.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time

import numpy as np
import torch

from simplex_tpu_torch.kernels import hopper

REFERENCE_ROOFLINE_PIVOTS_PER_SEC = 87.0  # see the module docstring
TILE = 128  # bench.py's BlockSparse tile edge, for tile_density


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    """``bench.py``'s flags and its argument checks: ``--mode parity
    --no-oracle`` is an error, ``--small`` sets 512 x 1024, a non-Dantzig
    ``--pricing`` forces ``--multi-price 0``."""
    ap = argparse.ArgumentParser(prog="simplex_tpu_torch.bench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=8192)
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--pivots", type=int, default=512, help="single / sparse mode: the pivot budget")
    ap.add_argument(
        "--backend", default="hopper", choices=["hopper", "torch"],
        help="hopper = the CUDA kernels, torch = their plain PyTorch versions",
    )
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; no fallback to the CPU)")
    ap.add_argument("--pricing", default="dantzig", choices=["dantzig", "devex", "steepest"])
    ap.add_argument("--pricing-dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--update-defer", type=int, default=16)
    ap.add_argument("--partial-pricing", type=int, default=8)
    ap.add_argument(
        "--multi-price", type=int, default=64,
        help="K-candidate multiple pricing (amortizes the per-pivot m^2 ftran read; composes "
             "with --update-defer and --partial-pricing: with S > 1 each refill prices one "
             "rotating column segment); pass 0 to disable",
    )
    ap.add_argument(
        "--multi-price-stale", type=float, default=None,
        help="multiple-pricing staleness cutoff (fraction of the refill-time best "
             "improvement; default = the SimplexOptions default 0.05)",
    )
    ap.add_argument("--small", action="store_true", help="quick 512x1024 run")
    ap.add_argument(
        "--mode", default="single", choices=list(MODE_FNS),
        help="single = one large LP, fixed pivot budget (the headline); batch = many small "
             "LPs solved at once; full = solve one large LP to OPTIMAL and report the time "
             "to optimal (with the oracle gap in the JSON line); parity = the same solve, "
             "the metric IS the relative objective gap vs HiGHS; general = a general-form "
             "instance (mixed E/L rows + native bounds) through the two-phase route, HiGHS "
             "gap in the JSON line; pdhg = the first-order mode; reopt = warm re-solves of "
             "rhs scenarios; sparse = the sparse simplex core against the dense one",
    )
    ap.add_argument("--periods", type=int, default=64, help="general mode: planning periods T (rows = T*(P+1))")
    ap.add_argument("--products", type=int, default=16, help="general mode: products P per period")
    ap.add_argument("--batch", type=int, default=4096, help="batch-mode LP count (reopt: scenarios)")
    ap.add_argument(
        "--sparse", action="store_true",
        help="pdhg mode: a structured multiperiod instance (rows ~ --m) solved sparse, the "
             "dense time reported as context; general mode: A as scipy CSC",
    )
    ap.add_argument(
        "--presolve", action="store_true",
        help="general mode: run the host presolve (reductions + geometric-mean scaling) "
             "before the two-phase solve",
    )
    ap.add_argument("--no-oracle", action="store_true", help="skip the host HiGHS solve (minutes at 8k+)")
    ap.add_argument(
        "--refactor-every", type=int, default=2048,
        help="full/parity mode: exact re-inversion cadence (each also invalidates the "
             "multi-price candidate buffer; verify_terminal still re-inverts before any "
             "certified status)",
    )
    ap.add_argument(
        "--degen", action="store_true",
        help="full/parity mode: degenerate-streak instance (sparse positive block, every 4th "
             "rhs zero) instead of the uniform dense LP",
    )
    args = ap.parse_args(argv)
    if args.mode == "parity" and args.no_oracle:
        # parity's metric IS the oracle gap: without the oracle the record
        # would measure nothing
        ap.error("--no-oracle is incompatible with --mode parity")
    if args.small:
        args.m, args.n = 512, 1024
    if args.pricing != "dantzig" and args.multi_price:
        # multiple pricing is Dantzig-only (solve() raises under steepest)
        log(f"--pricing {args.pricing}: multiple pricing is dantzig-only; forcing --multi-price 0")
        args.multi_price = 0
    return args


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev: torch.device, fn):
    """``fn()`` between two synchronizes: (result, seconds, the kernels'
    launches in it). The counters keep running (the launches are a
    difference), so a caller's count of the whole run stays whole."""
    _sync(dev)
    before = dict(hopper.launches)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0, {k: v - before[k] for k, v in hopper.launches.items()}


def _upload(dev: torch.device, *arrays):
    """float32 tensors on ``dev`` (as ``jax.device_put`` gives without x64)."""
    out = tuple(torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev) for a in arrays)
    _sync(dev)
    return out


def _stale(args) -> dict:
    return {} if args.multi_price_stale is None else {"multi_price_stale": args.multi_price_stale}


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def tile_density(A, tile: int = TILE):
    """(stored tiles, density) of ``simplex_tpu.sparse.from_dense(A)``'s
    ``BlockSparse`` over ``tile`` x ``tile`` tiles: the tiles holding a
    nonzero (at least one) over all tiles of the padded grid, computed on
    the host as that function does."""
    A = np.asarray(A)
    m, n = A.shape
    gr, gc = -(-m // tile), -(-n // tile)
    pad = np.zeros((gr * tile, gc * tile), bool)
    pad[:m, :n] = A != 0
    n_tiles = max(1, int(pad.reshape(gr, tile, gc, tile).any(axis=(1, 3)).sum()))
    return n_tiles, n_tiles / float(gr * gc)


def bench_single(args, dev) -> dict:
    """One large LP over a fixed pivot budget (``bench.py``'s headline).

    A, b and c are uploaded before the window. The window holds what
    ``simplex_tpu.core.solver._solve_jit`` holds: the dtype cast, the
    pricing shadow, the slack state and the pivot loop (with its verify
    rounds, which a MAX_ITER exit skips); no polish. The timed run's b is
    scaled by 1 + 1e-6, as in ``bench.py``."""
    from simplex_tpu_torch.config import SimplexOptions, check_supported, pin_full_fp32
    from simplex_tpu_torch.core.solver import build_problem, solve_state
    from simplex_tpu_torch.core.state import initial_state_slack
    from simplex_tpu_torch.oracle.generator import random_dense_lp

    m, n, k = args.m, args.n, args.pivots
    log(f"device: {_device_name(dev)}")
    log(f"generating dense LP {m}x{n} (A = {m*n*4/2**20:.0f} MiB fp32)...")
    A, b, c = random_dense_lp(m, n, seed=0, dtype=np.float32)
    opts = check_supported(SimplexOptions(
        max_iter=k, backend=args.backend, pricing=args.pricing, pricing_dtype=args.pricing_dtype,
        update_defer=args.update_defer, partial_pricing=args.partial_pricing,
        multi_price=args.multi_price, **_stale(args),
    ))
    pin_full_fp32()
    log("transferring to device...")
    t0 = time.perf_counter()
    A, b, c = _upload(dev, A, b, c)
    log(f"H2D: {time.perf_counter() - t0:.1f}s")

    def run(scale=1.0):
        prob = build_problem(A, b * scale, c, opts, dev)
        s0 = initial_state_slack(
            prob, opts.dtype, perturb=opts.perturb_after > 0, update_defer=opts.resolve_defer(),
            multi_price=opts.multi_price, pricing=opts.pricing,
        )
        return solve_state(prob, s0, opts, k)

    log("warmup run (the kernels' build on a cold cache)...")
    final, warm_s, _ = _timed(dev, run)
    log(f"warmup: {warm_s:.1f}s, iters={int(final.iters)} status={int(final.status)}")
    log("timed run...")
    final, dt, launches = _timed(dev, lambda: run(1.0 + 1e-6))
    iters = int(final.iters)
    pps = iters / dt if dt > 0 else float("nan")
    # two traffic figures: naive-equivalent = what a solver with full fp32
    # pricing and eager rank-1 updates would move for the same pivots;
    # config-aware = an estimate of what this option set moves
    naive_gb = iters * (4.0 * (m * n + 3 * m * m)) / 1e9
    if opts.multi_price > 0:
        # the refill cadence is data-dependent: no static estimate
        log(
            f"{iters} pivots in {dt:.3f}s -> {pps:.1f} pivots/s; "
            f"{naive_gb/dt:.0f} GB/s naive-equivalent (work avoided counts; actual traffic "
            f"is refill-cadence-dependent under multi_price)"
        )
    else:
        price_bytes = (2.0 if opts.pricing_dtype == "bfloat16" else 4.0) * m * n
        if opts.partial_pricing > 1:
            price_bytes /= opts.partial_pricing
        upd_bytes = 4.0 * m * m * (2.0 / max(opts.update_defer, 1))
        actual_gb = iters * (price_bytes + 4.0 * m * m + upd_bytes) / 1e9
        log(
            f"{iters} pivots in {dt:.3f}s -> {pps:.1f} pivots/s; "
            f"~{actual_gb/dt:.0f} GB/s actual traffic (config-aware est.), "
            f"{naive_gb/dt:.0f} GB/s naive-equivalent (work avoided counts)"
        )
    return {
        "metric": f"pivots_per_sec_dense_{m}x{n}_fp32",
        "value": round(pps, 2),
        "unit": "pivots/sec",
        "vs_baseline": round(pps / REFERENCE_ROOFLINE_PIVOTS_PER_SEC, 2),
        "compile_warmup_seconds": round(warm_s, 1),
        "launches": launches,
    }


def bench_full(args, dev, parity_metric: bool = False) -> dict:
    """Solve one LP to OPTIMAL; the metric is the wall seconds to the
    optimum through ``solve_with_checkpoints`` (snapshots every 2048
    pivots in a temporary directory). A, b and c are uploaded before the
    window, after a 2-pivot warm-up; the window holds the whole call, the
    polish included. Unless ``--no-oracle``, HiGHS then solves the same
    instance in f64 on the host and the relative gap goes into the record
    (with ``parity_metric`` it IS the metric)."""
    from simplex_tpu_torch.config import SimplexOptions
    from simplex_tpu_torch.core.checkpoint import solve_with_checkpoints
    from simplex_tpu_torch.oracle.generator import degenerate_streak_lp, random_dense_lp

    m, n = args.m, args.n
    log(f"device: {_device_name(dev)}")
    if args.degen:
        log(f"generating degenerate-streak LP {m}x{n}...")
        A, b, c = degenerate_streak_lp(m, n, seed=0)
    else:
        log(f"generating dense LP {m}x{n}...")
        A, b, c = random_dense_lp(m, n, seed=0, dtype=np.float32)
    opts = SimplexOptions(
        backend=args.backend, pricing=args.pricing, pricing_dtype=args.pricing_dtype,
        update_defer=args.update_defer, partial_pricing=args.partial_pricing,
        multi_price=args.multi_price, **_stale(args),
        refactor_every=args.refactor_every, checkpoint_every=2048,
    )
    log("transferring to device...")
    A_dev, b_dev, c_dev = _upload(dev, A, b, c)
    with tempfile.TemporaryDirectory() as td:
        log("warmup (2-pivot budget)...")
        _, warm_s, _ = _timed(dev, lambda: solve_with_checkpoints(
            A_dev, b_dev, c_dev, path=f"{td}/warm.npz",
            options=dataclasses.replace(opts, max_iter=2), resume=False, A_host=A, device=dev,
        ))
        log(f"warmup: {warm_s:.1f}s")
        log("timed solve...")
        res, dt, launches = _timed(dev, lambda: solve_with_checkpoints(
            A_dev, b_dev, c_dev, path=f"{td}/ckpt.npz", options=opts, resume=False,
            A_host=A, device=dev,
        ))
    log(f"{res.status.name} z={res.z:.8f} iters={res.iters} feasibility(min x_b)={-res.feas_err:.2e}")

    gap = None
    if not args.no_oracle:
        from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy

        log(f"oracle: HiGHS f64 on the same {m}x{n} instance (host)...")
        t1 = time.perf_counter()
        ref = solve_scipy(A, b, c)
        log(f"oracle: {ref.status.name} z={ref.z} in {time.perf_counter() - t1:.0f}s")
        if ref.z is not None:
            gap = relative_gap(res.z, ref.z)
            log(f"rel_gap={gap:.3e} ({'OK' if gap < 1e-6 else 'FAIL'} @ 1e-6 gate)")

    inst = "degen" if args.degen else "dense"
    if parity_metric:
        record = {
            "metric": f"oracle_rel_gap_{inst}_{m}x{n}_fp32",
            "value": float(f"{gap:.3e}") if gap is not None else None,
            "unit": "relative_gap",
            # the fraction of the 1e-6 gate consumed (< 1 passes)
            "vs_baseline": round(gap / 1e-6, 4) if gap is not None else None,
            "seconds_to_optimal": round(dt, 2),
            "pivots": res.iters,
        }
    else:
        record = {
            "metric": f"seconds_to_optimal_{inst}_{m}x{n}_fp32",
            "value": round(dt, 2),
            "unit": "seconds",
            # the reference's roofline 87 pivots/s -> 11.5 ms a pivot for
            # the same pivot count
            "vs_baseline": round((res.iters * 0.0115) / dt, 2),
        }
        if gap is not None:
            record["rel_gap_vs_highs"] = float(f"{gap:.3e}")
    record["pivots_per_sec"] = round(res.iters / dt, 1) if dt > 0 else None
    record["compile_warmup_seconds"] = round(warm_s, 1)
    record["feas_err"] = float(res.feas_err)
    record["launches"] = launches
    return record


def bench_general(args, dev) -> dict:
    """A multi-period production instance (T*(P+1) rows: T*P equalities and
    T capacity rows; 3*T*P structural columns, each with a finite upper
    bound) through the whole two-phase route: standardize, phase 1 from the
    artificial basis, the artificials driven out, phase 2 under the native
    bounded rule. The window holds the whole ``solve_general`` call after a
    2-pivot warm-up (A goes up inside it, as in ``bench.py``); HiGHS f64
    gives the gap. ``--sparse`` passes A as scipy CSC (segmented pricing
    off)."""
    from simplex_tpu_torch.config import SimplexOptions
    from simplex_tpu_torch.core.twophase import solve_general
    from simplex_tpu_torch.oracle.generator import multiperiod_production_lp
    from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy_general

    T, P = args.periods, args.products
    m = T * (P + 1)
    log(f"device: {_device_name(dev)}")
    log(f"generating multiperiod T={T} P={P}: {m} rows, {3*T*P} bounded cols")
    lp = multiperiod_production_lp(T, P, seed=0)
    if args.sparse:
        import scipy.sparse as sps

        lp = lp._replace(A=sps.csc_matrix(np.asarray(lp.A)))
        args.partial_pricing = 0  # segments slice dense columns
    opts = SimplexOptions(
        backend=args.backend, pricing_dtype=args.pricing_dtype, update_defer=args.update_defer,
        partial_pricing=args.partial_pricing, refactor_every=1024,
    )
    pre = args.presolve
    log("warmup (2-pivot budget)...")
    solve_general(lp, options=dataclasses.replace(opts, max_iter=2), presolve=pre, device=dev)
    log("timed two-phase solve%s..." % (" (presolved)" if pre else ""))
    res, dt, launches = _timed(dev, lambda: solve_general(lp, options=opts, presolve=pre, device=dev))
    log(f"{res.status.name} z={res.z:.8f} iters={res.iters} (phase1 {res.phase1_iters})")

    log("oracle: HiGHS f64 on the same instance (host)...")
    t1 = time.perf_counter()
    ref = solve_scipy_general(lp if not args.sparse else lp._replace(A=np.asarray(lp.A.todense())))
    oracle_dt = time.perf_counter() - t1
    log(f"oracle: {ref.status.name} z={ref.z} in {oracle_dt:.1f}s")
    gap = relative_gap(res.z, ref.z) if ref.z is not None else None
    if gap is not None:
        log(f"rel_gap={gap:.3e} ({'OK' if gap < 1e-6 else 'FAIL'} @ 1e-6 gate)")
    tag = "_sparse" if args.sparse else ""
    return {
        "metric": f"seconds_to_optimal_general_{m}rows_T{T}P{P}{tag}_fp32",
        "value": round(dt, 2),
        "unit": "seconds",
        # the reference has no general-form route: the baseline is HiGHS's
        # f64 host time
        "vs_baseline": round(oracle_dt / dt, 2) if dt > 0 else None,
        "rel_gap_vs_highs": float(f"{gap:.3e}") if gap is not None else None,
        "pivots": res.iters,
        "launches": launches,
    }


def bench_pdhg(args, dev) -> dict:
    """The first-order mode: seconds to a 1e-4 relative KKT point. A, b and
    c are uploaded before the window, which holds one ``solve_pdhg`` call.
    ``--sparse`` runs :func:`_bench_pdhg_sparse` instead."""
    from simplex_tpu_torch.fo import solve_pdhg
    from simplex_tpu_torch.oracle.generator import random_dense_lp

    m, n = args.m, args.n
    log(f"device: {_device_name(dev)}")
    if args.sparse:
        return _bench_pdhg_sparse(args, dev)
    log(f"generating dense LP {m}x{n}...")
    A, b, c = random_dense_lp(m, n, seed=0, dtype=np.float32)
    A_d, b_d, c_d = _upload(dev, A, b, c)
    log("solve (one call: the windows run to tolerance)...")
    res, dt, launches = _timed(dev, lambda: solve_pdhg(A_d, b_d, c_d, tol=1e-4, device=dev))
    ips = res.iters / dt if dt > 0 else float("nan")
    log(
        f"{res.status.name} iters={res.iters} in {dt:.1f}s -> {ips:.0f} it/s; "
        f"rp={res.primal_res:.2e} rd={res.dual_res:.2e} gap={res.gap:.2e}"
    )
    gap = None
    if not args.no_oracle:
        from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy

        log("oracle: HiGHS f64 (host)...")
        ref = solve_scipy(A, b, c)
        if ref.z is not None:
            gap = relative_gap(res.z, ref.z)
            log(f"objective rel_gap={gap:.3e}")
    record = {
        "metric": f"pdhg_seconds_to_kkt1e-4_dense_{m}x{n}_fp32",
        "value": round(dt, 2),
        "unit": "seconds",
        "vs_baseline": None,  # the reference has no first-order mode
        "iters": res.iters,
        "iters_per_sec": round(ips, 1),
    }
    if gap is not None:
        record["obj_rel_gap_vs_highs"] = float(f"{gap:.3e}")
    record["launches"] = launches
    return record


def _bench_pdhg_sparse(args, dev) -> dict:
    """PDHG on the structured workload: ``multiperiod_production_lp(T, 32)``
    in equality form, T = max(2, m // 33) so that rows ~ ``--m``, solved
    dense (A goes up inside the window, as in ``bench.py``) and then sparse
    (the :class:`~simplex_tpu_torch.sparse.SparseA` built on the card
    before the window, as ``bench.py``'s ``BlockSparse``); the metric is the
    sparse solve. ``tile_density`` is the ``BlockSparse``'s of ``bench.py``."""
    from simplex_tpu_torch import sparse as _sp
    from simplex_tpu_torch.fo import solve_pdhg
    from simplex_tpu_torch.io.canonical import to_equality_form
    from simplex_tpu_torch.oracle.generator import multiperiod_production_lp

    P = 32
    T = max(2, args.m // (P + 1))
    lp = multiperiod_production_lp(T, P, seed=0)
    eq = to_equality_form(lp)
    A = eq.A.astype(np.float32)
    b, c, u = eq.b.astype(np.float32), eq.c.astype(np.float32), eq.u.astype(np.float32)
    M = _sp.from_dense(A, torch.float32, dev)
    n_tiles, dens = tile_density(A)
    log(
        f"multiperiod T={T} P={P}: {A.shape[0]}x{A.shape[1]} equality form, "
        f"{n_tiles} {TILE}x{TILE} tiles hold a nonzero (tile density {dens:.3f}); {M.nnz} nonzeros"
    )
    log("dense solve (reference point)...")
    res_d, dt_dense, l_dense = _timed(dev, lambda: solve_pdhg(A, b, c, u=u, tol=1e-4, device=dev))
    log(f"dense: {res_d.status.name} iters={res_d.iters} in {dt_dense:.1f}s")
    log("sparse solve...")
    res, dt, l_sparse = _timed(dev, lambda: solve_pdhg(M, b, c, u=u, tol=1e-4, device=dev))
    ips = res.iters / dt if dt > 0 else float("nan")
    log(
        f"sparse: {res.status.name} iters={res.iters} in {dt:.1f}s -> "
        f"{ips:.0f} it/s; rp={res.primal_res:.2e} rd={res.dual_res:.2e}"
    )
    gap = None
    if not args.no_oracle:
        from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy_general

        log("oracle: HiGHS f64 (host) on the general form...")
        ref = solve_scipy_general(lp)
        if ref.z is not None:
            # multiperiod lowers are 0: res.z is in the original units
            gap = relative_gap(res.z, ref.z)
            log(f"objective rel_gap={gap:.3e}")
    record = {
        "metric": f"pdhg_seconds_to_kkt1e-4_sparse_{A.shape[0]}x{A.shape[1]}_fp32",
        "value": round(dt, 2),
        "unit": "seconds",
        # context, not a baseline: the same instance solved dense
        "vs_baseline": None,
        "dense_seconds": round(dt_dense, 2),
        "tile_density": round(float(dens), 4),
        "iters": res.iters,
        "iters_per_sec": round(ips, 1),
    }
    if gap is not None:
        record["obj_rel_gap_vs_highs"] = float(f"{gap:.3e}")
    record["launches"] = {k: l_dense[k] + l_sparse[k] for k in l_dense}
    return record


def sparse_instance(m: int, n: int, seed: int = 0):
    """``bench.py --mode sparse``'s [A0 | I]: A0's ``TILE`` x ``TILE``
    tiles kept with probability 0.1 (at least one), entries U(0.2, 1.5);
    b = A0 U(0.2, 0.8) + U(0.1, 1.0); c U(0.5, 2) on A0's columns that hold
    a nonzero, 0 elsewhere; all float32."""
    k = n - m
    rng = np.random.default_rng(seed)
    gr, gc = -(-m // TILE), -(-k // TILE)
    mask = rng.uniform(size=(gr, gc)) < 0.10
    if not mask.any():
        mask[0, 0] = True
    A0 = rng.uniform(0.2, 1.5, (m, k)).astype(np.float32)
    keep = np.kron(mask, np.ones((TILE, TILE), bool))[:m, :k]
    A0[~keep] = 0.0
    A = np.hstack([A0, np.eye(m, dtype=np.float32)])
    b = (A0 @ rng.uniform(0.2, 0.8, k) + rng.uniform(0.1, 1.0, m)).astype(np.float32)
    c = np.concatenate([rng.uniform(0.5, 2, k), np.zeros(m)]).astype(np.float32)
    # a column whose tiles were all masked away is zero: a positive cost
    # there would make the LP unbounded
    c[:k] *= (A0 != 0).any(axis=0)
    return A, b, c


def bench_sparse(args, dev) -> dict:
    """The sparse simplex core against the dense one on
    :func:`sparse_instance`, both under the same options (Dantzig, no
    segments) over ``--pivots``, each ``solve`` after a 2-pivot warm-up. The
    dense A goes up inside its window (numpy, as ``bench.py`` passes it);
    the sparse A is a :class:`~simplex_tpu_torch.sparse.SparseA` built on
    the card before its window (``bench.py``'s ``BlockSparse`` is on the
    device before it too). ``tile_density`` is that ``BlockSparse``'s."""
    from simplex_tpu_torch import sparse as _sp
    from simplex_tpu_torch.config import SimplexOptions
    from simplex_tpu_torch.core.solver import solve

    m, n = args.m, args.n
    if n - m <= 0:
        raise SystemExit("--mode sparse needs n > m ([A0 | I] layout)")
    A, b, c = sparse_instance(m, n)
    M = _sp.from_dense(A, torch.float32, dev)
    n_tiles, dens = tile_density(A)
    log(f"device: {_device_name(dev)}")
    log(
        f"[A0|I] {m}x{n}: {n_tiles} tiles hold a nonzero (tile density {dens:.3f}; "
        f"dense A = {m*n*4/2**20:.0f} MiB, CSR values + indices = {M.nnz*8/2**20:.0f} MiB)"
    )
    opts = SimplexOptions(
        max_iter=args.pivots, backend=args.backend, pricing_dtype=args.pricing_dtype,
        update_defer=args.update_defer, partial_pricing=0,
    )
    warm_opts = dataclasses.replace(opts, max_iter=2)

    def timed(A_in, label):
        log(f"{label}: warmup...")
        solve(A_in, b, c, options=warm_opts, device=dev)
        log(f"{label}: timed solve...")
        res, dt, launches = _timed(dev, lambda: solve(A_in, b, c, options=opts, device=dev))
        pps = res.iters / dt if dt > 0 else float("nan")
        log(
            f"{label}: {res.status.name} iters={res.iters} in {dt:.1f}s -> "
            f"{pps:.0f} pivots/s (z={res.z:.6g}, feas_err={res.feas_err:.1e})"
        )
        return res, pps, launches

    res_d, pps_d, l_dense = timed(A, "dense")
    res_s, pps_s, l_sparse = timed(M, "sparse")
    gap = None
    if not args.no_oracle and res_s.status.name == "OPTIMAL":
        from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy

        log("oracle: scipy/HiGHS f64 on the host...")
        ref = solve_scipy(A, b, c)
        if ref.z is not None:
            gap = relative_gap(res_s.z, ref.z)
            log(f"sparse-vs-oracle rel_gap={gap:.3e}")
        else:
            log(f"oracle did not reach OPTIMAL ({ref.status}); gap skipped")
    record = {
        "metric": f"sparse_simplex_pivots_per_sec_{m}x{n}_fp32",
        "value": round(pps_s, 1),
        "unit": "pivots/sec",
        # the baseline is the dense core on the same instance and options
        "vs_baseline": round(pps_s / pps_d, 3) if pps_d else None,
        "dense_pivots_per_sec": round(pps_d, 1),
        "tile_density": round(float(dens), 4),
        "iters": {"sparse": res_s.iters, "dense": res_d.iters},
        "status": {"sparse": res_s.status.name, "dense": res_d.status.name},
    }
    if gap is not None:
        record["obj_rel_gap_vs_oracle"] = float(f"{gap:.3e}")
    record["feas_err"] = {"sparse": float(res_s.feas_err), "dense": float(res_d.feas_err)}
    record["launches"] = {k: l_dense[k] + l_sparse[k] for k in l_dense}
    return record


def bench_reopt(args, dev) -> dict:
    """What-if rhs scenarios re-solved warm, per second. One LP is solved
    cold (``refactor_every=256``); then ``--batch`` rhs vectors b (1 + 0.05
    U(-1, 1)) (``default_rng(1)``) re-solve from its basis in one
    ``reoptimize_batched`` call, once to warm up and once timed on a fresh
    set. Both calls take numpy inputs, as ``bench.py``'s do, so the upload
    of A and the scenarios sits inside the window. A sample of up to 8
    scenarios is held against HiGHS unless ``--no-oracle``. B_inv alone is
    B m^2 floats: the default 8192 x 16384 x 4096 fits no card."""
    from simplex_tpu_torch.batch.vmapped import reoptimize_batched
    from simplex_tpu_torch.config import SimplexOptions
    from simplex_tpu_torch.core.solver import solve
    from simplex_tpu_torch.oracle.generator import random_dense_lp

    m, n, B = args.m, args.n, args.batch
    log(f"device: {_device_name(dev)}")
    log(f"cold solve of the base LP {m}x{n}...")
    A, b, c = random_dense_lp(m, n, seed=0, dtype=np.float32)
    opts = SimplexOptions(refactor_every=256, backend=args.backend)
    cold = solve(A, b, c, options=opts, device=dev)
    log(f"cold: status={cold.status.name} iters={cold.iters}")
    rng = np.random.default_rng(1)

    def scenarios():
        return (np.asarray(b, np.float64)[None, :] * (1 + 0.05 * rng.uniform(-1, 1, (B, m)))).astype(np.float32)

    bs2 = scenarios()
    log(f"warm re-solving {B} scenarios (warmup)...")
    _, warm_s, _ = _timed(dev, lambda: reoptimize_batched(A, bs2, c, cold, options=opts, device=dev))
    log(f"warmup: {warm_s:.1f}s")
    bs3 = scenarios()  # the timed run on a fresh set, as in bench.py
    res, dt, launches = _timed(dev, lambda: reoptimize_batched(A, bs3, c, cold, options=opts, device=dev))
    sps = B / dt if dt > 0 else float("nan")
    n_opt = int((res.status == 1).sum())
    log(
        f"{B} scenarios in {dt:.2f}s -> {sps:.0f} scenarios/s "
        f"({n_opt} OPTIMAL, max pivots {int(res.iters.max())}, mean {float(res.iters.mean()):.1f})"
    )
    gap = None
    if not args.no_oracle:
        from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy

        worst = 0.0
        for i in range(0, B, max(1, B // 8))[:8] if B >= 8 else range(B):
            ref = solve_scipy(A, bs3[i], c)
            if ref.z is not None:
                worst = max(worst, relative_gap(float(res.z[i]), ref.z))
        gap = worst
        log(f"worst sampled objective rel_gap vs HiGHS: {gap:.3e}")
    record = {
        "metric": f"warm_rhs_scenarios_per_sec_{m}x{n}_batch{B}_fp32",
        "value": round(sps, 1),
        "unit": "scenarios/sec",
        # the reference re-solves every scenario cold: no warm path there
        "vs_baseline": None,
        "mean_pivots": round(float(res.iters.mean()), 1),
    }
    if gap is not None:
        record["worst_sampled_rel_gap_vs_highs"] = float(f"{gap:.3e}")
    record["feas_err"] = float(res.feas_err.max())
    record["launches"] = launches
    return record


def bench_batch(args, dev) -> dict:
    """B independent 64 x 160 LPs solved to termination in one
    ``solve_batched`` call: copies of ``random_dense_lp(64, 160, seed=0)``
    with 0.01 N(0, 1) noise on A and 0.01 |N(0, 1)| on b
    (``default_rng(0)``), no verify rounds, no polish, ``max_iter=1000``.
    The stacks are uploaded before the window; the window holds the call,
    whose results come back to the host inside it. The timed run's b is
    scaled by 1 + 1e-6. Then the same call one LP at a time (B = 1, 16
    calls, b scaled by 1 + 1e-7 i), the sequential baseline."""
    from simplex_tpu_torch.batch.vmapped import solve_batched
    from simplex_tpu_torch.config import SimplexOptions
    from simplex_tpu_torch.oracle.generator import random_dense_lp

    B, m, n = args.batch, 64, 160
    log(f"device: {_device_name(dev)}")
    log(f"generating {B} dense LPs {m}x{n}...")
    rng = np.random.default_rng(0)
    As = np.empty((B, m, n), np.float32)
    bs = np.empty((B, m), np.float32)
    cs = np.empty((B, n), np.float32)
    A0, b0, c0 = random_dense_lp(m, n, seed=0, dtype=np.float32)
    for i in range(B):  # cheap perturbations of one instance
        As[i] = A0 + 0.01 * rng.standard_normal((m, n)).astype(np.float32)
        bs[i] = b0 + 0.01 * np.abs(rng.standard_normal(m)).astype(np.float32)
        cs[i] = c0
    opts = SimplexOptions(
        backend=args.backend, pricing=args.pricing, verify_terminal=False, polish=False, max_iter=1000,
    )
    As, bs, cs = _upload(dev, As, bs, cs)

    def run(lo, hi, scale):
        return solve_batched(As[lo:hi], bs[lo:hi] * scale, cs[lo:hi], options=opts, device=dev)

    log("warmup...")
    _, warm_s, _ = _timed(dev, lambda: run(0, B, 1.0))
    log(f"warmup: {warm_s:.1f}s")
    out, dt, launches = _timed(dev, lambda: run(0, B, 1.0 + 1e-6))
    solved = int((out.status == 1).sum())
    sps = B / dt
    log(f"{B} LPs in {dt:.3f}s -> {sps:.0f} solves/s ({solved}/{B} optimal, median {int(np.median(out.iters))} pivots)")

    # the same machinery one LP at a time: the reference's execution model
    # (one LP per process) without its process and allocation overhead
    NS = min(16, B)
    log(f"sequential B=1 reference ({NS} solves, same machinery)...")
    run(0, 1, 1.0)
    _, dt1, _ = _timed(dev, lambda: [run(i, i + 1, 1.0 + 1e-7 * i) for i in range(NS)])
    sps1 = NS / dt1 if dt1 > 0 else float("nan")
    log(f"B=1: {dt1/NS*1e3:.2f} ms/LP -> {sps1:.1f} solves/s sequential")
    return {
        "metric": f"lp_solves_per_sec_batched_{B}x{m}x{n}_fp32",
        "value": round(sps, 2),
        "unit": "solves/sec",
        # the batching win over one LP at a time on the same card and code
        "vs_baseline": round(sps / sps1, 2) if sps1 > 0 else None,
        "sequential_solves_per_sec": round(sps1, 2),
        "compile_warmup_seconds": round(warm_s, 1),
        "launches": launches,
    }


MODE_FNS = {
    "single": bench_single,
    "batch": bench_batch,
    "full": bench_full,
    "parity": lambda args, dev: bench_full(args, dev, parity_metric=True),
    "pdhg": bench_pdhg,
    "general": bench_general,
    "reopt": bench_reopt,
    "sparse": bench_sparse,
}


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device (pass --device cpu to run on the CPU)")
    from simplex_tpu_torch.bench.profile_general import card_line

    record = MODE_FNS[args.mode](args, dev)
    record = {
        **record,
        "impl": "simplex_tpu_torch",
        "backend": args.backend,
        "card": card_line() if dev.type == "cuda" else None,
    }
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
