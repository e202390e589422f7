"""Command-line interface: ``simplex_tpu.cli`` on the port.

Usage:
  python -m simplex_tpu_torch.cli solve INPUT [--mps] [--sparse] [--time]
      [--algo simplex|pdhg] [--pdhg-tol T] [--crossover]
  python -m simplex_tpu_torch.cli verify INPUT [--mps] [--oracle scipy|native] [--gap G]
  python -m simplex_tpu_torch.cli analyze INPUT [--mps] [--sparse]
      [--top-cols K] [--reoptimize 'i=delta,...']
  python -m simplex_tpu_torch.cli trace INPUT [--mps] [--verbose]
  python -m simplex_tpu_torch.cli bench [--m M] [--n N] [--pivots K]
      [--backend hopper|torch] [--device cuda]

and on every subcommand but ``bench`` the option flags: [--device cuda]
[--backend hopper|torch] [--pricing dantzig|devex|steepest] [--fp64]
[--max-iter N] [--presolve] [--fast] [--pricing-dtype ...]
[--update-defer L] [--partial-pricing S] [--multi-price K] [--ratio ...]
[--refactor-every K] [--log-level ...].

Reads an LP in the reference text format (``m n``, A, b, c) or an MPS file
(``.mps`` or ``--mps``). An MPS instance with only <= rows, b >= 0 and
default bounds is solved in canonical form from its slack basis; anything
else (and every ``--sparse`` input, whose A stays scipy.sparse and is solved
sparse on the device) goes through the two-phase route (``solve_general``).
The objective is reported in the instance's own sense, constant included.
``verify`` compares with HiGHS (scipy) or the native f64 oracle (g++ at
first use; a general-route input is always held against HiGHS on its
general form), ``analyze`` prints duals and the
rhs / cost ranges and re-solves warm after a rhs change, ``trace`` prints
the pivot path, ``bench`` runs the port's benchmark
(``python -m simplex_tpu_torch.bench.run``, single mode) and returns its
exit code. Exit code 0 on OPTIMAL (verify: on agreement), 2 on any
other status, 1 on bad input, a failed check or an option the port does
not run (``error: ...``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _load(path: str, use_mps: bool, sparse: bool = False):
    """``(loaded, c0, maximize)``: ``loaded`` is ``(A, b, c, basis0)`` in
    canonical form or a :class:`GeneralLP` for the two-phase route (>= / =
    rows, a negative rhs or non-default bounds). The solver always
    maximizes; ``c0`` and ``maximize`` give the instance's own sense.
    ``sparse`` (MPS only) keeps A scipy.sparse and always takes the general
    route (the canonical shortcut slices dense arrays)."""
    if use_mps or path.endswith(".mps"):
        from simplex_tpu_torch.core.twophase import GeneralLP
        from simplex_tpu_torch.io.mps import mps_to_canonical, read_mps

        prob = read_mps(path, sparse=sparse)
        default_bounds = not (np.any(prob.lower != 0) or np.any(np.isfinite(prob.upper)))
        canonical = default_bounds and all(t == "L" for t in prob.row_types) and np.all(prob.b >= 0)
        if canonical and not sparse:
            lp = mps_to_canonical(prob)
            return (lp.A, lp.b, lp.c, lp.basis0), prob.c0, prob.maximize
        c = prob.c if prob.maximize else -prob.c
        lp = GeneralLP(
            A=prob.A, b=prob.b, c=c, row_types=prob.row_types,
            lower=prob.lower, upper=prob.upper,
        )
        return lp, prob.c0, prob.maximize
    from simplex_tpu_torch.io.native import load_lp_fast

    A, b, c = load_lp_fast(path)  # native mmap parser, Python fallback
    return (A, b, c, None), 0.0, True


def _parse_reopt_spec(spec: str, m: int):
    """'i=delta[,i=delta...]' -> (m,) delta vector, or None on a bad spec."""
    db = np.zeros(m, np.float64)
    try:
        for part in spec.split(","):
            i_s, d_s = part.split("=")
            db[int(i_s)] = float(d_s)
    except (ValueError, IndexError) as exc:
        print(f"error: bad --reoptimize spec: {exc}", file=sys.stderr)
        return None
    return db


def _resolve_flag_defaults(args) -> None:
    """Fill the tuning flags the user did not pass: the flagship values
    under --fast, else the plain defaults. A flag passed explicitly (an
    explicit 0 too) always wins."""
    if not hasattr(args, "pricing_dtype"):
        return  # bench: no option flags
    fast = args.fast
    if args.pricing_dtype is None:
        args.pricing_dtype = "bfloat16" if fast else "float32"
    if args.update_defer is None:
        args.update_defer = 16 if fast else 0
    if args.partial_pricing is None:
        args.partial_pricing = 8 if fast else 0
    if args.refactor_every is None:
        args.refactor_every = 1024 if fast else 0
    if args.multi_price is None:
        # multiple pricing is Dantzig-only: steepest edge refuses it, devex
        # would drop it
        args.multi_price = 64 if (fast and getattr(args, "pricing", "dantzig") == "dantzig") else 0


def _options(args):
    import torch

    from simplex_tpu_torch.config import SimplexOptions

    if args.algo != "simplex" and args.cmd != "solve":
        raise NotImplementedError(
            f"--algo {args.algo} runs under `solve` only (as in simplex_tpu.cli): "
            f"`{args.cmd}` is a simplex subcommand"
        )
    return SimplexOptions(
        dtype=torch.float64 if args.fp64 else torch.float32,
        backend=args.backend,
        pricing=args.pricing,
        pricing_dtype=args.pricing_dtype,
        update_defer=args.update_defer,
        partial_pricing=args.partial_pricing,
        ratio=args.ratio,
        multi_price=args.multi_price,
        max_iter=args.max_iter,
        refactor_every=args.refactor_every,
    )


def _sparse_needs_mps(args) -> bool:
    """--sparse on a non-MPS input: report and refuse (True)."""
    if getattr(args, "sparse", False) and not (args.mps or args.input.endswith(".mps")):
        print("error: --sparse requires an MPS input (--mps)", file=sys.stderr)
        return True
    return False


def _solve_pdhg(loaded, args, opts):
    """``--algo pdhg`` (``simplex_tpu.cli``'s first-order route): PDHG to
    ``--pdhg-tol``, then with ``--crossover`` the simplex from the
    identified basis. A general LP goes through its box-bounded equality
    form (no feasible basis, no artificials) and is mapped back to the
    caller's variables, its objective constant restored."""
    from simplex_tpu_torch.core.twophase import GeneralLP
    from simplex_tpu_torch.fo.crossover import crossover
    from simplex_tpu_torch.fo.pdhg import solve_pdhg
    from simplex_tpu_torch.io.canonical import to_equality_form
    from simplex_tpu_torch.status import SolveStatus

    eq = None
    if isinstance(loaded, GeneralLP):
        eq = to_equality_form(loaded)
        A, b, c, u = (np.asarray(v, np.float32) for v in (eq.A, eq.b, eq.c, eq.u))
    else:
        A, b, c, _basis0 = loaded
        u = None
    res = solve_pdhg(A, b, c, u=u, tol=args.pdhg_tol, device=args.device)
    if args.crossover and res.status == SolveStatus.OPTIMAL:
        vert = crossover(A, b, c, res, u=u, options=opts, device=args.device)
        res = res._replace(z=vert.z, x=vert.x, status=vert.status, iters=res.iters + vert.iters)
    if eq is not None:
        res = res._replace(
            z=res.z + eq.z_const, x=eq.recover(np.asarray(res.x)[: eq.k_transformed])
        )
    return res


def cmd_solve(args) -> int:
    from simplex_tpu_torch.bench.timing import PhaseTimer
    from simplex_tpu_torch.core.solver import solve
    from simplex_tpu_torch.core.twophase import GeneralLP, solve_general
    from simplex_tpu_torch.status import SolveStatus

    opts = _options(args)
    if _sparse_needs_mps(args):
        return 1
    timer = PhaseTimer(args.device)
    with timer.phase("Read file"):
        try:
            loaded, c0, maximize = _load(args.input, args.mps, args.sparse)
        except (OSError, ValueError) as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 1
    general = isinstance(loaded, GeneralLP)
    with timer.phase("Solve"):
        if args.algo == "pdhg":
            try:
                res = _solve_pdhg(loaded, args, opts)
            except ValueError as exc:
                print(f"error: {exc}", file=sys.stderr)
                return 1
        elif general:
            res = solve_general(loaded, options=opts, presolve=args.presolve, device=args.device)
        else:
            A, b, c, basis0 = loaded
            res = solve(A, b, c, basis0=basis0, options=opts, device=args.device)

    with timer.phase("Print result"):
        if res.status == SolveStatus.OPTIMAL:
            obj = (res.z if maximize else -res.z) + c0
            print(f"Optimum found: {obj:g}")
            if getattr(res, "feas_err", 0.0) > 1e-5:
                print(f"\twarning: primal infeasibility {res.feas_err:.2e}")
            if general:
                for i, v in enumerate(res.x):
                    print(f"\tx_{i} = {v:g}")
            elif hasattr(res, "basis"):
                for i in range(len(res.basis)):
                    print(f"\tx_{int(res.basis[i])} = {res.x_b[i]:g}")
            else:  # a first-order result has no basis: print the support
                for i in np.flatnonzero(np.abs(res.x) > 1e-9):
                    print(f"\tx_{int(i)} = {res.x[i]:g}")
        else:
            print(res.status.describe())
        print(f"Pivots: {res.iters}")
    if args.time:
        print()
        print(timer.report())
    return 0 if res.status == SolveStatus.OPTIMAL else 2


def cmd_verify(args) -> int:
    """Solve, then compare status and objective with an oracle (HiGHS
    through scipy, or the native f64 simplex): exit 0 when they agree
    within ``--gap``."""
    from simplex_tpu_torch.core.solver import solve
    from simplex_tpu_torch.core.twophase import GeneralLP, solve_general
    from simplex_tpu_torch.oracle import get_oracle
    from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy_general
    from simplex_tpu_torch.status import SolveStatus

    opts = _options(args)
    oracle = get_oracle(args.oracle)
    loaded, _c0, _max = _load(args.input, args.mps)
    if isinstance(loaded, GeneralLP):
        # the general route against HiGHS on the same general form
        res = solve_general(loaded, options=opts, presolve=args.presolve, device=args.device)
        ref = solve_scipy_general(loaded)
    else:
        A, b, c, basis0 = loaded
        res = solve(A, b, c, basis0=basis0, options=opts, device=args.device)
        ref = oracle(A, b, c)
    if res.status != ref.status:
        print(f"STATUS MISMATCH: ours={res.status.name} oracle={ref.status.name}")
        return 1
    if res.status == SolveStatus.OPTIMAL:
        gap = relative_gap(res.z, ref.z)
        ok = gap < args.gap
        print(
            f"ours={res.z:.9g} oracle={ref.z:.9g} rel_gap={gap:.3e} "
            f"({'OK' if ok else 'FAIL'} @ {args.gap:g})"
        )
        return 0 if ok else 1
    print(f"status agreed: {res.status.name}")
    return 0


def cmd_analyze(args) -> int:
    """Solve, then print the duals and the rhs / cost sensitivity ranges;
    ``--reoptimize`` re-solves warm after a rhs change."""
    from simplex_tpu_torch.analysis import ranging, reoptimize
    from simplex_tpu_torch.core.solver import solve
    from simplex_tpu_torch.core.twophase import GeneralLP, solve_general
    from simplex_tpu_torch.status import SolveStatus

    opts = _options(args)
    if _sparse_needs_mps(args):
        return 1
    loaded, c0, maximize = _load(args.input, args.mps, args.sparse)
    sgn = 1.0 if maximize else -1.0
    if isinstance(loaded, GeneralLP):
        # general route: duals from solve_general (ranges need the canonical
        # basis), warm re-solves through its warm token
        res = solve_general(loaded, options=opts, presolve=args.presolve, device=args.device)
        if res.status != SolveStatus.OPTIMAL:
            print(res.status.describe())
            return 2
        print(f"Optimum: {sgn * res.z + c0:g}  ({res.iters} pivots)")
        print("\nrow  dual y_i  (general route: ranging not available)")
        for i, yi in enumerate(res.y):
            print(f"{i:>3}  {sgn * yi:>10.6g}")
        if args.reoptimize:
            db = _parse_reopt_spec(args.reoptimize, len(loaded.b))
            if db is None:
                return 1
            lp2 = loaded._replace(b=np.asarray(loaded.b, np.float64) + db)
            warm = solve_general(lp2, options=opts, warm=res.warm, device=args.device)
            if warm.status != SolveStatus.OPTIMAL:
                print(f"\nre-solve: {warm.status.describe()}")
                return 2
            print(
                f"\nre-solve optimum: {sgn * warm.z + c0:g}  "
                f"({warm.iters} warm pivots, 0 phase-1, vs {res.iters} cold)"
            )
        return 0
    A, b, c, basis0 = loaded
    res = solve(A, b, c, basis0=basis0, options=opts, device=args.device)
    if res.status != SolveStatus.OPTIMAL:
        print(res.status.describe())
        return 2
    rng = ranging(A, b, c, res.basis, device=args.device)
    # in the instance's own sense: a minimize MPS had its costs negated by
    # _load, so duals and cost ranges flip (ranges negate and swap ends)
    y = sgn * rng.y
    c_lo = rng.c_lo if maximize else -rng.c_hi
    c_hi = rng.c_hi if maximize else -rng.c_lo
    print(f"Optimum: {sgn * res.z + c0:g}  ({res.iters} pivots)")
    print("\nrow  dual y_i      allowable delta-b_i (basis unchanged)")
    for i in range(len(b)):
        print(f"{i:>3}  {y[i]:>10.6g}  [{rng.b_lo[i]:>10.4g}, {rng.b_hi[i]:>10.4g}]")
    k = min(len(c), args.top_cols)
    print(f"\ncol  x_j         allowable delta-c_j (first {k} columns)")
    for j in range(k):
        print(f"{j:>3}  {rng.x[j]:>10.6g}  [{c_lo[j]:>10.4g}, {c_hi[j]:>10.4g}]")
    if args.reoptimize:
        db = _parse_reopt_spec(args.reoptimize, len(b))
        if db is None:
            return 1
        b2 = (np.asarray(b, np.float64) + db).astype(np.asarray(b).dtype)
        inside = np.all((db >= rng.b_lo - 1e-9) & (db <= rng.b_hi + 1e-9))
        warm = reoptimize(A, b2, c, res, options=opts, device=args.device)
        print(
            f"\nreoptimize: delta-b {'inside' if inside else 'OUTSIDE'} the "
            f"allowable range -> {'same basis expected' if inside else 'dual pivots expected'}"
        )
        if warm.status != SolveStatus.OPTIMAL:
            print(f"re-solve: {warm.status.describe()}")
            return 2
        print(
            f"re-solve optimum: {sgn * warm.z + c0:g}  "
            f"({warm.iters} warm pivots vs {res.iters} cold)"
        )
    return 0


def cmd_trace(args) -> int:
    """Print the pivot path of a canonical-form input."""
    from simplex_tpu_torch.core.trace import print_trace
    from simplex_tpu_torch.core.twophase import GeneralLP

    opts = _options(args)
    loaded, _c0, _max = _load(args.input, args.mps)
    if isinstance(loaded, GeneralLP):
        print("error: trace mode requires a canonical-form input", file=sys.stderr)
        return 1
    A, b, c, basis0 = loaded
    print_trace(A, b, c, basis0=basis0, options=opts, verbose=args.verbose, device=args.device)
    return 0


def cmd_bench(args) -> int:
    """Run the port's benchmark (``simplex_tpu_torch.bench.run``) in a
    subprocess and return its exit code."""
    import subprocess

    cmd = [
        sys.executable, "-m", "simplex_tpu_torch.bench.run",
        "--m", str(args.m), "--n", str(args.n), "--pivots", str(args.pivots),
        "--backend", args.backend, "--device", args.device,
    ]
    return subprocess.call(cmd)


def _common(p) -> None:
    """The option flags every subcommand takes (``simplex_tpu.cli``'s
    ``common``)."""
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument(
        "--backend", default="hopper", choices=["hopper", "torch"],
        help="hopper = the CUDA kernels, torch = plain PyTorch ops",
    )
    p.add_argument(
        "--pricing", default="dantzig", choices=["dantzig", "devex", "steepest"],
        help="entering-column rule (devex / steepest keep incremental reduced costs and weights)",
    )
    p.add_argument(
        "--fp64", action="store_true",
        help="solve in float64 (through the kernels' float64 instantiations under the "
        "default backend)",
    )
    p.add_argument("--max-iter", type=int, default=0)
    # None = "not set by the user", so --fast fills only what is unset
    p.add_argument("--refactor-every", type=int, default=None)
    p.add_argument(
        "--pricing-dtype", default=None, choices=["float32", "bfloat16"],
        help="price against a bf16 shadow of A (exact recheck)",
    )
    p.add_argument(
        "--update-defer", type=int, default=None, metavar="L",
        help="batch L rank-1 B_inv updates into one rank-L GEMM",
    )
    p.add_argument(
        "--partial-pricing", type=int, default=None, metavar="S",
        help="price 1/S of the columns per pivot (exact fallback)",
    )
    p.add_argument(
        "--multi-price", type=int, default=None, metavar="K",
        help="K-candidate multiple pricing",
    )
    p.add_argument(
        "--ratio", default="harris", choices=["harris", "classic"],
        help="ratio test (harris = stabilized two-pass, the default)",
    )
    p.add_argument(
        "--presolve", action="store_true",
        help="host presolve before the general route: fixed vars, empty "
             "rows/cols, singleton rows, geometric-mean scaling",
    )
    p.add_argument(
        "--fast", action="store_true",
        help="shorthand for --pricing-dtype bfloat16 --update-defer 16 "
             "--partial-pricing 8 --refactor-every 1024 --multi-price 64 "
             "(--multi-price under --pricing dantzig only); flags you set "
             "explicitly are kept",
    )
    p.add_argument(
        "--log-level", default=None, choices=["debug", "info", "warning", "error"],
        help="log verbosity (also: SIMPLEX_TPU_LOG; SIMPLEX_TPU_LOG_JSON=1 for JSON lines)",
    )
    p.add_argument(
        "--algo", default="simplex", choices=["simplex", "pdhg"],
        help="pdhg (solve only): the PDLP-style first-order mode, inverse-free",
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="simplex_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("solve", help="solve an LP from a file")
    ps.add_argument("input")
    ps.add_argument("--mps", action="store_true", help="input is MPS format")
    ps.add_argument("--time", action="store_true", help="print phase timings")
    ps.add_argument(
        "--sparse", action="store_true",
        help="MPS inputs: keep A scipy.sparse end to end and solve it sparse "
             "on the device (always the general route)",
    )
    ps.add_argument(
        "--pdhg-tol", type=float, default=1e-4,
        help="relative KKT tolerance for --algo pdhg",
    )
    ps.add_argument(
        "--crossover", action="store_true",
        help="with --algo pdhg: purify the first-order point to an exact vertex "
             "(basis identification, then a short warm simplex clean-up)",
    )
    _common(ps)
    ps.set_defaults(fn=cmd_solve)

    pv = sub.add_parser("verify", help="solve and compare against an oracle")
    pv.add_argument("input")
    pv.add_argument("--mps", action="store_true")
    pv.add_argument("--oracle", default="scipy", choices=["scipy", "native"])
    pv.add_argument("--gap", type=float, default=1e-6)
    _common(pv)
    pv.set_defaults(fn=cmd_verify)

    pa = sub.add_parser("analyze", help="solve + duals + rhs / cost sensitivity ranges")
    pa.add_argument("input")
    pa.add_argument("--mps", action="store_true")
    pa.add_argument("--top-cols", type=int, default=16, help="how many columns' cost ranges to print")
    pa.add_argument(
        "--reoptimize", metavar="SPEC", default=None,
        help="re-solve after a rhs change by the dual simplex from the optimal "
             "basis: SPEC is 'i=delta[,i=delta...]' (e.g. '0=+2.5,3=-1')",
    )
    pa.add_argument(
        "--sparse", action="store_true",
        help="MPS inputs: keep A scipy.sparse end to end (general route)",
    )
    _common(pa)
    pa.set_defaults(fn=cmd_analyze)

    pt = sub.add_parser("trace", help="per-pivot trace")
    pt.add_argument("input")
    pt.add_argument("--mps", action="store_true")
    pt.add_argument("--verbose", action="store_true", help="dump basis and x_b")
    _common(pt)
    pt.set_defaults(fn=cmd_trace)

    pb = sub.add_parser("bench", help="run the pivots/sec benchmark")
    pb.add_argument("--m", type=int, default=8192)
    pb.add_argument("--n", type=int, default=16384)
    pb.add_argument("--pivots", type=int, default=128)
    pb.add_argument(
        "--backend", default="hopper", choices=["hopper", "torch"],
        help="hopper = the CUDA kernels, torch = plain PyTorch ops",
    )
    pb.add_argument("--device", default="cuda", help="torch device (default cuda)")
    pb.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    if getattr(args, "log_level", None):
        from simplex_tpu_torch.logging import set_level

        set_level(args.log_level)
    _resolve_flag_defaults(args)
    try:
        return args.fn(args)
    except NotImplementedError as exc:
        # an option or path the port does not run: report it, as for bad input
        print(f"error: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
