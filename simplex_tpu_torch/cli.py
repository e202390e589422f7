"""Command-line interface.

Usage:
  python -m simplex_tpu_torch.cli solve INPUT [--mps] [--presolve] [--fast]
      [--pricing dantzig|devex|steepest] [--device cuda]
      [--backend hopper|torch] [--fp64] [--time] [option flags]

Reads an LP in the reference text format (``m n``, A, b, c) or an MPS file
(``.mps`` or ``--mps``) and prints the optimum and the solution, as
``simplex_tpu.cli solve`` does. An MPS instance with only <= rows, b >= 0
and default bounds is solved in canonical form from its slack basis;
anything else goes through the two-phase route (``solve_general``). The
objective is reported in the instance's own sense, constant included.
Exit code 0 on OPTIMAL, 2 on any other status, 1 on bad input.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _load(path: str, use_mps: bool, sparse: bool = False):
    """``(loaded, c0, maximize)``: ``loaded`` is ``(A, b, c, basis0)`` in
    canonical form or a :class:`GeneralLP` for the two-phase route (>= / =
    rows, a negative rhs or non-default bounds). The solver always
    maximizes; ``c0`` and ``maximize`` give the instance's own sense."""
    if sparse:
        raise NotImplementedError(
            "--sparse is not ported to simplex_tpu_torch yet (ROADMAP.md, open item 15)"
        )
    if use_mps or path.endswith(".mps"):
        from simplex_tpu_torch.core.twophase import GeneralLP
        from simplex_tpu_torch.io.mps import mps_to_canonical, read_mps

        prob = read_mps(path)
        default_bounds = not (np.any(prob.lower != 0) or np.any(np.isfinite(prob.upper)))
        if default_bounds and all(t == "L" for t in prob.row_types) and np.all(prob.b >= 0):
            lp = mps_to_canonical(prob)
            return (lp.A, lp.b, lp.c, lp.basis0), prob.c0, prob.maximize
        c = prob.c if prob.maximize else -prob.c
        lp = GeneralLP(
            A=prob.A, b=prob.b, c=c, row_types=prob.row_types,
            lower=prob.lower, upper=prob.upper,
        )
        return lp, prob.c0, prob.maximize
    from simplex_tpu_torch.io.text import load_lp

    A, b, c = load_lp(path)
    return (A, b, c, None), 0.0, True


def _resolve_flag_defaults(args) -> None:
    """Fill the tuning flags the user did not pass: the flagship values
    under --fast, else the plain defaults. A flag passed explicitly (an
    explicit 0 too) always wins."""
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

    if args.algo != "simplex":
        raise NotImplementedError(
            f"--algo {args.algo} is not ported to simplex_tpu_torch yet "
            "(ROADMAP.md, open item 17)"
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


def cmd_solve(args) -> int:
    from simplex_tpu_torch.bench.timing import PhaseTimer
    from simplex_tpu_torch.core.solver import solve
    from simplex_tpu_torch.core.twophase import GeneralLP, solve_general
    from simplex_tpu_torch.status import SolveStatus

    opts = _options(args)
    timer = PhaseTimer(args.device)
    with timer.phase("Read file"):
        try:
            loaded, c0, maximize = _load(args.input, args.mps, args.sparse)
        except (OSError, ValueError) as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 1
    general = isinstance(loaded, GeneralLP)
    with timer.phase("Solve"):
        if general:
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
            else:
                for i in range(len(res.basis)):
                    print(f"\tx_{int(res.basis[i])} = {res.x_b[i]:g}")
        else:
            print(res.status.describe())
        print(f"Pivots: {res.iters}")
    if args.time:
        print()
        print(timer.report())
    return 0 if res.status == SolveStatus.OPTIMAL else 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="simplex_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("solve", help="solve an LP from a file")
    ps.add_argument("input")
    ps.add_argument("--mps", action="store_true", help="input is MPS format")
    ps.add_argument("--time", action="store_true", help="print phase timings")
    ps.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ps.add_argument(
        "--backend", default="hopper", choices=["hopper", "torch"],
        help="hopper = the CUDA kernels, torch = plain PyTorch ops",
    )
    ps.add_argument(
        "--pricing", default="dantzig", choices=["dantzig", "devex", "steepest"],
        help="entering-column rule (devex / steepest keep incremental reduced costs and weights)",
    )
    ps.add_argument("--fp64", action="store_true", help="solve in float64 (needs --backend torch)")
    ps.add_argument("--max-iter", type=int, default=0)
    # None = "not set by the user", so --fast fills only what is unset
    ps.add_argument("--refactor-every", type=int, default=None)
    ps.add_argument(
        "--pricing-dtype", default=None, choices=["float32", "bfloat16"],
        help="price against a bf16 shadow of A (exact recheck)",
    )
    ps.add_argument(
        "--update-defer", type=int, default=None, metavar="L",
        help="batch L rank-1 B_inv updates into one rank-L GEMM",
    )
    ps.add_argument(
        "--partial-pricing", type=int, default=None, metavar="S",
        help="price 1/S of the columns per pivot (exact fallback)",
    )
    ps.add_argument(
        "--multi-price", type=int, default=None, metavar="K",
        help="K-candidate multiple pricing",
    )
    ps.add_argument(
        "--ratio", default="harris", choices=["harris", "classic"],
        help="ratio test (harris = stabilized two-pass, the default)",
    )
    ps.add_argument(
        "--presolve", action="store_true",
        help="host presolve before the general route: fixed vars, empty "
             "rows/cols, singleton rows, geometric-mean scaling",
    )
    ps.add_argument(
        "--fast", action="store_true",
        help="shorthand for --pricing-dtype bfloat16 --update-defer 16 "
             "--partial-pricing 8 --refactor-every 1024 --multi-price 64 "
             "(--multi-price under --pricing dantzig only); flags you set "
             "explicitly are kept",
    )
    ps.add_argument(
        "--log-level", default=None, choices=["debug", "info", "warning", "error"],
        help="log verbosity (also: SIMPLEX_TPU_LOG; SIMPLEX_TPU_LOG_JSON=1 for JSON lines)",
    )
    ps.add_argument("--algo", default="simplex", choices=["simplex", "pdhg"])
    ps.add_argument("--sparse", action="store_true", help="keep A scipy.sparse (MPS)")
    ps.set_defaults(fn=cmd_solve)
    args = ap.parse_args(argv)
    if args.log_level:
        from simplex_tpu_torch.logging import set_level

        set_level(args.log_level)
    _resolve_flag_defaults(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
