"""Command-line interface.

Usage:
  python -m simplex_tpu_torch.cli solve INPUT [--device cuda] [--backend hopper|torch]

Reads an LP in the reference text format (``m n``, A, b, c) and prints the
optimum and the basic values keyed by column, as ``simplex_tpu.cli solve``
does. Exit code 0 on OPTIMAL, 2 on any other status, 1 on bad input.
"""

from __future__ import annotations

import argparse
import sys


def cmd_solve(args) -> int:
    from simplex_tpu_torch import SimplexOptions, SolveStatus, load_lp, solve

    try:
        A, b, c = load_lp(args.input)
    except (OSError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    opts = SimplexOptions(backend=args.backend)
    res = solve(A, b, c, options=opts, device=args.device)
    if res.status == SolveStatus.OPTIMAL:
        print(f"Optimum found: {res.z:g}")
        if res.feas_err > 1e-5:
            print(f"\twarning: primal infeasibility {res.feas_err:.2e}")
        for i in range(len(res.basis)):
            print(f"\tx_{int(res.basis[i])} = {res.x_b[i]:g}")
    else:
        print(res.status.describe())
    print(f"Pivots: {res.iters}")
    return 0 if res.status == SolveStatus.OPTIMAL else 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="simplex_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("solve", help="solve an LP from a file")
    ps.add_argument("input")
    ps.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ps.add_argument(
        "--backend", default="hopper", choices=["hopper", "torch"],
        help="hopper = the CUDA kernels, torch = plain PyTorch ops",
    )
    ps.set_defaults(fn=cmd_solve)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
