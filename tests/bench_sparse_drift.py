"""The bench-sparse recipe solved to OPTIMAL under steepest edge by both
packages on the CPU, dense and sparse A: status, pivots, z and feas_err of
each, to tell the float64 primal infeasibility a returned basis keeps
apart by package (the JAX reference against the port) and by storage.

``bench.py --mode sparse``'s instance ([A0 | I], A0's 128 x 128 tiles kept
with probability 0.1, uniform(0.2, 1.5) inside, ``default_rng(seed)``), as
``chip_smoke.py`` rebuilds it. Run from the repository root:

    JAX_PLATFORMS=cpu python -m tests.bench_sparse_drift 4096 8192
    JAX_PLATFORMS=cpu python -m tests.bench_sparse_drift 4096 8192 --refactor-every 1024
    JAX_PLATFORMS=cpu python -m tests.bench_sparse_drift 4096 8192 --solves "port dense,port sparse"

One line a solve: ``jax dense``, ``jax sparse`` (``BlockSparse``, backend
``xla``), ``port dense``, ``port sparse`` (scipy CSC), each with its
seconds. 4096 x 8192 takes minutes; ``tests/test_torch_sparse_core.py``
runs the same comparison at a test's size.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import scipy.sparse as sps

TILE, DENSITY = 128, 0.10
SOLVES = ("jax dense", "jax sparse", "port dense", "port sparse")


def bench_sparse_lp(m: int, n: int, seed: int = 0):
    """(A, b, c) of the bench-sparse recipe, float32."""
    rng = np.random.default_rng(seed)
    k = n - m
    gr, gc = -(-m // TILE), -(-k // TILE)
    mask = rng.uniform(size=(gr, gc)) < DENSITY
    if not mask.any():
        mask[0, 0] = True
    A0 = rng.uniform(0.2, 1.5, (m, k)).astype(np.float32)
    A0[~np.kron(mask, np.ones((TILE, TILE), bool))[:m, :k]] = 0.0
    A = np.hstack([A0, np.eye(m, dtype=np.float32)])
    b = (A0 @ rng.uniform(0.2, 0.8, k) + rng.uniform(0.1, 1.0, m)).astype(np.float32)
    c = np.concatenate([rng.uniform(0.5, 2, k), np.zeros(m)]).astype(np.float32)
    c[:k] *= (A0 != 0).any(axis=0)
    return A, b, c


def solve_both(A, b, c, refactor_every: int = 0, which=SOLVES, block=(TILE, TILE)) -> dict:
    """{solve name: (status, iters, z, feas_err, seconds)} under steepest
    edge; ``block`` is the JAX ``BlockSparse`` tile."""
    import simplex_tpu
    from simplex_tpu import sparse as bsp

    import simplex_tpu_torch as port

    jopts = dict(pricing="steepest", refactor_every=refactor_every)
    runs = {
        "jax dense": lambda: simplex_tpu.solve(A, b, c, options=simplex_tpu.SimplexOptions(**jopts)),
        "jax sparse": lambda: simplex_tpu.solve(
            bsp.from_dense(A, block_shape=block), b, c,
            options=simplex_tpu.SimplexOptions(backend="xla", **jopts)),
        "port dense": lambda: port.solve(A, b, c, options=port.SimplexOptions(**jopts), device="cpu"),
        "port sparse": lambda: port.solve(sps.csc_matrix(A), b, c, options=port.SimplexOptions(**jopts),
                                          device="cpu"),
    }
    out = {}
    for name in which:
        t0 = time.perf_counter()
        r = runs[name]()
        out[name] = (int(r.status), int(r.iters), float(r.z), float(r.feas_err), time.perf_counter() - t0)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("m", type=int)
    ap.add_argument("n", type=int)
    ap.add_argument("--refactor-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--solves", default=",".join(SOLVES), help="comma-separated subset of " + ", ".join(SOLVES))
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    A, b, c = bench_sparse_lp(args.m, args.n, args.seed)
    print(f"bench-sparse {args.m}x{args.n} seed {args.seed}: {np.count_nonzero(A)} nonzeros; steepest edge, "
          f"refactor_every={args.refactor_every}", flush=True)
    which = [w.strip() for w in args.solves.split(",")]
    for name, (status, iters, z, feas, sec) in solve_both(A, b, c, args.refactor_every, which).items():
        print(f"{name}: status {status} pivots {iters} z {z!r} feas_err {feas!r} ({sec:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
