#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``simplex_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

  1. print the card's name and power limit; build the three CUDA kernels
     from ``simplex_tpu_torch/csrc`` with nvcc for sm_90a;
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes (8192 x 16384, m = 8192) and at odd shapes, timed with
     CUDA events beside the plain version;
  3. ``simplex_tpu_torch.solve`` through its normal entry point: the sample
     LP (z = 9), a 2048 x 4096 random LP against HiGHS, and the benchmark's
     8192 x 16384 instance over its 512-pivot window, where every pivot step
     must launch each kernel once;
  4. the same 8192 x 16384 instance solved to OPTIMAL, checked in f64
     without an oracle (HiGHS needs minutes at this size).

The last lines are the kernels' JSON record, the card's ``nvidia-smi``
line and ``{"ok": true, "device": {...}}``. Without a CUDA device, or run
outside a checkout of the repository, the script exits non-zero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BENCH_M, BENCH_N = 8192, 16384  # bench.py's instance: random_dense_lp(m, n, seed=0)
BENCH_WINDOW = 512  # bench.py's pivot budget

# tolerances, each with its reason
PRICING_RTOL = 1e-5  # fp32 sums of 8192 terms taken in another order
RANK1_ATOL = 1e-5  # the plain ger may fuse multiply-add; the kernel does not
RATIO_ATOL = 0.0  # same IEEE ops in the same order: bitwise equal
GAP_TOL = 1e-5  # fp32 solve against HiGHS in f64 (the JAX package's gate)

SOURCES = {
    "pricing_scan": "simplex_tpu_torch/csrc/pricing_scan.cu",
    "ratio_eta": "simplex_tpu_torch/csrc/ratio_eta.cu",
    "rank1_update": "simplex_tpu_torch/csrc/rank1_update.cu",
}
REPLACES = {
    "pricing_scan": "simplex_tpu/kernels/pallas_ops.py:140",
    "ratio_eta": "simplex_tpu/kernels/pallas_ops.py:323",
    "rank1_update": "simplex_tpu/kernels/pallas_ops.py:374",
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_build() -> None:
    from simplex_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    path, log = _build.build(verbose=True)
    _build.load_library()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line or "error" in line:
            print("  ptxas:", line.strip())


def phase_pricing(dev) -> dict:
    import torch

    from simplex_tpu_torch.kernels import hopper

    g = torch.Generator(device=dev).manual_seed(0)
    rec = {}
    for m, n in ((BENCH_M, BENCH_N), (BENCH_M - 1, BENCH_N - 1)):
        y = torch.randn(m, generator=g, device=dev)
        A = torch.randn(m, n, generator=g, device=dev)
        c = torch.randn(n, generator=g, device=dev)
        eps = 1e-5
        min_k, p_k, neg_k = hopper.pricing_scan(y, A, c, eps)
        min_p, p_p, neg_p = hopper.pricing_scan_plain(y, A, c, eps)
        e = (y @ A) - c
        torch.cuda.synchronize()
        min_k, p_k, neg_k = float(min_k), int(p_k), int(neg_k)
        min_p = float(min_p)
        err = abs(min_k - min_p)
        check(err <= PRICING_RTOL * abs(min_p), f"pricing {m}x{n}: min {min_k} vs {min_p}")
        check(
            abs(float(e[p_k]) - min_p) <= PRICING_RTOL * abs(min_p),
            f"pricing {m}x{n}: e[p_kernel={p_k}] = {float(e[p_k])} vs min {min_p} (plain p {int(p_p)})",
        )
        check(neg_k == int(neg_p), f"pricing {m}x{n}: first negative {neg_k} vs {int(neg_p)}")
        # an exact tie across blocks: e = -c with equal minima at 40 and
        # n - 100; the lowest index must win
        c_tie = torch.zeros(n, device=dev)
        c_tie[40] = 5.0
        c_tie[n - 100] = 5.0
        _, p_tie, neg_tie = hopper.pricing_scan(torch.zeros_like(y), A, c_tie, eps)
        check(int(p_tie) == 40 and int(neg_tie) == 40, f"pricing tie: {int(p_tie)}, {int(neg_tie)}")
        print(f"pricing_scan {m}x{n}: min_e {min_k:.6f} (plain {min_p:.6f}) p {p_k} abs err {err:.3e}")
        if (m, n) == (BENCH_M, BENCH_N):
            rec = {
                "max_abs_err": err,
                "ms": time_ms(lambda: hopper.pricing_scan(y, A, c, eps)),
                "plain_ms": time_ms(lambda: hopper.pricing_scan_plain(y, A, c, eps)),
            }
        del A
    return rec


def phase_ratio_eta(dev) -> dict:
    import torch

    from simplex_tpu_torch.kernels import hopper

    g = torch.Generator(device=dev).manual_seed(1)
    rec = {}
    worst = 0.0
    for m in (BENCH_M, BENCH_M - 1):
        x_b = torch.rand(m, generator=g, device=dev) * 2
        x_b[::7] = 0.0  # degenerate rows: exact ratio ties at theta = 0
        alpha = torch.randn(m, generator=g, device=dev)
        basis = torch.randperm(m, generator=g, device=dev).to(torch.int32)
        cases = [
            (harris, bland, alpha)
            for harris in (True, False)
            for bland in (False, True)
        ] + [(True, False, -alpha.abs() - 1), (False, True, -alpha.abs() - 1)]
        for harris, bland, a in cases:
            flag = torch.tensor(bland, device=dev)
            got = hopper.ratio_eta(x_b, a, basis, 1e-7, flag, harris, 1e-6)
            want = hopper.ratio_eta_plain(x_b, a, basis, 1e-7, flag, harris, 1e-6)
            torch.cuda.synchronize()
            tag = f"ratio_eta m={m} harris={harris} bland={bland} unbounded-case={a is not alpha}"
            check(int(got[0]) == int(want[0]), f"{tag}: q {int(got[0])} vs {int(want[0])}")
            check(bool(got[2]) == bool(want[2]), f"{tag}: unbounded {bool(got[2])} vs {bool(want[2])}")
            check(bool(got[2]) == (a is not alpha), f"{tag}: unbounded flag wrong")
            tk, tp = float(got[1]), float(want[1])
            check(tk == tp, f"{tag}: theta_q {tk} vs {tp}")
            err = max(
                float((got[3] - want[3]).abs().max()),
                float((got[4] - want[4]).abs().max()),
            )
            check(err <= RATIO_ATOL, f"{tag}: eta / x_b_new differ by {err}")
            worst = max(worst, err)
            print(f"{tag}: q {int(got[0])} theta_q {tk:.6g} ok")
        if m == BENCH_M:
            flag = torch.tensor(False, device=dev)
            rec = {
                "ms": time_ms(lambda: hopper.ratio_eta(x_b, alpha, basis, 1e-7, flag, True), 200),
                "plain_ms": time_ms(
                    lambda: hopper.ratio_eta_plain(x_b, alpha, basis, 1e-7, flag, True), 200
                ),
            }
    rec["max_abs_err"] = worst
    return rec


def phase_rank1(dev) -> dict:
    import torch

    from simplex_tpu_torch.kernels import hopper

    g = torch.Generator(device=dev).manual_seed(2)
    rec = {}
    worst = 0.0
    for m in (BENCH_M, BENCH_M - 1):
        B = torch.randn(m, m, generator=g, device=dev)
        eta = torch.randn(m, generator=g, device=dev)
        row = B[m // 3].clone()
        got = hopper.rank1_update(B.clone(), eta, row)
        want = hopper.rank1_update_plain(B.clone(), eta, row)
        err = float((got - want).abs().max())
        check(err <= RANK1_ATOL, f"rank1_update m={m}: max abs err {err}")
        try:
            hopper.rank1_update(B, eta, B[m // 3])
        except ValueError:
            pass
        else:
            raise AssertionError("rank1_update accepted a row that aliases B_inv")
        worst = max(worst, err)
        print(f"rank1_update m={m}: max abs err {err:.3e}")
        if m == BENCH_M:
            small = eta * 1e-6
            rec = {
                "ms": time_ms(lambda: hopper.rank1_update(B, small, row)),
                "plain_ms": time_ms(lambda: hopper.rank1_update_plain(B, small, row)),
            }
        del B, got, want
    rec["max_abs_err"] = worst
    return rec


def phase_solve(dev) -> dict:
    import numpy as np
    import torch

    from simplex_tpu_torch import SolveStatus, load_lp, solve
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle.generator import random_dense_lp
    from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy

    A, b, c = load_lp(ROOT / "tests" / "data" / "sample.txt")
    res = solve(A, b, c, device=dev)
    check(res.status == SolveStatus.OPTIMAL, f"sample: {res.status!r}")
    check(abs(res.z - 9.0) < 1e-5, f"sample: z = {res.z}")
    check(np.allclose(res.x, [1, 3, 0, 0], atol=1e-5), f"sample: x = {res.x}")
    print(f"sample.txt: OPTIMAL z {res.z} x {res.x.tolist()} pivots {res.iters}")

    A, b, c = random_dense_lp(2048, 4096, seed=0)
    t0 = time.perf_counter()
    res = solve(A, b, c, device=dev)
    wall = time.perf_counter() - t0
    ref = solve_scipy(A, b, c)
    gap = relative_gap(res.z, ref.z)
    check(res.status == SolveStatus.OPTIMAL, f"2048x4096: {res.status!r}")
    check(gap <= GAP_TOL, f"2048x4096: rel gap {gap:.3e} vs HiGHS")
    print(
        f"random_dense_lp(2048, 4096, seed=0): OPTIMAL z {res.z!r} HiGHS {ref.z!r} "
        f"rel_gap {gap:.3e} feas_err {res.feas_err:.3e} pivots {res.iters} wall {wall:.2f} s"
    )

    A, b, c = random_dense_lp(BENCH_M, BENCH_N, seed=0)
    from simplex_tpu_torch import SimplexOptions

    opts = SimplexOptions(max_iter=BENCH_WINDOW)
    torch.cuda.synchronize()
    hopper.reset_launches()
    t0 = time.perf_counter()
    res = solve(A, b, c, options=opts, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(hopper.launches)
    check(res.status == SolveStatus.MAX_ITER, f"{BENCH_M}x{BENCH_N}: {res.status!r}")
    check(res.iters == BENCH_WINDOW, f"{BENCH_M}x{BENCH_N}: {res.iters} pivots")
    for name, n_launch in counts.items():
        check(n_launch == BENCH_WINDOW, f"{name}: {n_launch} launches in {BENCH_WINDOW} pivot steps")
    A_d = torch.as_tensor(A, device=dev)
    basis = torch.as_tensor(res.basis.astype(np.int64), device=dev)
    x_b = torch.as_tensor(res.x_b, device=dev).double()
    resid = float(
        (A_d.index_select(1, basis).double() @ x_b - torch.as_tensor(b, device=dev).double())
        .abs()
        .max()
    )
    print(
        f"random_dense_lp({BENCH_M}, {BENCH_N}, seed=0), max_iter={BENCH_WINDOW}: "
        f"{res.status.name} after {res.iters} pivots in {wall:.3f} s "
        f"({res.iters / wall:.1f} pivots/s end to end, setup and polish included); "
        f"z {res.z!r}; f64 residual |A_B x_b - b|_inf {resid:.3e}; launches {counts}"
    )
    return counts


def phase_full_solve(dev) -> None:
    """The benchmark instance solved to OPTIMAL, checked in f64 without an
    oracle: primal residual and sign, dual feasibility (reduced costs of
    the f64 duals of the returned basis) and the duality gap."""
    import numpy as np
    import torch

    from simplex_tpu_torch import SolveStatus, solve
    from simplex_tpu_torch.oracle.generator import random_dense_lp

    A, b, c = random_dense_lp(BENCH_M, BENCH_N, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(A, b, c, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(res.status == SolveStatus.OPTIMAL, f"full solve: {res.status!r}")
    A64 = torch.as_tensor(A, device=dev).double()
    b64 = torch.as_tensor(b, device=dev).double()
    c64 = torch.as_tensor(c, device=dev).double()
    basis = torch.as_tensor(res.basis.astype(np.int64), device=dev)
    A_B = A64.index_select(1, basis)
    x_b = torch.linalg.solve(A_B, b64)
    y = torch.linalg.solve(A_B.T, c64.index_select(0, basis))
    d = y @ A64 - c64  # reduced costs; optimal iff all >= -eps
    resid = float((A_B @ torch.as_tensor(res.x_b, device=dev).double() - b64).abs().max())
    cx = float(c64.index_select(0, basis) @ x_b)
    yb = float(y @ b64)
    min_d = float(d.min())
    # dual feasibility is the optimality test the solve certified; primal
    # infeasibility of order feas_tol and above is reported, not refused
    # (the Harris ratio test trades it for pivot size)
    check(min_d >= -1e-5, f"full solve: min reduced cost {min_d}")
    print(
        f"full solve random_dense_lp({BENCH_M}, {BENCH_N}, seed=0): OPTIMAL z {res.z!r} "
        f"after {res.iters} pivots in {wall:.2f} s ({res.iters / wall:.1f} pivots/s); "
        f"f64 KKT: |A_B x_b - b|_inf {resid:.3e}, min x_b {float(x_b.min()):.3e}, "
        f"min reduced cost {min_d:.3e}, y.b - c.x {yb - cx:.3e}, feas_err {res.feas_err:.3e}"
    )


def main() -> int:
    if not (ROOT / "simplex_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    phase_build()
    recs = {
        "pricing_scan": phase_pricing(dev),
        "ratio_eta": phase_ratio_eta(dev),
        "rank1_update": phase_rank1(dev),
    }
    torch.cuda.empty_cache()
    counts = phase_solve(dev)
    phase_full_solve(dev)

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": counts[name],
            **recs[name],
        }
        for name in SOURCES
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
