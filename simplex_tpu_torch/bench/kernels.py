"""Per-op kernel benchmarks: the counterpart of ``simplex_tpu.bench.kernels``.

Each op runs k times in a row, every application's input depending on the
previous one's output (as the JAX package's scans do), and the run is timed
with CUDA events; ``ms`` is the best of three runs over k. ``gbps`` is the
bytes the op must move (from its shapes) over that time. The ops, under the
JAX package's names:

  pricing_argmin         choose_entering over A (m, n) fp32: reads A once
  ftran                  B_inv @ a: reads B_inv once
  ratio_argmin           the classic ratio test, (m,) vectors
  rank1_update           B_inv += eta (x) row, in place: reads + writes B_inv
  pricing_segment_bf16   choose_entering over one of 8 column segments of
                         the bf16 shadow, a view priced in place
  flush_rankL_amortized  B_inv += U.T R with L = 16 pending pairs, divided
                         by L (one flush per L pivots)
  pricing_update2        steepest edge's (2, m) x (m, n) product, one pass
                         over A; ``pricing_update_two_mv`` is the same
                         function as two ``torch.mv`` calls (two passes)
  steepest_u             alpha . B_inv, steepest edge's extra O(m^2) pass
  ranging_W              ranging's (m, m) x (m, n) product B_inv . A, once
  bsp_matvec_density*    A x and y . A over a sparse A (the JAX package's
  bsp_rmatvec_density*   block-sparse ops; here :mod:`simplex_tpu_torch.
                         sparse`'s CSR SpMVs): A's 128 x 128 tiles kept with
                         probability 0.1 and stored whole, as the JAX
                         bench's; bytes = nnz x 8 (value, index) + the row
                         pointers and the two vectors

The products are library calls in full fp32 on both backends (the JAX
package leaves them to XLA): they are timed here, not replaced.

In float64 on the hopper backend a second line times pricing's one-call
form in both of its layouts, stream and split, with the library call
beside them, which the port never makes, ``torch.mv(A.T, y)`` (the
product alone; :func:`layout_ops`); in turns (new, old, old, new), ms a
call.

``--device-time`` adds, from a ``torch.profiler`` trace of the same loops,
the device time of one launch of each ratio kernel (``ratio_argmin``,
``ratio_eta`` with its tail off): between events those two are bound by the
host's launch rate, not by the card; with the second line, also the device
time of one call of each of its cases (:func:`layout_device_us`). It runs
last: after a profiler run every later launch of the process costs more
host time.

``backend`` is ``"hopper"`` (the CUDA kernels) or ``"torch"`` (plain
PyTorch); the sparse products are cuSPARSE on both. ``dtype`` is the
working type of A, B_inv and the vectors, float32 (the default) or
float64 (bytes count its width; the bf16 segment stays bf16). Inputs are
random, from a fixed seed, made on the device (the sparse matrix's
pattern and values on the host).

    python -m simplex_tpu_torch.bench.kernels [--m 8192 --n 16384 --k 32]
        [--backend hopper|torch] [--dtype float32|float64] [--device cuda]
        [--device-time]
"""

from __future__ import annotations

import json
from typing import Callable, Dict

import torch

import numpy as np

from simplex_tpu_torch import sparse as _sp
from simplex_tpu_torch.bench.timing import elapsed_ms
from simplex_tpu_torch.kernels.dispatch import get_backend

SEGMENTS = 8  # bench.py's partial_pricing
PENDING = 16  # bench.py's update_defer


def bench_ops(
    m: int, n: int, k: int = 32, backend: str = "hopper", device="cuda",
    dtype: torch.dtype = torch.float32,
) -> Dict[str, dict]:
    """Time the pivot's ops at (m, n) in ``dtype``. Returns ``{op: {"ms",
    "gbps"}}``, ``ms`` per application."""
    be = get_backend(backend)
    dev = torch.device(device)
    w8 = torch.finfo(dtype).bits // 8  # bytes an element
    g = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn(m, n, generator=g, device=dev, dtype=dtype)
    B = torch.randn(m, m, generator=g, device=dev, dtype=dtype) * 0.01
    c = torch.randn(n, generator=g, device=dev, dtype=dtype)
    y0 = torch.randn(m, generator=g, device=dev, dtype=dtype)
    basis = torch.arange(m, dtype=torch.int32, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    results: Dict[str, dict] = {}

    def record(name: str, loop: Callable[[], object], nbytes: float, per: int = k) -> float:
        loop()  # warm-up (and the kernels' build)
        ms = min(elapsed_ms(loop, dev) for _ in range(3)) / per
        results[name] = {"ms": round(ms, 4), "gbps": round(nbytes / ms / 1e6, 1)}
        return ms

    def pricing_loop(Aa, ca, segments=1):
        w = Aa.shape[1] // segments
        yc = y0
        for i in range(k):
            lo = (i % segments) * w
            p, min_e = be.choose_entering(yc, Aa[:, lo : lo + w], ca[lo : lo + w], 1e-6, no)
            # fold the result back into y: each pass waits for the last
            yc = yc + min_e * 1e-20 + p.to(dtype) * 0
        return yc

    record("pricing_argmin", lambda: pricing_loop(A, c), w8 * m * n)

    def ftran_loop():
        cc = y0
        for _ in range(k):
            alpha = B @ cc
            cc = alpha / (alpha.abs().max() + 1)
        return cc

    record("ftran", ftran_loop, w8 * m * m)

    def ratio_loop():
        xc, al = y0.abs(), y0
        for _ in range(k):
            q, theta, _ = be.ratio_argmin(xc, al, basis, 1e-7, no)
            xc = xc + theta * 1e-20 + q.to(dtype) * 0
        return xc

    record("ratio_argmin", ratio_loop, (2 * w8 + 4) * m)

    def rank1_loop():
        for _ in range(k):
            # row as a copy: the update is in place
            be.rank1_update(B, B[0] * 1e-6, B[1].clone())
        return B

    record("rank1_update", rank1_loop, 2 * w8 * m * m)

    if n % SEGMENTS == 0:
        Ab = A.to(torch.bfloat16)
        record(
            "pricing_segment_bf16",
            lambda: pricing_loop(Ab, c, SEGMENTS),
            2 * m * (n // SEGMENTS),
        )
        del Ab

    U = torch.randn(PENDING, m, generator=g, device=dev, dtype=dtype) * 1e-3
    R = torch.randn(PENDING, m, generator=g, device=dev, dtype=dtype) * 1e-3

    def flush_loop():
        for _ in range(k):
            B.addmm_(U.T, R, alpha=1e-20)
        return B

    # amortized: one flush per PENDING pivots
    record("flush_rankL_amortized", flush_loop, 2 * w8 * m * m / PENDING, per=k * PENDING)

    rho0 = torch.randn(m, generator=g, device=dev, dtype=dtype)

    def update2_loop(fused: bool):
        rc, uc = rho0, y0
        for _ in range(k):
            if fused:
                w, v = be.pricing_update2(A, rc, uc)
            else:
                w, v = torch.mv(A.T, rc), torch.mv(A.T, uc)
            rc = rc + (w[0] + v[0]) * 1e-20
        return rc

    record("pricing_update2", lambda: update2_loop(True), w8 * m * n)
    record("pricing_update_two_mv", lambda: update2_loop(False), 2 * w8 * m * n)

    def steepest_u_loop():
        ac = y0
        for _ in range(k):
            u = ac @ B
            ac = ac + u * 1e-20
        return ac

    record("steepest_u", steepest_u_loop, w8 * m * m)

    W = None

    def ranging_loop():
        nonlocal W
        W = B @ A
        return W

    ms = record("ranging_W", ranging_loop, w8 * (m * m + 2 * m * n), per=1)
    results["ranging_W"]["tflops"] = round(2.0 * m * m * n / ms / 1e9, 2)
    del W

    M, density = tile_sparse(m, n, dev, dtype=dtype)
    x0 = torch.randn(n, generator=g, device=dev, dtype=dtype)

    def sp_mv_loop():
        xc = x0
        for _ in range(k):
            xc = xc + torch.nn.functional.pad(_sp.matvec(M, xc), (0, n - m)) * 1e-20
        return xc

    def sp_rmv_loop():
        yc = y0
        for _ in range(k):
            yc = yc + _sp.rmatvec(M, yc)[:m] * 1e-20
        return yc

    stored = (w8 + 4) * M.nnz + w8 * (m + n)
    record(f"bsp_matvec_density{density:.2f}", sp_mv_loop, stored + 4 * (m + 1))
    record(f"bsp_rmatvec_density{density:.2f}", sp_rmv_loop, stored + 4 * (n + 1))
    return results


def tile_sparse(m: int, n: int, device, density: float = 0.10, seed: int = 0,
                dtype: torch.dtype = torch.float32):
    """``(SparseA, tile density)``: an (m, n) ``dtype`` matrix whose 128 x
    128 tiles are kept with probability ``density`` (at least one) and
    stored whole, with standard normal values: the JAX bench's structured
    pattern."""
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(max(1, m // 128), max(1, n // 128))) < density
    if not mask.any():
        mask[0, 0] = True
    tr, tc = np.nonzero(mask)
    ii, jj = np.divmod(np.arange(128 * 128), 128)
    rows = (tr[:, None] * 128 + ii[None, :]).ravel()
    cols = (tc[:, None] * 128 + jj[None, :]).ravel()
    keep = (rows < m) & (cols < n)
    vals = rng.standard_normal(int(keep.sum()))
    coo = sps.coo_matrix((vals, (rows[keep], cols[keep])), shape=(m, n))
    return _sp.from_scipy(coo, dtype, device), float(mask.mean())


def ratio_device_us(
    m: int, k: int = 200, device="cuda", dtype: torch.dtype = torch.float32
) -> Dict[str, float]:
    """Device microseconds of ONE launch of each ratio kernel at m rows in
    ``dtype``, from a ``torch.profiler`` trace of k chained launches:
    ``ratio_argmin`` (the classic test) and ``ratio_eta`` with its tail off
    (classic, and Harris)."""
    from torch.profiler import ProfilerActivity, profile

    from simplex_tpu_torch.kernels import hopper

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(m, generator=g, device=dev, dtype=dtype)
    al = torch.randn(m, generator=g, device=dev, dtype=dtype)
    basis = torch.arange(m, dtype=torch.int32, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    loops = {
        "ratio_argmin": lambda xc: hopper.ratio_argmin(xc, al, basis, 1e-7, no)[1],
        "ratio_eta, classic, tail off": lambda xc: hopper.ratio_eta(xc, al, basis, 1e-7, no, False)[1],
        "ratio_eta, harris, tail off": lambda xc: hopper.ratio_eta(xc, al, basis, 1e-7, no, True)[1],
    }
    out = {}
    for name, fn in loops.items():
        fn(x)  # build, first launch
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            xc = x
            for _ in range(k):
                xc = xc + fn(xc) * 1e-20
            torch.cuda.synchronize(dev)
        hits = [
            e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and ("ratio_argmin_kernel" in e.key or "pivot_tail_kernel" in e.key)
        ]
        # the trace may miss a launch or two at its start: divide by the
        # launches it did record
        if len(hits) != 1 or not k // 2 <= hits[0].count <= k:
            raise RuntimeError(f"{name}: expected about {k} launches of one kernel in the trace, got "
                               f"{[(e.key[:40], e.count) for e in hits]}")
        t = getattr(hits[0], "self_device_time_total", None)
        out[name] = (hits[0].self_cuda_time_total if t is None else t) / hits[0].count
    return out


def _layout_calls(m: int, n: int, device) -> Dict[str, Callable[[], object]]:
    """name -> one call, on fixed float64 inputs at (m, n): each layout of
    ``pricing_scan`` (the one-call form, basic-column mask in) and the
    library call beside them."""
    from simplex_tpu_torch.kernels import hopper

    dev = torch.device(device)
    d = torch.float64
    g = torch.Generator(device=dev).manual_seed(0)
    y = torch.randn(m, generator=g, device=dev, dtype=d)
    A = torch.randn(m, n, generator=g, device=dev, dtype=d)
    c = torch.randn(n, generator=g, device=dev, dtype=d)
    basis = torch.randperm(n, generator=g, device=dev)[:m].to(torch.int32)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    calls = {
        f"pricing {lay}": (lambda lay=lay: hopper._pricing_call(y, A, c, 1e-9, None, basis, 0, no, 0, None, lay))
        for lay in ("stream", "split")
    }
    calls["torch.mv(A.T, y)"] = lambda: torch.mv(A.T, y)
    return calls


def layout_ops(m: int, n: int, k: int = 32, device="cuda") -> Dict[str, dict]:
    """ms a call of each of :func:`_layout_calls`' cases, k calls between
    CUDA events, in turns (forward, then backward: parent and change on
    one card alike), the best of the two passes and both runs."""
    dev = torch.device(device)
    calls = _layout_calls(m, n, dev)
    runs: Dict[str, list] = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            fn = calls[name]
            fn()  # warm-up (and the kernels' build)
            runs[name].append(elapsed_ms(lambda: [fn() for _ in range(k)], dev) / k)
    return {name: {"ms": round(min(v), 4), "ms_runs": [round(t, 4) for t in v]} for name, v in runs.items()}


def layout_device_us(m: int, n: int, k: int = 20, device="cuda") -> Dict[str, float]:
    """Device microseconds of ONE call of each of :func:`_layout_calls`'
    cases, from a ``torch.profiler`` trace of k calls: every device kernel
    of a call summed (the split layout launches two)."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device)
    out = {}
    for name, fn in _layout_calls(m, n, dev).items():
        fn()
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(k):
                fn()
            torch.cuda.synchronize(dev)
        out[name] = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA) / k
    return out


def record_line(m: int, n: int, backend: str, device, ops: Dict[str, dict],
                dtype: torch.dtype = torch.float32) -> str:
    """The bench's JSON line: shape, backend, dtype, the card's name, the
    ops and their summed per-pivot milliseconds."""
    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    total_ms = round(sum(v["ms"] for v in ops.values()), 3)
    return json.dumps(
        {"m": m, "n": n, "backend": backend, "dtype": str(dtype).removeprefix("torch."),
         "device": name, "ops": ops, "total_pivot_ms": total_ms}
    )


def main(argv=None) -> None:
    import argparse
    import sys

    ap = argparse.ArgumentParser(prog="python -m simplex_tpu_torch.bench.kernels")
    ap.add_argument("--m", type=int, default=8192)
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--backend", default="hopper", choices=["hopper", "torch"])
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--device-time", action="store_true",
                    help="also trace the ratio kernels' device time per launch")
    args = ap.parse_args(argv)
    # full fp32 products, as in solve()
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    res = bench_ops(args.m, args.n, args.k, args.backend, args.device, dtype)
    print(record_line(args.m, args.n, args.backend, args.device, res, dtype))
    layouts = dtype == torch.float64 and args.backend == "hopper"
    if layouts:
        lay = layout_ops(args.m, args.n, args.k, args.device)
        print(json.dumps({"m": args.m, "n": args.n, "dtype": args.dtype, "layouts": lay}))
    if args.device_time:
        us = ratio_device_us(args.m, device=args.device, dtype=dtype)
        print(json.dumps({"m": args.m, "dtype": args.dtype, "device_us_per_launch": us}))
        if layouts:
            us = layout_device_us(args.m, args.n, device=args.device)
            print(json.dumps({"m": args.m, "n": args.n, "dtype": args.dtype, "layouts_device_us": us}))
    total_ms = sum(v["ms"] for v in res.values())
    print(f"-> {1000.0 / total_ms:.0f} pivots/s roofline from phases", file=sys.stderr)


if __name__ == "__main__":
    main()
