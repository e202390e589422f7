#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``simplex_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

  1. print the card's name and power limit; build the seven CUDA kernels
     from ``simplex_tpu_torch/csrc`` with nvcc for sm_90a (one process per
     source, side by side);
  2. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes (8192 x 16384, m = 8192; the bf16 shadow and a strided
     column segment of it for pricing), at the general route's (1088 x
     67648 for pricing, m = 1088 and 4352 for ratio_eta and rank1_update;
     pricing's signed mode, the bounded rule's, at 1088 x 4160 and 4352 x
     16640 on fp32 A, the shadow and a segment) and at odd shapes, timed
     with CUDA events beside the plain version. Pricing is held in both
     forms: the three-output scan, and the one-call form the step uses
     (basic-column mask, choice and segment offset made by the kernel).
     ratio_eta's cluster kernel is held with its tail off (the old
     contract) and on (``pivot_tail``: eager, and deferred with pending
     pairs), at one block, several, and beyond 8 x 1024 rows;
     ``ratio_argmin``'s cluster kernel at the same row counts, bit for bit.
     The three batched kernels against their plain twins:
     pricing at ``bench.py --mode batch``'s 4,096 x 64 x 160 (fp32, the
     bf16 shadow, the signed mode, Bland's choice), odd and multi-chunk
     shapes and 8 x 2048 x 4096 (1.2e-4 of scale, every pick equal); the
     shared-A layout (the tiled product) at 1 x 1 x 1, 3 x 17 x 45, 65 x 33
     x 129, 130 x 257 x 1000, 130 x 260 x 1000, 129 x 36 x 130, 129 x 33 x
     65 (a tail on every axis of the fp32 and the float64 tile, with and
     without 16-byte copies) and the warm re-solve's 256 x 2048 x
     4096, and bit for bit against the per-instance path on the same A
     expanded (8 x 2048 x 4096, 70 x 33 x 300); its window mode (segmented
     pricing) on every layout the plan gives it (the bulk-copy scan, the
     scan and four-column kernels where shapes or a misaligned base forbid
     bulk copies, a shared A grouped by window on 16-byte copies and on
     element loads), each case printed with its layout and bit for bit the
     call on each instance's slice, and the grouping against its plain
     twin; the tail and rank-1 bit for
     bit at 4,096 x 64, 3 x 17, 8 x 2048 and 37 x 1100 and, for the tail,
     both of its paths (one warp an instance up to 256 rows, rows a lane
     1 to 8, misaligned loads; one block an instance beyond, and forced at
     small m), eager and deferred, finished instances mixed in; rank-1 and
     the tail timed also at the warm re-solve's 256 x 2048. The four
     single-card kernels again in float64: pricing at 8192 x 16384, 8191 x
     16383, 9000 x 1001 and 24 x 4099 (every pick equal, min_e within
     1e-12), an exact tie, the strided segment view (aligned and not), the
     bf16 shadow with float64 y and c, the signed mode at the bounded
     route's shapes; ``ratio_eta`` (tail off), ``ratio_argmin`` and
     ``pivot_tail`` eager bit for bit, deferred within 1e-12, at m = 17,
     1024, 1025, 8192, 9000; ``rank1_update`` bit for bit the unfused B +
     outer(eta, row) on the whole inverse and on row blocks; each timed
     beside its plain version, its library call and its bound; and the
     three batched kernels in float64 at the float32 checks' shapes and
     layouts (bit for bit where float32 is, min_e within 1e-12 of scale),
     after the sum-order probe (``bench/dmma_probe.py``: every f64 shape of
     ``mma.sync`` against the ascending fma chain on 2^20 random tiles and
     adversarial ones, a verdict printed a shape; the shape the float64
     shared layouts run on must equal the chain);
  3. ``simplex_tpu_torch.solve`` through its normal entry point with the
     default options: the sample LP (z = 9), a 2048 x 4096 random LP
     against HiGHS, and the benchmark's 8192 x 16384 instance over its
     512-pivot window, where every pivot step must launch each of its
     kernels once; then the same instance solved to OPTIMAL, checked in
     f64 without an oracle (HiGHS needs minutes at this size). Then in
     float64 under the default options (the kernels' float64
     instantiations): the sample, Beale's cycler under both ratio tests,
     the Klee-Minty ladder at n = 4, 6, 8 (2^n - 1 Dantzig pivots, 1
     steepest-edge pivot, devex fewer), the structured corpus and every
     MPS fixture through ``solve_general`` against HiGHS at 1e-6,
     2048 x 4096 against HiGHS at 1e-9, the 512-pivot window and the
     solve to OPTIMAL at 8192 x 16384 (the f64 KKT check; feas_err beside
     the fp32 solve's), and every other single-card entry point at 2048 x
     4096: the flagship with and without multiple pricing, devex, steepest
     edge eager and deferred, sparse A, ``reoptimize``, ``ranging``,
     ``trace_pivots``, ``solve_with_checkpoints`` stopped and resumed,
     ``solve_general`` with presolve on multiperiod (32, 16) and ``cli
     solve --fp64``; each default step launching its three kernels once;
  4. the flagship option set ``bench.py`` runs (bf16 shadow, partial
     pricing 8, deferred updates 16, multiple pricing 64, and the same with
     multiple pricing off) over the 512-pivot window, with launch counts
     and host reads per pivot; then flagship solves to OPTIMAL: 2048 x 4096
     against HiGHS and 8192 x 16384 with an f64 check;
  5. the per-op bench (``simplex_tpu_torch.bench.kernels``) on both
     backends, which is the path that runs ``ratio_argmin``, and in
     float64 on the hopper backend;
  6. the general-form route: every ``tests/data/*.mps`` through the port's
     CLI on the card; ``solve_general`` on ``multiperiod_production_lp``
     at (64, 16) and (96, 16) (every column bounded: the native-bounds
     rule in phase 2) under the default options and ``bench.py --mode
     general``'s, each with and without presolve; and on
     ``transportation_lp(64, 1024, balanced=False)`` (no bounds: the
     kernels run in both phases). Each run is held against HiGHS and
     prints its stage times and its launches per phase;
  7. the pricing rules: the 2048 x 4096 instance under devex and steepest
     edge against HiGHS; the 8192 x 16384 instance under steepest edge,
     eager and with ``update_defer=16``, over the 512-pivot window (the
     tail launches ``ratio_eta`` once a pivot step, eager updates launch
     ``rank1_update`` once a pivot step; reads a pivot) and to OPTIMAL with
     the f64 KKT check (the final exact passes launch ``pricing_scan``);
  8. warm restarts at both sizes from the default solve's result (the one
     phase 3 already has): ``ranging``, then ``reoptimize`` with one b_i
     moved inside its allowable range (0 dual pivots, the same basis) and
     past it (dual pivots, OPTIMAL; z against HiGHS at 2048 x 4096, the
     f64 KKT check at 8192 x 16384); the dual loop launches
     ``rank1_update`` once a dual pivot. Where the cold basis is primal
     infeasible beyond the dual loop's tolerance (the default path's Harris
     test leaves 1e-4 at 8192 x 16384), one ``reoptimize`` on the unchanged
     b repairs it first, and the ranges are those of the repaired basis;
  9. the general route's warm restart: ``solve_general`` on
     ``multiperiod_production_lp(96, 16)`` again with ``warm=`` the token of
     phase 6's run and every b_i moved by up to 5%, against HiGHS;
 10. the pivot trace (``core.trace``): ``tests/data/sample.txt`` along its
     known path (entering 0 then 1, leaving 3 then 2, z 7.5 then 9), and
     256 pivots of the 2048 x 4096 instance, whose basis after pivot k
     equals ``solve(max_iter=k)``'s, with the trace's pivots/s;
 11. checkpoint / resume (``core.checkpoint``): the 8192 x 16384 instance
     under steepest edge through ``solve_with_checkpoints`` in chunks of 512
     pivots with light snapshots, stopped after two chunks and resumed in a
     fresh call to OPTIMAL within 1e-5 of the uninterrupted solve (phase
     7's); the same at 2048 x 4096 (default options) with full snapshots
     against HiGHS; save and load seconds and the snapshot sizes;
 12. the CLI's ``verify``, ``analyze --reoptimize`` and ``trace`` on
     ``tests/data/sample.txt`` and every ``tests/data/*.mps``, each with the
     JAX CLI's exit code (0, but 2 where the instance is unbounded or the
     re-solve infeasible, and 1 for ``trace`` on a general-route input,
     which the reference refuses); ``solve --sparse`` on every MPS file
     against HiGHS;
 13. sparse A: ``bench.py --mode sparse``'s instance rebuilt from its
     recipe ([A0 | I], A0's 128 x 128 tiles kept with probability 0.1,
     ``default_rng(0)``) at 8192 x 16384, solved sparse and dense over the
     512-pivot window under the default options (as ``bench.py --mode
     sparse`` runs it: Dantzig's path there is longer than 1.2 M pivots);
     the same recipe at 2048 x 4096 solved sparse and dense to OPTIMAL
     under steepest edge against HiGHS (same status, z within 1e-5, the
     f64 KKT check of both answers: dual feasible, primal infeasible by at
     most ``MAX_PRIMAL_INFEAS``); for each run pivots, seconds, host reads and
     device syncs a pivot, which the sparse loop keeps at or under 1.05;
     the sparse and the dense pricing pass timed side by side; general C
     and B with A as scipy CSC against HiGHS; one sparse ``ranging`` +
     ``reoptimize`` at 2048 x 4096 against the dense ranges and HiGHS;
 14. a profiled stretch of the default path's pivot loop on the 8192 x
     16384 instance, which must stay under ``MAX_DEVICE_OPS_PER_PIVOT``
     device operations a pivot and launch each solve-path kernel once a
     pivot (after the trace has run), in fp32 and in float64; the ratio
     kernels' device time a launch in both; the same stretch of the sparse
     default path on phase 13's instance, and the device time of one
     sparse and one dense pricing pass there; and the ratio kernels'
     device time a launch from a trace of the per-op bench's loop; and a
     trace of one ``solve_batched`` call (phase 15's recipe at B = 4,096,
     under Dantzig, devex and steepest edge, and the segmented cell, fp32
     and bf16): device ops and device us a batch step, and each batched
     kernel's; the
     device us a call of the redesigned batched kernels (shared-A and bf16
     pricing, the windows per instance and on a shared A, in float64 too,
     the tail's two paths and its 256 x 2048 shape); of
     one ``reoptimize_batched`` call (phase 16's) a dual batch step; and of
     640 PDHG iterations (phase 17's 256 x 640 and T = 64 sparse) an
     iteration. It runs last: after a profiler run every later launch of the process
     costs more host time.
 15. ``solve_batched`` on ``bench.py --mode batch``'s recipe (4,096 and
     10,240 LPs of 64 x 160, its options: no verify rounds, no polish,
     max_iter 1000), with bench.py's one-at-a-time figure; then on the same
     recipe with the slack identity kept exact (bench.py's noise lands on
     it while the slack start assumes B_inv = I, in the JAX package too),
     held against HiGHS and the port's single solve on 16 sampled
     instances: fp32 A, the bf16 shadow, ``update_defer=4`` and bounds u
     shared by the batch. Every eager unbounded batch step launches the
     three batched kernels once each, with one control read;
 16. ``reoptimize_batched`` on ``bench.py --mode reopt``'s recipe: a cold
     solve of 2048 x 4096, then 256 rhs scenarios re-solved from its
     basis, dense A and scipy CSC, 8 sampled scenarios against HiGHS;
 17. PDHG: ``random_dense_lp(256, 640)`` and ``bench.py --mode pdhg
     --sparse``'s multiperiod instance at T = 64 to OPTIMAL within 1e-3 of
     HiGHS; T = 248 dense and sparse under an iteration budget (reported);
     ``crossover`` of the T = 64 answer within 1e-6 of HiGHS; ``cli solve
     --algo pdhg --crossover`` on sample.txt.
 18. the port's benchmark entry point (``python -m
     simplex_tpu_torch.bench.run``), every one of ``bench.py``'s modes
     once through ``run.main`` at ``BENCH_RUNS``' sizes: ``single`` at
     8192 x 16384 over 512 pivots under the flagship and the default option
     set (whose kernels must launch once a pivot), ``sparse`` there too,
     ``full`` under the flagship (no oracle; feas_err in the record),
     ``parity`` at 2048 x 4096, ``general`` at T = 64, ``batch`` at B =
     4,096 (the three batched kernels launched), ``pdhg`` at 256 x 640 and
     ``--sparse --m 2112``, ``reopt`` at 2048 x 4096 with
     ``BENCH_REOPT_B`` scenarios; each record must be one stdout line with
     the expected metric, ``impl`` and this card, and meet its status and
     gap gates (GAP_TOL, 1e-4 for the sampled warm re-solves, 1e-3 for
     PDHG); then ``cli bench`` once as a subprocess.
 19. the batched modes in float64 (``phase_f64_batched``): bench-batch's
     recipe at B = 4,096, with the slack identity kept exact against
     HiGHS too, bench-reopt's cold basis and ``F64_REOPT_B`` scenarios,
     and the segmented cell under ``partial_pricing=8``, each within
     F64_GAP_TOL of the single float64 solve or HiGHS, each batch step
     launching the three batched kernels' float64 instantiations;
 20. the sharded modes in float64 (``phase_f64_sharded``): the 1-D and
     the 1 x 1 2-D windows of the bench instance at world size 1 over NCCL
     against the single float64 window (the same pivots, basis and z),
     then four gloo ranks on the card: the 2-D classic ratio test (and
     Harris with Bland's rule) on 2 x 2, ``solve_sharded`` at 2048 x 4096
     to OPTIMAL against HiGHS over two ranks, and bench-batch's
     ``solve_batched(mesh=)`` in float64.

Each path runs with the launch counters set to 0 just before it and read
just after; a kernel's ``launches`` in the JSON record is its total over
the paths (each path's counts are printed on their own line); the float64
instantiations are records of their own (``pricing_scan_f64``, ...), whose
launches are those of the paths tagged ``f64``. Beside its
measured times the record gives each kernel's ``bound_ms``: the bytes it
must move at the main path's shape (each input read once, each output
written once) over the card's 3.35 TB/s, or its operations over the fp32
(float64: fp64) peak, whichever is larger; and ``library_ms``, the time of
the one PyTorch call that computes the same function where there is one
(``Tensor.addr_`` for rank1_update; for float64 pricing ``torch.mv(A.T,
y)``, the product alone), timed here and used nowhere in the port. The last
lines are the kernels' JSON record, the card's ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. Without a CUDA device, or run outside a
checkout of the repository, the script exits non-zero at once.

``--only kernels`` stops after phase 2 (a quick check of a changed kernel;
it prints the kernels' measured times, then the device time a call of the
redesigned batched kernels from a profiler trace, and no final ``ok``
line); ``--only
new`` builds the kernels and runs phases 15-17 and phase 14's traces of
them alone (no final ``ok`` line either); ``--only bench`` builds the
kernels and runs phase 18 alone; ``--only f64`` the float64 kernel
checks (the batched kernels' included), the float64 solves and entry
points, phases 19 and 20, the float64 per-op bench and the float64
profiles (no final ``ok`` line in either).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import io
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BENCH_M, BENCH_N = 8192, 16384  # bench.py's instance: random_dense_lp(m, n, seed=0)
SMALL_M, SMALL_N = 2048, 4096  # the instance HiGHS checks within seconds
BENCH_WINDOW = 512  # bench.py's pivot budget
# bench.py's option set (its argparse defaults), and its full-solve cadence
FLAGSHIP = dict(pricing_dtype="bfloat16", partial_pricing=8, update_defer=16, multi_price=64)
FLAGSHIP_REFACTOR = 2048
# the general route: bench.py --mode general's instance (T=64, P=16) and
# 1.5 times its periods (four times until the bench phase needed the time,
# twice until the float64 phases did), and an unbounded transportation LP
GENERAL_SIZES = {"A": (64, 16), "B": (96, 16)}
TRANSPORT_C = (64, 1024)
TRACE_PIVOTS = 256  # pivots of the traced 2048 x 4096 stretch
CHECKPOINT_EVERY = 512  # pivots a chunk of the checkpointed solves
# bench.py --mode sparse's recipe: A0's tiles kept with this probability
SPARSE_TILE, SPARSE_DENSITY = 128, 0.10
# host reads (and device syncs) a pivot the sparse default loop may take:
# the one control read, plus a perturbation round now and then
MAX_SPARSE_READS_PER_PIVOT = 1.05
# float64 primal infeasibility (-min x_b of the returned basis) a sparse-vs-
# dense answer may keep: the Harris ratio test trades O(feas_tol)
# infeasibility for pivot size (1.2e-4 on the default path's 8192 x 16384
# answer); a drifted fp32 inverse leaves O(1) on the bench-sparse class at
# 4096 x 8192 and up (python -m tests.bench_sparse_drift), so the
# to-OPTIMAL pair runs at 2048 x 4096
MAX_PRIMAL_INFEAS = 1e-3
# bench.py --mode general's options (its argparse defaults, bench.py:456-462)
GENERAL_BENCH = dict(pricing_dtype="bfloat16", partial_pricing=8, update_defer=16, refactor_every=1024)
# the shapes the general route gives the kernels: standardized A (rows,
# columns) of multiperiod (64, 16) and (256, 16), and of C (no bounds)
ROUTE_A, ROUTE_B, ROUTE_C = (1088, 4160), (4352, 16640), (1088, 67648)

# tolerances, each with its reason
PRICING_RTOL = 1e-5  # fp32 sums of 8192 terms taken in another order
RANK1_ATOL = 1e-5  # the plain ger may fuse multiply-add; the kernel does not
RATIO_ATOL = 0.0  # same IEEE ops in the same order: bitwise equal
# the deferred tail's row q adds the pending pairs by fmaf in pair order, the
# plain version through a matrix product: row and y agree to rounding
TAIL_DEFER_RTOL = 1e-6
# device operations (kernels, memsets, copies) a pivot of the default path
# may issue: 13.02 measured on an H100 (78.01 before the tail and the mask
# moved into the kernels), plus room for a perturbation round
MAX_DEVICE_OPS_PER_PIVOT = 16.0
# the card's published peaks (H100 SXM): HBM bytes/s, fp32 flop/s, and
# fp64 flop/s outside the tensor cores (NVIDIA's data sheet)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_FP64_S = 34e12
# FP64 on the tensor cores (DMMA; NVIDIA's H100 SXM data sheet): the least time of a
# float64 product that a DGEMM may run there (the batched pricing's bounds)
PEAK_FP64_TC_S = 67e12
GAP_TOL = 1e-5  # fp32 solve against HiGHS in f64 (the JAX package's gate)
KKT_TOL = 1e-5  # min reduced cost of the f64 duals: dual feasibility at eps
FEAS_TOL = 1e-5  # f64 bound / row violation of a general-route answer

SOURCES = {
    "pricing_scan": "simplex_tpu_torch/csrc/pricing_scan.cu",
    "ratio_argmin": "simplex_tpu_torch/csrc/ratio_argmin.cu",
    "ratio_eta": "simplex_tpu_torch/csrc/ratio_eta.cu",
    "rank1_update": "simplex_tpu_torch/csrc/rank1_update.cu",
    "batch_pricing": "simplex_tpu_torch/csrc/batch_pricing.cu",
    "batch_tail": "simplex_tpu_torch/csrc/batch_tail.cu",
    "batch_rank1": "simplex_tpu_torch/csrc/batch_rank1.cu",
}
# the kernels' float64 instantiations, each its own record
F64_KERNELS = {
    "pricing_scan_f64": "pricing_scan",
    "ratio_argmin_f64": "ratio_argmin",
    "ratio_eta_f64": "ratio_eta",
    "rank1_update_f64": "rank1_update",
    "batch_pricing_f64": "batch_pricing",
    "batch_tail_f64": "batch_tail",
    "batch_rank1_f64": "batch_rank1",
}
REPLACES = {
    "pricing_scan": "simplex_tpu/kernels/pallas_ops.py:140",
    "ratio_argmin": "simplex_tpu/kernels/pallas_ops.py:212",
    "ratio_eta": "simplex_tpu/kernels/pallas_ops.py:323",
    "rank1_update": "simplex_tpu/kernels/pallas_ops.py:374",
    # the same three Pallas calls under vmap (simplex_tpu/batch/vmapped.py)
    "batch_pricing": "simplex_tpu/kernels/pallas_ops.py:140",
    "batch_tail": "simplex_tpu/kernels/pallas_ops.py:323",
    "batch_rank1": "simplex_tpu/kernels/pallas_ops.py:374",
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


PROFILE_TRIES = 3


def profiled(run, seen, what: str):
    """``run()`` (a torch.profiler session and what was read from it) again
    until ``seen`` holds of its result, at most PROFILE_TRIES times; the
    last result either way, for the caller's check. On the H100 a session
    once came back without a record of the kernels it had run, where five
    earlier runs of the same script had held them: a trace that saw nothing
    is taken again, not read as a kernel that took no time."""
    for k in range(PROFILE_TRIES):
        out = run()
        if seen(out):
            return out
        print(f"{what}: the trace held none of the expected records (try {k + 1} of {PROFILE_TRIES})",
              flush=True)
    return out


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_FP32_S) -> dict:
    """The least time the card could take for ``nbytes`` of traffic and
    ``flops`` operations at ``peak_flops`` (fp32 unless named), and which
    of the two sets it."""
    by_bytes, by_ops = 1e3 * nbytes / PEAK_BYTES_S, 1e3 * flops / peak_flops
    return {
        "bound_ms": max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
    }


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


def masked_basis(e, m: int, g, n_total=None, lo: int = 0):
    """A basis of m distinct columns out of ``n_total`` that holds the 50
    (at most m / 2) most improving columns of e (the reduced costs of columns lo, lo + 1,
    ...), so that the mask decides the pick."""
    import torch

    n_total = e.shape[0] if n_total is None else n_total
    k = min(50, m // 2)
    best = torch.argsort(e)[:k] + lo
    rest = torch.randperm(n_total, generator=g, device=e.device)
    rest = rest[~torch.isin(rest, best)][: m - k]
    return torch.cat([best, rest])[torch.randperm(m, generator=g, device=e.device)].to(torch.int32)


def check_choose(tag, dev, y, Av, cv, basis, lo, eps) -> float:
    """The one-call form (mask, choice and offset in the kernel) against
    its plain version, Bland off and on: the same column, min within
    PRICING_RTOL, never a basic column. Returns the worst |min| error."""
    import torch

    from simplex_tpu_torch.kernels import hopper

    e = y @ Av.float() - cv
    is_basic = torch.zeros(Av.shape[1] + 1, dtype=torch.bool, device=dev)
    loc = (basis.long() - lo).clamp(-1, Av.shape[1])
    is_basic[loc] = True  # out-of-range entries land on the spare slot
    worst = 0.0
    for bland in (False, True):
        flag = torch.tensor(bland, device=dev)
        p_k, min_k = hopper.choose_entering(y, Av, cv, eps, flag, basis, lo)
        p_p, min_p = hopper.choose_entering_plain(y, Av, cv, eps, flag, basis, lo)
        torch.cuda.synchronize()
        p_k, p_p, min_k, min_p = int(p_k), int(p_p), float(min_k), float(min_p)
        name = f"choose_entering {tag} bland={bland}"
        err = abs(min_k - min_p)
        check(err <= PRICING_RTOL * abs(min_p), f"{name}: min {min_k} vs {min_p}")
        check(lo <= p_k < lo + Av.shape[1], f"{name}: p {p_k} outside [{lo}, {lo + Av.shape[1]})")
        if p_k != p_p:
            # only a tie within the summation-order noise may move the pick
            gap = abs(float(e[p_k - lo]) - float(e[p_p - lo]))
            check(not bland and gap <= PRICING_RTOL * abs(min_p), f"{name}: p {p_k} vs plain {p_p}")
            print(f"{name}: p {p_k} vs plain {p_p}, a tie within {gap:.3e}")
        check(not bool(is_basic[p_k - lo]), f"{name}: picked basic column {p_k}")
        check(min_k < -eps, f"{name}: no improving column in the test data")
        worst = max(worst, err)
        print(f"{name}: p {p_k} (plain {p_p}) min_e {min_k:.6f} (plain {min_p:.6f}) ok")
    return worst


def phase_pricing(dev) -> dict:
    import torch

    from simplex_tpu_torch.kernels import hopper, ops

    g = torch.Generator(device=dev).manual_seed(0)
    rec = {}
    # (9000, 1001) is narrow enough for pass 2's shared-memory tiles and has
    # more row chunks than one tile holds; the last shape takes one row
    # chunk: the single-launch form
    for m, n in ((BENCH_M, BENCH_N), (BENCH_M - 1, BENCH_N - 1), ROUTE_C, (9000, 1001), (24, 4099)):
        check((hopper._pricing_chunks(m, n)[1] > 256) == (m == 9000), f"pricing {m}x{n}: row chunks")
        check((hopper._pricing_chunks(m, n)[1] == 1) == (m == 24), f"pricing {m}x{n}: row chunks")
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
        # the one-call form the step uses: mask, choice, offset in the kernel
        # (a range narrower than m is a column segment of a wider problem)
        n_total, lo = (n, 0) if n >= m else (2 * m, m // 2)
        basis = masked_basis(e, m, g, n_total, lo)
        err = max(err, check_choose(f"fp32 {m}x{n}", dev, y, A, c, basis, lo, eps))
        if (m, n) == (BENCH_M, BENCH_N):
            no = torch.tensor(False, device=dev)
            # bytes: A, y, c, the basis; 2 flops per element of A
            rec = {
                "max_abs_err": err,
                "ms": time_ms(lambda: hopper.choose_entering(y, A, c, eps, no, basis)),
                "plain_ms": time_ms(lambda: ops.choose_entering(y, A, c, eps, no, basis)),
                "scan_ms": time_ms(lambda: hopper.pricing_scan(y, A, c, eps)),
                "scan_plain_ms": time_ms(lambda: hopper.pricing_scan_plain(y, A, c, eps)),
                **bound(4.0 * (m * n + 2 * m + n) + 16, 2.0 * m * n),
                "library_ms": None,
            }
            print(f"pricing_scan {m}x{n} fp32, ms: one-call {rec['ms']:.4f} (plain {rec['plain_ms']:.4f}), "
                  f"three-output scan {rec['scan_ms']:.4f} (plain {rec['scan_plain_ms']:.4f}), "
                  f"bound {rec['bound_ms']:.4f}")
        del A
    return rec


TAIL_OPTS = dict(eps=1e-5, pivot_tol=1e-7, feas_tol=1e-6, degen_tol=1e-9, bland_after=64)


def tail_inputs(dev, g, m: int):
    """Random inputs of the pivot's tail at m rows; x_b has exact ratio
    ties at theta = 0."""
    import torch

    x_b = torch.rand(m, generator=g, device=dev) * 2
    x_b[::7] = 0.0
    t = {
        "x_b": x_b,
        "alpha": torch.randn(m, generator=g, device=dev),
        "basis": torch.randperm(m, generator=g, device=dev).to(torch.int32),
        "y": torch.randn(m, generator=g, device=dev),
        "c_b": torch.randn(m, generator=g, device=dev),
        "B_inv": torch.randn(m, m, generator=g, device=dev),
        "min_e": torch.tensor(-0.75, device=dev),
        "e_p": torch.tensor(-0.75, device=dev),
        "c_p": torch.tensor(0.3, device=dev),
        "p": torch.tensor(m + 17, dtype=torch.int32, device=dev),
        "iters": torch.tensor(41, dtype=torch.int32, device=dev),
        "degen": torch.tensor(3, dtype=torch.int32, device=dev),
    }
    return t


def check_tail(tag, dev, t, harris, defer, defer_rtol=TAIL_DEFER_RTOL, opts=TAIL_OPTS) -> float:
    """``hopper.pivot_tail`` against its plain version on the same inputs
    (in their dtype): every leaf bitwise equal, except row q and y under
    deferred updates (``defer_rtol``). Returns the largest absolute
    difference seen."""
    import torch

    from simplex_tpu_torch.kernels import hopper

    L, npend = 16, 5
    g = torch.Generator(device=dev).manual_seed(7)
    m, dt = t["x_b"].shape[0], t["x_b"].dtype
    outs = []
    for fn in (hopper.pivot_tail, hopper.pivot_tail_plain):
        extra = {}
        if defer:
            U = torch.zeros(L, m, device=dev, dtype=dt)
            R = torch.zeros(L, m, device=dev, dtype=dt)
            g.manual_seed(7)
            U[:npend] = torch.randn(npend, m, generator=g, device=dev) * 0.1
            R[:npend] = torch.randn(npend, m, generator=g, device=dev)
            extra = dict(U=U, R=R, npend=npend, npend_t=torch.tensor(npend, dtype=torch.int32, device=dev))
        outs.append(fn(*(t[k] for k in (
            "x_b", "alpha", "basis", "y", "c_b", "B_inv", "min_e", "e_p", "c_p", "p", "iters", "degen"
        )), harris=harris, **opts, **extra))
    torch.cuda.synchronize()
    got, want = outs
    worst = 0.0
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        if a is None and b is None:
            continue
        check(a.shape == b.shape and a.dtype == b.dtype, f"{tag}: {name} {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        if defer and name in ("row", "y"):
            scale = float(b.abs().max()) + 1e-30
            err = float((a - b).abs().max())
            check(err <= defer_rtol * max(scale, 1.0), f"{tag}: {name} differs by {err} (scale {scale})")
        else:
            err = 0.0 if torch.equal(a, b) else float((a.double() - b.double()).abs().max())
            check(torch.equal(a, b), f"{tag}: {name} differs by {err}: {a} vs {b}")
        worst = max(worst, err)
    print(f"{tag}: q {int(got.q)} theta_q {float(got.theta_q):.6g} status {int(got.status)} "
          f"take {bool(got.take)} iters {int(got.iters)} degen {int(got.degen)} ok")
    return worst


def phase_ratio_eta(dev) -> dict:
    """The cluster kernel against its plain versions: the old contract
    (``ratio_eta``: the tail off) and the pivot's whole tail
    (``pivot_tail``: eager and deferred), at one block (m = 1088 takes
    two), several, and beyond 8 x 1024 rows (the stride loop)."""
    import torch

    from simplex_tpu_torch.kernels import hopper

    g = torch.Generator(device=dev).manual_seed(1)
    rec = {}
    worst = 0.0
    for m in (BENCH_M, BENCH_M - 1, ROUTE_A[0], ROUTE_B[0], 1000, 5000, 9000, 17):
        t = tail_inputs(dev, g, m)
        x_b, alpha, basis = t["x_b"], t["alpha"], t["basis"]
        cases = [
            (harris, bland, alpha)
            for harris in (True, False)
            for bland in (False, True)
        ] + [(True, False, -alpha.abs() - 1), (False, True, -alpha.abs() - 1)]
        for harris, bland, a in cases:
            # the flag as the step passes it (a bool) and as an int32
            flag = torch.tensor(bland, device=dev)
            flag = flag.to(torch.int32) if harris else flag
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
        # the tail: a pivoting step (Harris and classic, Bland through
        # degen >= bland_after), then the steps that must change nothing
        for defer in (False, True):
            kind = "deferred" if defer else "eager"
            for harris in (True, False):
                worst = max(worst, check_tail(f"pivot_tail m={m} {kind} harris={harris}", dev, t, harris, defer))
            variants = {
                # no exact ties: theta_q > 0, so x_b moves
                "positive x_b": {"x_b": x_b + 0.25},
                "positive x_b, classic": {"x_b": x_b + 0.25},
                "bland": {"degen": torch.tensor(64, dtype=torch.int32, device=dev)},
                "optimal": {"min_e": torch.tensor(0.0, device=dev)},
                "unbounded": {"alpha": -alpha.abs() - 1},
                "non-finite min_e": {"min_e": torch.tensor(float("nan"), device=dev)},
                "non-finite theta": {"x_b": torch.full_like(x_b, float("inf"))},
            }
            for name, change in variants.items():
                worst = max(worst, check_tail(
                    f"pivot_tail m={m} {kind} {name}", dev, {**t, **change}, "classic" not in name, defer
                ))
        if m == BENCH_M:
            flag = torch.tensor(False, device=dev)
            args = tuple(t[k] for k in (
                "x_b", "alpha", "basis", "y", "c_b", "B_inv", "min_e", "e_p", "c_p", "p", "iters", "degen"
            ))
            # bytes: x_b, alpha, basis, y, c_b and row q of B_inv in; eta,
            # row, x_b, y, c_b, basis out; ~12 flops a row
            rec = {
                "ms": time_ms(lambda: hopper.pivot_tail(*args, harris=True, **TAIL_OPTS), 200),
                "plain_ms": time_ms(lambda: hopper.pivot_tail_plain(*args, harris=True, **TAIL_OPTS), 50),
                "ratio_only_ms": time_ms(lambda: hopper.ratio_eta(x_b, alpha, basis, 1e-7, flag, True), 200),
                "ratio_only_plain_ms": time_ms(
                    lambda: hopper.ratio_eta_plain(x_b, alpha, basis, 1e-7, flag, True), 200
                ),
                **bound(4.0 * 12 * m + 64, 12.0 * m),
                "library_ms": None,
            }
            print(f"pivot_tail m={m}, ms: {rec['ms']:.4f} (plain {rec['plain_ms']:.4f}); tail off "
                  f"{rec['ratio_only_ms']:.4f} (plain {rec['ratio_only_plain_ms']:.4f}); bound {rec['bound_ms']:.6f}")
        del t
    rec["max_abs_err"] = worst
    return rec


def phase_rank1(dev) -> dict:
    import torch

    from simplex_tpu_torch.kernels import hopper

    g = torch.Generator(device=dev).manual_seed(2)
    rec = {}
    worst = 0.0
    for m in (BENCH_M, BENCH_M - 1, ROUTE_A[0], ROUTE_B[0]):
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
            # bytes: B_inv read and written, eta and row read; one multiply
            # and one add an element. The library call is the plain version
            rec = {
                "ms": time_ms(lambda: hopper.rank1_update(B, small, row)),
                "plain_ms": time_ms(lambda: hopper.rank1_update_plain(B, small, row)),
                **bound(8.0 * m * m + 8 * m, 2.0 * m * m),
                "library_ms": time_ms(lambda: B.addr_(small, row)),
            }
        del B, got, want
    rec["max_abs_err"] = worst
    # the 2-D solve's row blocks: a rank of R rows groups updates its
    # (m / R, m) rows of the inverse; bit for bit the unfused plain form
    # B + outer(eta, row) and the whole matrix's update on those rows
    m = BENCH_M
    B = torch.randn(m, m, generator=g, device=dev)
    eta = torch.randn(m, generator=g, device=dev)
    row = B[m // 3].clone()
    whole = hopper.rank1_update(B.clone(), eta, row)
    for R in (2, 4):
        r0 = (R - 1) * (m // R)  # the last block: a nonzero row offset
        blk = B[r0 : r0 + m // R].clone()
        e_blk = eta[r0 : r0 + m // R].clone()
        got = hopper.rank1_update(blk.clone(), e_blk, row)
        want = blk + torch.outer(e_blk, row)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"rank1_update row block {m // R}x{m}: differs from B + outer(eta, row)")
        check(torch.equal(got, whole[r0 : r0 + m // R]), f"rank1_update row block {m // R}x{m}: differs from the whole")
        err = float((got - hopper.rank1_update_plain(blk.clone(), e_blk, row)).abs().max())
        check(err <= RANK1_ATOL, f"rank1_update row block {m // R}x{m}: {err} from plain")
        small = e_blk * 1e-6
        rec.setdefault("row_blocks", {})[f"{m // R}x{m}"] = r = {
            "max_abs_err": err, "bitwise_unfused_plain": True,
            "ms": time_ms(lambda: hopper.rank1_update(blk, small, row)),
            "plain_ms": time_ms(lambda: hopper.rank1_update_plain(blk, small, row)),
            **bound(8.0 * (m // R) * m + 4 * (m // R + m), 2.0 * (m // R) * m),
            "library_ms": time_ms(lambda: blk.addr_(small, row)),
        }
        print(f"rank1_update row block {m // R}x{m} (rows {r0}..): bit for bit B + outer(eta, row) and the whole "
              f"update's rows; {err:.3e} from addr_; ms {r['ms']:.4f} (plain {r['plain_ms']:.4f}, addr_ "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f})")
        del blk, got, want
    del B, whole
    return rec


def phase_pricing_bf16(dev) -> dict:
    """pricing_scan on the bf16 shadow of the bench's shape and on a strided
    column segment of it (the segmented path's view, priced in place)."""
    import torch

    from simplex_tpu_torch.kernels import hopper, ops

    g = torch.Generator(device=dev).manual_seed(4)
    m, n = BENCH_M, BENCH_N
    w = n // FLAGSHIP["partial_pricing"]
    y = torch.randn(m, generator=g, device=dev)
    A = torch.randn(m, n, generator=g, device=dev).to(torch.bfloat16)
    c = torch.randn(n, generator=g, device=dev)
    eps = 1e-5
    rec = {}
    views = [("full", A, c, 0), ("segment", A[:, 3 * w : 4 * w], c[3 * w : 4 * w], 3 * w)]
    no = torch.tensor(False, device=dev)
    for tag, Av, cv, lo in views:
        check((tag == "segment") != Av.is_contiguous(), f"pricing bf16 {tag}: layout")
        min_k, p_k, neg_k = hopper.pricing_scan(y, Av, cv, eps)
        min_p, p_p, neg_p = hopper.pricing_scan_plain(y, Av, cv, eps)
        e = y @ Av.float() - cv
        torch.cuda.synchronize()
        min_k, p_k, neg_k, min_p = float(min_k), int(p_k), int(neg_k), float(min_p)
        err = abs(min_k - min_p)
        check(err <= PRICING_RTOL * abs(min_p), f"pricing bf16 {tag}: min {min_k} vs {min_p}")
        check(
            abs(float(e[p_k]) - min_p) <= PRICING_RTOL * abs(min_p),
            f"pricing bf16 {tag}: e[p_kernel={p_k}] = {float(e[p_k])} vs min {min_p}",
        )
        check(neg_k == int(neg_p), f"pricing bf16 {tag}: first negative {neg_k} vs {int(neg_p)}")
        # the one-call form: global basis, the view's first column lo
        basis = masked_basis(e, m, g, n, lo)
        err = max(err, check_choose(f"bf16 {tag} {tuple(Av.shape)} base {lo}", dev, y, Av, cv, basis, lo, eps))
        ms = time_ms(lambda: hopper.choose_entering(y, Av, cv, eps, no, basis, lo), 100)
        plain_ms = time_ms(lambda: ops.choose_entering(y, Av, cv, eps, no, basis, lo), 100)
        scan_ms = time_ms(lambda: hopper.pricing_scan(y, Av, cv, eps), 100)
        scan_plain_ms = time_ms(lambda: hopper.pricing_scan_plain(y, Av, cv, eps), 100)
        rec[tag] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "scan_ms": scan_ms,
            "scan_plain_ms": scan_plain_ms,
            **bound(2.0 * m * Av.shape[1] + 4.0 * (2 * m + Av.shape[1]) + 16, 2.0 * m * Av.shape[1]),
        }
        print(
            f"pricing_scan bf16 {tag} {tuple(Av.shape)} strides {Av.stride()}: min_e {min_k:.6f} "
            f"(plain {min_p:.6f}) p {p_k} abs err {err:.3e}; ms: one-call {ms:.4f} (plain {plain_ms:.4f}), "
            f"three-output scan {scan_ms:.4f} (plain {scan_plain_ms:.4f}), bound {rec[tag]['bound_ms']:.4f}"
        )
    return rec


def phase_pricing_bounded(dev) -> None:
    """pricing_scan's signed mode (the bounded rule's pricing,
    ``hopper.choose_entering_bounded``) against its plain version at the
    bounded route's shapes: fp32 A, the bf16 shadow, and a bf16 segment
    view (8 segments), with 40% of the columns at their upper bound and
    the basic columns penalized; Bland off and on. At B's shape it also
    times the kernel on the shadow and on fp32 A beside the plain version,
    which prices the shadow through an fp32 copy of it."""
    import torch

    from simplex_tpu_torch.kernels import hopper, ops

    g = torch.Generator(device=dev).manual_seed(5)
    eps = 1e-5
    for m, n in (ROUTE_A, ROUTE_B):
        w = n // GENERAL_BENCH["partial_pricing"]
        y = torch.randn(m, generator=g, device=dev)
        A = torch.randn(m, n, generator=g, device=dev)
        Ab = A.to(torch.bfloat16)
        c = torch.randn(n, generator=g, device=dev)
        at_up = torch.rand(n, generator=g, device=dev) < 0.4
        basis = torch.randperm(n, generator=g, device=dev)[:m].to(torch.int32)
        views = [("fp32", A, 0, n), ("bf16", Ab, 0, n), ("bf16 segment", Ab[:, 3 * w : 4 * w], 3 * w, w)]
        for tag, Av, lo, wv in views:
            cv, uv = c[lo : lo + wv], at_up[lo : lo + wv]
            pen = ops.add_basic_penalty(torch.zeros_like(cv), basis, lo)
            s_ref = torch.where(uv, -(y @ Av.float() - cv), y @ Av.float() - cv) + pen
            for bland in (False, True):
                flag = torch.tensor(bland, device=dev)
                args = (y, Av, cv, uv, basis, lo, eps, flag)
                p_k, min_k = hopper.choose_entering_bounded(*args)
                p_p, min_p = ops.choose_entering_bounded(*args)
                torch.cuda.synchronize()
                p_k, min_k, p_p, min_p = int(p_k), float(min_k), int(p_p), float(min_p)
                name = f"bounded pricing {tag} {m}x{wv} (base {lo}) bland={bland}"
                check(lo <= p_k < lo + wv, f"{name}: p {p_k} outside [{lo}, {lo + wv})")
                check(abs(min_k - min_p) <= PRICING_RTOL * abs(min_p), f"{name}: min {min_k} vs {min_p}")
                if bland:
                    check(p_k == p_p, f"{name}: first improving {p_k} vs {p_p}")
                else:
                    s_at = float(s_ref[p_k - lo])
                    check(abs(s_at - min_p) <= PRICING_RTOL * abs(min_p), f"{name}: s[p={p_k}] {s_at} vs {min_p}")
                if min_k < -eps:  # an improving pick is never a basic column
                    check(float(pen[p_k - lo]) == 0.0, f"{name}: picked basic column {p_k}")
                print(f"{name}: p {p_k} (plain {p_p}) min_s {min_k:.6f} (plain {min_p:.6f}) ok")
        if (m, n) == ROUTE_B:
            no = torch.tensor(False, device=dev)
            times = {}
            for tag, Av in (("fp32", A), ("bf16", Ab)):
                args = (y, Av, c, at_up, basis, 0, eps, no)
                times[tag] = (
                    time_ms(lambda: hopper.choose_entering_bounded(*args)),
                    time_ms(lambda: ops.choose_entering_bounded(*args)),
                )
            print(
                f"bounded pricing {m}x{n}, full pass, ms kernel / plain: fp32 A "
                f"{times['fp32'][0]:.4f} / {times['fp32'][1]:.4f}; bf16 shadow "
                f"{times['bf16'][0]:.4f} / {times['bf16'][1]:.4f} (plain upcasts the shadow)"
            )
        del A, Ab


# --------------------------------------------------------------------------
# the batched kernels (simplex_tpu_torch.batch)
# --------------------------------------------------------------------------

# bench.py --mode batch's shape (bench.py:801-898): 4,096 LPs of 64 x 160
BATCH_B, BATCH_M, BATCH_N = 4096, 64, 160
# the warm re-solve's shape (bench.py --mode reopt, bench.py:729-798)
REOPT_M, REOPT_N, REOPT_B = 2048, 4096, 256
# batched pricing against its plain twin: fp32 sums of m terms in another
# order (a batched matrix product there): 1.2e-4 of scale, every pick equal
BATCH_PRICING_ATOL = 1.2e-4


def bits(t):
    """A float32 / float64 tensor's bits as int32 / int64 (bit-for-bit
    comparisons that keep -0.0 and NaN payloads apart)."""
    import torch

    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def batch_pricing_inputs(dev, g, Bn: int, m: int, n: int, shared: bool = False, dtype=None):
    """y, A, c and basis for the batched pricing in ``dtype`` (default
    float32); ``shared``: one A (m, n) and one c (n,) for every instance,
    as the warm re-solve has them."""
    import torch

    dtype = dtype or torch.float32
    lead = () if shared else (Bn,)
    y = torch.randn(Bn, m, generator=g, device=dev, dtype=dtype) / m ** 0.5
    A = torch.randn(*lead, m, n, generator=g, device=dev, dtype=dtype)
    c = torch.randn(*lead, n, generator=g, device=dev, dtype=dtype)
    e = (y @ A if shared else torch.bmm(y[:, None, :], A)[:, 0]) - c
    # a basis of m distinct columns holding each instance's best column, so
    # the mask decides the pick
    basis = torch.rand(Bn, n, generator=g, device=dev).argsort(1)[:, :m]
    best = e.argmin(1)
    has = (basis == best[:, None]).any(1)
    basis[:, 0] = torch.where(has, basis[:, 0], best)
    basis = basis.to(torch.int32).contiguous()
    return y, A, c, basis


def check_batch_pricing(tag, dev, y, A, c, basis, bland, at_upper=None) -> float:
    import torch

    from simplex_tpu_torch.kernels import hopper

    p_k, min_k = hopper.choose_entering_batched(y, A, c, 1e-5, bland, basis, at_upper)
    p_p, min_p = hopper.choose_entering_batched_plain(y, A, c, 1e-5, bland, basis, at_upper)
    torch.cuda.synchronize()
    check(min_k.dtype == c.dtype, f"{tag}: min_e {min_k.dtype} beside {c.dtype} vectors")
    err = float((min_k - min_p).abs().max())
    scale = max(1.0, float(min_p.abs().max()))
    atol = BATCH_PRICING_ATOL if c.dtype == torch.float32 else F64_PRICING_RTOL
    check(err <= atol * scale, f"{tag}: min_e differs by {err} (scale {scale})")
    bad = int((p_k != p_p).sum())
    check(bad == 0, f"{tag}: {bad} picks differ")
    print(f"{tag}: max abs err {err:.3e}, picks equal ok")
    return err


def batch_tail_inputs(dev, g, Bn: int, m: int, L: int = 0, dtype=None):
    import torch

    f = dict(generator=g, device=dev, dtype=dtype or torch.float32)
    x_b = torch.rand(Bn, m, **f) * 2
    x_b[:, ::7] = 0.0
    t = dict(
        x_b=x_b, alpha=torch.randn(Bn, m, **f),
        basis=torch.rand(Bn, m + 50, generator=g, device=dev).argsort(1)[:, :m].to(torch.int32).contiguous(),
        y=torch.randn(Bn, m, **f), c_b=torch.randn(Bn, m, **f),
        B_inv=torch.randn(Bn, m, m, **f),
        min_e=-torch.rand(Bn, **f), c_p=torch.randn(Bn, **f),
        p=torch.randint(0, m + 50, (Bn,), generator=g, device=dev).to(torch.int32),
        iters=torch.randint(0, 100, (Bn,), generator=g, device=dev).to(torch.int32),
        degen=torch.randint(0, 80, (Bn,), generator=g, device=dev).to(torch.int32),
    )
    t["e_p"] = t["min_e"].clone()
    # a few optimal, unbounded and non-finite instances, and finished ones
    t["min_e"][1::9] = 0.5
    t["alpha"][2::9] = -t["alpha"][2::9].abs() - 1
    t["min_e"][3::17] = float("nan")
    status = torch.zeros(Bn, dtype=torch.int32, device=dev)
    status[4::5] = 1
    t["status"] = status
    t["active"] = (status == 0) & (t["iters"] < 95)
    if L:
        t["npend"] = torch.randint(0, L, (Bn,), generator=g, device=dev).to(torch.int32)
        k = torch.arange(L, device=dev)[None, :, None]
        live = (k < t["npend"][:, None, None]).to(f["dtype"])
        t["U"] = torch.randn(Bn, L, m, **f) * 0.1 * live
        t["R"] = torch.randn(Bn, L, m, **f) * live
    return t


TAIL_KEYS = ("x_b", "alpha", "basis", "y", "c_b", "B_inv", "min_e", "e_p", "c_p", "p", "iters",
             "degen", "status", "active")


def check_batch_tail(tag, dev, t, harris) -> None:
    import torch

    from simplex_tpu_torch.kernels import hopper

    outs, bufs = [], []
    opts = TAIL_OPTS if t["x_b"].dtype == torch.float32 else F64_TAIL_OPTS
    for fn in (hopper.pivot_tail_batched, hopper.pivot_tail_batched_plain):
        extra = {}
        if "U" in t:
            extra = dict(U=t["U"].clone(), R=t["R"].clone(), npend=t["npend"])
            bufs.append(extra)
        outs.append(fn(*(t[k] for k in TAIL_KEYS), harris=harris, **opts, **extra))
    torch.cuda.synchronize()
    got, want = outs
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        if a is None and b is None:
            continue
        check(a.shape == b.shape and a.dtype == b.dtype, f"{tag}: {name} {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        same = torch.equal(a, b) or bool(((a == b) | (a.isnan() & b.isnan())).all()) if a.is_floating_point() \
            else torch.equal(a, b)
        check(same, f"{tag}: {name} differs")
    if bufs:
        for k in ("U", "R"):
            check(torch.equal(bufs[0][k], bufs[1][k]), f"{tag}: {k} differs")
    print(f"{tag}: every leaf bit for bit ok (takes {int(got.take.sum())} of {got.take.shape[0]})")


def check_batch_rank1(tag, dev, g, Bn, m, dtype=None) -> None:
    import torch

    from simplex_tpu_torch.kernels import hopper

    f = dict(generator=g, device=dev, dtype=dtype or torch.float32)
    B = torch.randn(Bn, m, m, **f)
    B[:, 0, 0] = -0.0
    eta = torch.randn(Bn, m, **f)
    row = torch.randn(Bn, m, **f)
    take = torch.rand(Bn, generator=g, device=dev) < 0.7
    got = hopper.rank1_update_batched(B.clone(), eta, row, take)
    want = hopper.rank1_update_batched_plain(B.clone(), eta, row, take)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"{tag}: differs by {float((got - want).abs().max())}")
    check(torch.equal(bits(got[~take].view(-1)), bits(B[~take].view(-1))),
          f"{tag}: an instance without take changed")
    try:
        hopper.rank1_update_batched(B, eta, B[:, 3], take)
    except ValueError:
        pass
    else:
        raise AssertionError(f"{tag}: a row that aliases B_inv was accepted")
    print(f"{tag}: bit for bit ok")


@contextlib.contextmanager
def tail_block_path():
    """``hopper.pivot_tail_batched`` on its block path at every m (the warp
    path's threshold at 0), to hold and time the two paths at one shape."""
    from simplex_tpu_torch.kernels import hopper

    keep = hopper._TAIL_WARP_MAX_M
    hopper._TAIL_WARP_MAX_M = 0
    try:
        yield
    finally:
        hopper._TAIL_WARP_MAX_M = keep


def misaligned(t):
    """A contiguous copy of t whose data starts one element past an aligned
    address (the kernels' element-load paths)."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_shared_is_per_instance(dev, g, Bn: int, m: int, n: int, dtype=None) -> None:
    """The shared layout against the per-instance path on the same A
    expanded to (B, m, n): both sum every e by fma in row order from 0, so
    the picks are equal and min_e bit for bit."""
    import torch

    from simplex_tpu_torch.kernels import hopper

    y, A, c, basis = batch_pricing_inputs(dev, g, Bn, m, n, shared=True, dtype=dtype)
    bland = torch.rand(Bn, generator=g, device=dev) < 0.3
    no = torch.zeros(Bn, dtype=torch.bool, device=dev)
    at_upper = torch.rand(Bn, n, generator=g, device=dev) < 0.3
    fp = "fp32" if A.dtype == torch.float32 else "f64"
    for tag, A1, flags, up in ((fp, A, no, None), (f"{fp} bland", A, bland, None),
                               ("bf16", A.to(torch.bfloat16), no, None), ("signed", A, bland, at_upper)):
        A3 = A1.expand(Bn, m, n).contiguous()
        c3 = c.expand(Bn, n).contiguous()
        p_s, min_s = hopper.choose_entering_batched(y, A1, c, 1e-5, flags, basis, up)
        for ctag, cc in (("per-instance c", c3), ("shared c", c)):
            p_i, min_i = hopper.choose_entering_batched(y, A3, cc, 1e-5, flags, basis, up)
            torch.cuda.synchronize()
            check(torch.equal(p_s, p_i), f"shared vs per-instance {Bn}x{m}x{n} {tag} ({ctag}): picks differ")
            check(torch.equal(bits(min_s), bits(min_i)),
                  f"shared vs per-instance {Bn}x{m}x{n} {tag} ({ctag}): min_e not bit for bit")
        del A3
    print(f"batch_pricing shared vs per-instance {Bn}x{m}x{n} ({fp}, bland, bf16, signed): "
          "picks equal, min_e bit for bit ok")


# segmented pricing's window cell: 64 instances of random_dense_lp(512,
# 4096) with partial_pricing = 8 (w = 512 = partial_min_segment)
SEG_B, SEG_M, SEG_N, SEG_S = 64, 512, 4096, 8
# batch steps of the segmented cell's profile (the whole call's ~1,000
# traced took a minute of the script)
SEG_TRACED = 256
# the segmented cell's path under the window's first version (the
# per-instance scan for every window, run on an H100 beside this code):
# pivots of all instances, the most of one, batch steps, and the failed
# segment and shadow stages. The window is bit for bit the call on each
# slice, so every pick, and so the whole path, is the same under any of its
# layouts.
SEG_PATH = {
    "fp32": dict(pivots=50344, max_pivots=1064, steps=1066, segment=324, shadow=0),
    "bf16 shadow": dict(pivots=49758, max_pivots=955, steps=957, segment=321, shadow=57),
}


def window_inputs(dev, g, Bn, m, n, S, shared=False, one_window=False, dtype=None):
    """batch_pricing_inputs plus each instance's segment counter (random
    iteration counts, so the windows differ between instances and some
    end at n; ``one_window``: every instance in the same window)."""
    import torch

    y, A, c, basis = batch_pricing_inputs(dev, g, Bn, m, n, shared, dtype)
    seg = torch.randint(0, 1000, (Bn,), generator=g, device=dev).to(torch.int32)
    if one_window:
        seg.fill_(5 * S + S // 2)
    else:
        seg[0] = S - 1  # the last window, which ends at n
    return y, A, c, basis, seg


def window_layout(y, A, w, S) -> str:
    """The layout batch_pricing's plan gives this window call."""
    import torch

    from simplex_tpu_torch.kernels import hopper

    m, n = A.shape[-2:]
    return hopper.batch_pricing_plan(y.shape[0], m, n, shared=A.dim() == 2,
                                     bf16=A.dtype == torch.bfloat16, align=hopper._alignment(y, A),
                                     window=w, segments=S, elem=y.element_size())["layout"]


def check_window_pricing(tag, dev, y, A, c, basis, bland, w, S, seg, at_upper=None) -> float:
    """The windowed call against (a) the unwindowed kernel on each
    instance's contiguous slice with the window's start added: bit for
    bit; (b) the plain twin: every pick equal, min_e within
    BATCH_PRICING_ATOL of scale. Prints the layout the call took."""
    import torch

    from simplex_tpu_torch.kernels import hopper, ops

    win = (w, S, seg)
    p_k, min_k = hopper.choose_entering_batched(y, A, c, 1e-5, bland, basis, at_upper, win)
    lo = ops.window_starts(win, A.shape[-1])
    cols = lo[:, None] + torch.arange(w, device=dev)
    c_w = c.index_select(0, cols.reshape(-1)).view(cols.shape) if c.dim() == 1 else c.gather(1, cols)
    up_w = None if at_upper is None else at_upper.gather(1, cols).contiguous()
    p_s, min_s = hopper.choose_entering_batched(
        y, ops.window_slice(A, lo, w), c_w.contiguous(), 1e-5, bland,
        (basis - lo[:, None]).to(torch.int32).contiguous(), up_w,
    )
    p_p, min_p = hopper.choose_entering_batched_plain(y, A, c, 1e-5, bland, basis, at_upper, win)
    torch.cuda.synchronize()
    check(torch.equal(p_k, (p_s + lo).to(torch.int32)), f"{tag}: picks differ from the call on the slice")
    check(torch.equal(bits(min_k), bits(min_s)),
          f"{tag}: min_e not bit for bit the call on the slice")
    check(bool(((p_k >= lo) & (p_k < lo + w)).all()), f"{tag}: a pick outside its window")
    err = float((min_k - min_p).abs().max())
    scale = max(1.0, float(min_p.abs().max()))
    atol = BATCH_PRICING_ATOL if c.dtype == torch.float32 else F64_PRICING_RTOL
    check(err <= atol * scale, f"{tag}: min_e differs from the plain twin by {err}")
    bad = int((p_k != p_p).sum())
    check(bad == 0, f"{tag}: {bad} picks differ from the plain twin")
    print(f"{tag} [{window_layout(y, A, w, S)}]: bit for bit the call on the slice, plain twin max abs "
          f"err {err:.3e}, picks equal ok")
    return err


def check_window_groups(dev, g) -> None:
    """The grouped window's first step alone on the card (the grouping
    block of batch_pricing.cu) against its plain twin ops.window_groups."""
    import torch

    from simplex_tpu_torch.kernels import hopper, ops

    for Bn, S, one in ((REOPT_B, SEG_S, False), (70, 3, False), (37, 5, True), (33, 1, False),
                       (3000, 1024, False), (1, 4, False)):
        seg = torch.randint(-500, 1000, (Bn,), generator=g, device=dev).to(torch.int32)
        if one:
            seg.fill_(7)
        perm, off = hopper.window_groups(seg, S)
        perm_p, off_p = ops.window_groups(seg, S)
        torch.cuda.synchronize()
        check(torch.equal(perm, perm_p) and torch.equal(off, off_p),
              f"window groups {Bn} instances S={S}: the card's grouping differs from the plain twin")
    print("batch_pricing window groups (B = 256, 70, 37 in one window, 33 at S = 1, 3000 at S = 1024, "
          "1): equal to the plain twin ok")


def phase_window_pricing(dev, g, dtype=None) -> dict:
    """batch_pricing's window mode on every layout: per instance the
    bulk-copy scan (fp32, bf16, tails of a chunk) and the scan / bf16x4
    kernels where the shape or a misaligned base forbids bulk copies;
    shared A grouped by window (16-byte copies and element loads, B not a
    multiple of the instance tile, one tile, all instances in one window,
    S = 1); signed and Bland, windows ending at n, starts that differ
    between instances; the grouping against its plain twin; then times at
    the segmented cell's shape and at the warm re-solve's, with their
    bounds. Every layout the plan can give a window must have run. In
    ``dtype`` (default float32; float64: the same cases, the vectors and A
    in double, the shadow bf16)."""
    import torch

    from simplex_tpu_torch.kernels import hopper, ops

    dtype = dtype or torch.float32
    fp, es = ("fp32", 4.0) if dtype == torch.float32 else ("f64", 8.0)
    peak = PEAK_FP32_S if dtype == torch.float32 else PEAK_FP64_TC_S
    check_window_groups(dev, g)
    worst = 0.0
    rec = {}
    seen = set()
    # (B, m, n, S, shared, one window): per instance w = 512 (the cell: two
    # chunks in a cluster), 250 and 258 (m = 33, 9: the scan), 520 (bulk
    # copies, three chunks, the last of 8 columns; at m = 21 the bf16
    # four-column scan), 15, 1024 (S = 1), 4096 (16 chunks: a reduction
    # launch), all in one window; shared at the warm
    # re-solve's shape, odd ones (element loads), 520 (a tail tile of 8
    # columns), B = 100 (not a multiple of 32), S = 1, B = 33 at w = 72
    # and m = 36 (one past the float64 tile: 32 instances, 64 columns, 32
    # rows), all in one window
    cases = ((SEG_B, SEG_M, SEG_N, SEG_S, False, False), (5, 33, 1000, 4, False, False),
             (7, 9, 1032, 4, False, False), (6, 20, 1040, 2, False, False),
             (6, 21, 1040, 2, False, False), (3, 17, 45, 3, False, False), (40, 64, 1024, 1, False, False),
             (4, 16, 4096, 1, False, False),
             (20, 64, 2048, 8, False, True),
             (REOPT_B, REOPT_M, REOPT_N, SEG_S, True, False), (70, 33, 300, 3, True, False),
             (65, 257, 1032, 4, True, False), (9, 16, 1040, 2, True, False),
             (100, 128, 2048, 8, True, False), (96, 64, 1024, 1, True, False),
             (33, 36, 576, 8, True, False), (REOPT_B, 256, REOPT_N, SEG_S, True, True))
    for Bn, m, n, S, shared, one in cases:
        w = n // S
        y, A, c, basis, seg = window_inputs(dev, g, Bn, m, n, S, shared, one, dtype)
        bland = torch.rand(Bn, generator=g, device=dev) < 0.2
        no = torch.zeros(Bn, dtype=torch.bool, device=dev)
        at_upper = torch.rand(Bn, n, generator=g, device=dev) < 0.3
        Ab = A.to(torch.bfloat16)
        kind = ("shared" if shared else "per-instance") + (" one window" if one else "")
        runs = [(fp, (y, A, c, basis, no)), (f"{fp} bland", (y, A, c, basis, bland)),
                ("bf16", (y, Ab, c, basis, no)), ("signed", (y, A, c, basis, bland)),
                ("signed bf16", (y, Ab, c, basis, no))]
        if (Bn, m, n) in ((SEG_B, SEG_M, SEG_N), (REOPT_B, REOPT_M, REOPT_N)):
            # a base one element off 16 bytes: no bulk / 16-byte copies
            runs += [(f"{fp} misaligned", (y, misaligned(A), c, basis, bland)),
                     ("bf16 misaligned", (y, misaligned(Ab), c, basis, no))]
        for tag, args in runs:
            up = at_upper if tag.startswith("signed") else None
            seen.add(window_layout(args[0], args[1], w, S))
            worst = max(worst, check_window_pricing(
                f"batch_pricing window {kind} {Bn}x{m}x{n} w={w} S={S} {tag}", dev, *args, w, S, seg, up))
        win = (w, S, seg)
        if (Bn, m, n) == (SEG_B, SEG_M, SEG_N):
            # the windows' A, y, c, the basis (int32), the segment counter
            # and the flag read once, p and min_e written
            nb = Bn * (es * (m * w + m + w) + 4 * m + 4 + 1 + 4 + es)
            A_w = ops.window_slice(A, ops.window_starts(win, n), w)
            rec.update({
                "window_ms": time_ms(lambda: hopper.choose_entering_batched(y, A, c, 1e-5, no, basis, None, win), 50),
                "window_plain_ms": time_ms(lambda: ops.choose_entering_batched(y, A, c, 1e-5, no, basis, None, win), 20),
                "window_bf16_ms": time_ms(lambda: hopper.choose_entering_batched(y, Ab, c, 1e-5, no, basis, None, win), 50),
                "window_bound_ms": bound(nb, 2.0 * Bn * m * w, peak)["bound_ms"],
                "window_bf16_bound_ms": bound(nb - Bn * (es - 2) * m * w, 2.0 * Bn * m * w, peak)["bound_ms"],
                # the product over the windows alone, on slices gathered beforehand
                "window_library_ms": time_ms(lambda: torch.bmm(y[:, None, :], A_w), 50),
            })
            del A_w
        if shared and (Bn, m, n) == (REOPT_B, REOPT_M, REOPT_N):
            # each distinct window of A read once; 2 B m w operations bound it
            nwin = int(torch.remainder(seg.long(), S).unique().numel())
            bd = bound(es * nwin * (m * w + w) + Bn * (es * m + 4 * m + 4 + 1 + 4 + es), 2.0 * Bn * m * w, peak)
            rec.update({
                "window_shared_ms": time_ms(lambda: hopper.choose_entering_batched(y, A, c, 1e-5, no, basis, None, win), 50),
                "window_shared_plain_ms": time_ms(lambda: ops.choose_entering_batched(y, A, c, 1e-5, no, basis, None, win), 10),
                "window_shared_bound_ms": bd["bound_ms"],
                "window_shared_bound_by": bd["bound_by"],
                # one GEMM over one window: the same operations
                "window_shared_library_ms": time_ms(lambda: y @ A[:, :w], 50),
            })
        del A, Ab
        torch.cuda.empty_cache()
    want = {"window_tma", "scan", "bf16x4", "window_group", "window_group_loads"}
    check(want <= seen, f"window layouts run {sorted(seen)}, want every one of {sorted(want)}")
    print(f"batch_pricing window layouts run ({fp}): {sorted(seen)}")
    rec["window_max_abs_err"] = worst
    return rec


def dmma_verdict(dev) -> dict:
    """The sum-order probe (``simplex_tpu_torch.bench.dmma_probe``): every
    f64 shape of ``mma.sync`` the build holds against the ascending fma
    chain, a verdict line a shape. Fails unless the shape on which
    batch_pricing's float64 shared layouts run (``hopper._BP_DMMA_K``)
    equals the chain bit for bit: their bit-for-bit checks rest on it."""
    from simplex_tpu_torch.bench import dmma_probe
    from simplex_tpu_torch.kernels import hopper

    t0 = time.perf_counter()
    res = dmma_probe.probe(dev)
    for line in dmma_probe.verdict_lines(res):
        print(line)
    print(f"dmma probe: {time.perf_counter() - t0:.1f} s")
    used = f"m16n8k{hopper._BP_DMMA_K}"
    check(res[used].get("equals_ascending_chain", False),
          f"dmma probe: {used}, on which the float64 shared layouts sum, is not the ascending fma chain")
    return {name: r.get("equals_ascending_chain") for name, r in res.items()}


def phase_batch_kernels(dev, dtype=None) -> dict:
    """The three batched kernels against their plain twins on the card:
    pricing (per-instance A on both the fp32 and the bf16 pair path, and a
    shared A through the tiled product at shapes that leave a tail on every
    tile axis, on its 16-byte-copy and element-load feeds; fp32, Bland,
    the bf16 shadow, the signed mode; 1.2e-4 of scale, every pick equal),
    the shared layout against the per-instance path on an expanded A (bit
    for bit), the tail (both paths, eager and deferred, Harris and
    classic, finished instances mixed in; bit for bit) and rank-1 (bit for
    bit), at bench.py --mode batch's shape, odd shapes and wide ones; then
    times at the bench's shape and the warm re-solve's. ``dtype`` float64:
    the same cases with every float operand in double (the shadow bf16
    beside double vectors), bit for bit where float32 is, min_e within
    F64_PRICING_RTOL of scale; records ``batch_pricing_f64``, ...."""
    import torch

    from simplex_tpu_torch.kernels import _build, hopper, ops

    dtype = dtype or torch.float32
    f32 = dtype == torch.float32
    fp, es, sfx = ("fp32", 4.0, "") if f32 else ("f64", 8.0, "_f64")
    peak = PEAK_FP32_S if f32 else PEAK_FP64_TC_S
    for code, size in ((0, 4), (1, 8)):
        check(_build.load_library().simplex_batch_pricing_record_bytes(code) == 4 * hopper._BP_RECORD_WORDS[size],
              f"batch_pricing: the record size of {size}-byte vectors differs from the wrapper's")
    g = torch.Generator(device=dev).manual_seed(11 if f32 else 21)
    recs = {}
    rp, rt, rr = f"batch_pricing{sfx}", f"batch_tail{sfx}", f"batch_rank1{sfx}"
    if not f32:
        recs[rp] = {"dmma_probe": dmma_verdict(dev)}
    tail_opts = TAIL_OPTS if f32 else F64_TAIL_OPTS
    # bench.py --mode batch's shape, odd n (element loads of bf16), n % 4 ==
    # 2 over two chunks (element loads), n % 4 == 0 over three chunks (the
    # four-column bf16 path with a chunk of 4 columns), a wide one
    shapes = ((BATCH_B, BATCH_M, BATCH_N), (3, 17, 45), (5, 33, 258), (7, 9, 516), (8, 2048, 4096))
    worst = 0.0
    for Bn, m, n in shapes:
        y, A, c, basis = batch_pricing_inputs(dev, g, Bn, m, n, dtype=dtype)
        bland = torch.rand(Bn, generator=g, device=dev) < 0.2
        no = torch.zeros(Bn, dtype=torch.bool, device=dev)
        at_upper = torch.rand(Bn, n, generator=g, device=dev) < 0.3
        Ab = A.to(torch.bfloat16)
        for tag, args in (
            (fp, (y, A, c, basis, no)), (f"{fp} bland", (y, A, c, basis, bland)),
            ("bf16", (y, Ab, c, basis, no)), ("signed", (y, A, c, basis, bland, at_upper)),
            ("signed bf16", (y, Ab, c, basis, no, at_upper)),
            ("bf16 misaligned", (y, misaligned(Ab), c, basis, bland)),
        ):
            worst = max(worst, check_batch_pricing(f"batch_pricing {Bn}x{m}x{n} {tag}", dev, *args))
        if (Bn, m, n) == (BATCH_B, BATCH_M, BATCH_N):
            # A, y and c read once, the basis (int32) and the flag read, p
            # and min_e written
            nb = Bn * (es * (m * n + m + n) + 4 * m + 1 + 4 + es)
            recs.setdefault(rp, {}).update({
                "ms": time_ms(lambda: hopper.choose_entering_batched(y, A, c, 1e-5, no, basis), 50),
                "plain_ms": time_ms(lambda: ops.choose_entering_batched(y, A, c, 1e-5, no, basis), 20),
                "bf16_ms": time_ms(lambda: hopper.choose_entering_batched(y, Ab, c, 1e-5, no, basis), 50),
                "bf16_plain_ms": time_ms(lambda: ops.choose_entering_batched(y, Ab, c, 1e-5, no, basis), 20),
                **bound(nb, 2.0 * Bn * m * n, peak),
                "bf16_bound_ms": bound(nb - Bn * (es - 2) * m * n, 2.0 * Bn * m * n, peak)["bound_ms"],
                # the product alone (no mask, no choice)
                "library_ms": time_ms(lambda: torch.bmm(y[:, None, :], A), 50),
            })
        del A, Ab
    # one A and c shared by the batch (the warm re-solve's primal clean-up):
    # tails on every tile axis (fp32: 64 instances, 32 rows, 128 columns;
    # float64: 128 instances, 32 rows, 64 columns), with 16-byte copies (m %
    # 4 == 0 and rows of a multiple of 16 bytes) and without, and bench.py
    # --mode reopt's shape
    for Bn, m, n in ((1, 1, 1), (3, 17, 45), (65, 33, 129), (130, 257, 1000), (130, 260, 1000),
                     (129, 36, 130), (129, 33, 65), (REOPT_B, REOPT_M, REOPT_N)):
        y, A, c, basis = batch_pricing_inputs(dev, g, Bn, m, n, shared=True, dtype=dtype)
        bland = torch.rand(Bn, generator=g, device=dev) < 0.2
        no = torch.zeros(Bn, dtype=torch.bool, device=dev)
        at_upper = torch.rand(Bn, n, generator=g, device=dev) < 0.3
        Ab = A.to(torch.bfloat16)
        for tag, args in (
            (fp, (y, A, c, basis, no)), (f"{fp} bland", (y, A, c, basis, bland)),
            ("bf16", (y, Ab, c, basis, no)), ("signed", (y, A, c, basis, bland, at_upper)),
            ("signed bf16", (y, Ab, c, basis, no, at_upper)),
            (f"{fp} misaligned", (misaligned(y), A, c, basis, bland)),
        ):
            worst = max(worst, check_batch_pricing(f"batch_pricing shared {Bn}x{m}x{n} {tag}", dev, *args))
        if Bn == REOPT_B:
            # A and c are read from memory once; 2 B m n flops bound it
            bd = bound(es * (m * n + n) + Bn * (es * m + 4 * m + 1 + 4 + es), 2.0 * Bn * m * n, peak)
            recs[rp].update({
                "reopt_ms": time_ms(lambda: hopper.choose_entering_batched(y, A, c, 1e-5, no, basis), 50),
                "reopt_plain_ms": time_ms(lambda: ops.choose_entering_batched(y, A, c, 1e-5, no, basis), 20),
                "reopt_bf16_ms": time_ms(lambda: hopper.choose_entering_batched(y, Ab, c, 1e-5, no, basis), 50),
                "reopt_bound_ms": bd["bound_ms"],
                "reopt_bound_by": bd["bound_by"],
                # the product alone: one GEMM
                "reopt_library_ms": time_ms(lambda: y @ A, 50),
            })
        del A, Ab
    recs[rp]["max_abs_err"] = worst
    check_shared_is_per_instance(dev, g, 8, REOPT_M, REOPT_N, dtype)
    check_shared_is_per_instance(dev, g, 70, 33, 300, dtype)
    recs[rp].update(phase_window_pricing(dev, g, dtype))
    # the tail: the warp path (m <= 256: rows a lane 1, 2, 4, 8, loads of 1,
    # 2 or 4 rows, idle lanes) and the block path (m > 256; and forced at
    # small m), with one input misaligned (single-row loads)
    for Bn, m, block in ((BATCH_B, BATCH_M, False), (BATCH_B, BATCH_M, True), (3, 17, False),
                         (37, 33, False), (37, 100, False), (37, 100, True), (37, 129, False),
                         (37, 256, False), (5, 257, False), (8, 2048, False), (37, 1100, False)):
        for L in (0, 4):
            t = batch_tail_inputs(dev, g, Bn, m, L, dtype)
            cases = [(f"batch_tail {Bn}x{m} L={L}", t)]
            if m == BATCH_M and not block:
                cases.append((f"batch_tail {Bn}x{m} L={L} misaligned", dict(t, alpha=misaligned(t["alpha"]))))
            for tag, tt in cases:
                for harris in (True, False):
                    path = tail_block_path() if block else contextlib.nullcontext()
                    with path:
                        check_batch_tail(f"{tag}{' block path' if block else ''} harris={harris}", dev, tt, harris)
    for tag, Bn, m in (("", BATCH_B, BATCH_M), ("cleanup_", REOPT_B, REOPT_M)):
        t = batch_tail_inputs(dev, g, Bn, m, 0, dtype)
        if tag:
            check_batch_tail(f"batch_tail {Bn}x{m} L=0 harris=True", dev, t, True)
        args = tuple(t[k] for k in TAIL_KEYS)
        r = {
            f"{tag}ms": time_ms(lambda: hopper.pivot_tail_batched(*args, harris=True, **tail_opts), 200),
            f"{tag}plain_ms": time_ms(lambda: hopper.pivot_tail_batched_plain(*args, harris=True, **tail_opts), 50),
        }
        # each operand at its own size: rows x_b, alpha, y, c_b, B_inv's row
        # in and eta, row, x_b, y, c_b out (es), the basis in and out (int32);
        # min_e, e_p, c_p (es), p, iters, degen, status (int32) and active
        # in, q, iters, status, degen (int32), theta_q (es) and 4 flags out
        bd = bound(Bn * (es * 10 * m + 4 * 2 * m + 3 * es + 4 * 4 + 1 + 4 * 4 + es + 4), 12.0 * Bn * m, peak)
        r.update({f"{tag}bound_ms": bd["bound_ms"], f"{tag}bound_by": bd["bound_by"]})
        if not tag:
            with tail_block_path():
                r["block_path_ms"] = time_ms(lambda: hopper.pivot_tail_batched(*args, harris=True, **tail_opts), 200)
            r.update({"library_ms": None, "max_abs_err": 0.0})
        recs.setdefault(rt, {}).update(r)
        del t, args
        torch.cuda.empty_cache()
    for Bn, m in ((BATCH_B, BATCH_M), (3, 17), (8, 2048), (5, 1025)):
        check_batch_rank1(f"batch_rank1 {fp} {Bn}x{m}", dev, g, Bn, m, dtype)
    for tag, Bn, m in (("", BATCH_B, BATCH_M), ("reopt_", REOPT_B, REOPT_M)):
        f = dict(generator=g, device=dev, dtype=dtype)
        B = torch.randn(Bn, m, m, **f)
        eta = torch.randn(Bn, m, **f) * 1e-6
        row = torch.randn(Bn, m, **f)
        take = torch.ones(Bn, dtype=torch.bool, device=dev)
        r = {
            f"{tag}ms": time_ms(lambda: hopper.rank1_update_batched(B, eta, row, take), 20),
            f"{tag}plain_ms": time_ms(lambda: hopper.rank1_update_batched_plain(B, eta, row, take), 5),
            f"{tag}library_ms": time_ms(lambda: B.baddbmm_(eta[:, :, None], row[:, None, :]), 20),
        }
        bd = bound(2 * es * Bn * m * m + 2 * es * Bn * m + Bn, 2.0 * Bn * m * m, peak)
        r.update({f"{tag}bound_ms": bd["bound_ms"], f"{tag}bound_by": bd["bound_by"]})
        recs.setdefault(rr, {}).update(r)
        del B
        torch.cuda.empty_cache()
    recs[rr]["max_abs_err"] = 0.0
    for name, r in recs.items():
        print(f"{name}: " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in r.items()))
    return recs


def batch_kernel_device_us(dev) -> dict:
    """Device us a call of the shared-A and bf16 pricing, the windows and
    both tail paths, from a torch.profiler trace of 20 calls each (CUDA
    events time the calls in phase 2): ``batch_pricing`` on a shared A at
    the warm re-solve's 256 x 2048 x 4096 and per instance on the bf16
    shadow at bench.py --mode batch's 4,096 x 64 x 160, its window per
    instance at the segmented cell's 64 x 512 x 4096 (fp32, bf16) and on the
    shared A with 8 segments; ``batch_tail`` at 4,096 x 64 on the warp path
    and on the block path, and at 256 x 2048 (the block path). Run it last:
    a profiler session makes every later launch of the process dearer."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simplex_tpu_torch.bench.profile_general import device_summary
    from simplex_tpu_torch.bench.timing import elapsed_ms
    from simplex_tpu_torch.kernels import hopper

    g = torch.Generator(device=dev).manual_seed(12)
    y, A, c, basis = batch_pricing_inputs(dev, g, REOPT_B, REOPT_M, REOPT_N, shared=True)
    no_r = torch.zeros(REOPT_B, dtype=torch.bool, device=dev)
    yb, Ab, cb, basis_b = batch_pricing_inputs(dev, g, BATCH_B, BATCH_M, BATCH_N)
    Ab = Ab.to(torch.bfloat16)
    no_b = torch.zeros(BATCH_B, dtype=torch.bool, device=dev)
    ys, As_, cs_, basis_s, seg_s = window_inputs(dev, g, SEG_B, SEG_M, SEG_N, SEG_S)
    As_b = As_.to(torch.bfloat16)
    no_s = torch.zeros(SEG_B, dtype=torch.bool, device=dev)
    win_s = (SEG_N // SEG_S, SEG_S, seg_s)
    seg_r = torch.randint(0, 1000, (REOPT_B,), generator=g, device=dev).to(torch.int32)
    win_r = (REOPT_N // SEG_S, SEG_S, seg_r)
    small = tuple(batch_tail_inputs(dev, g, BATCH_B, BATCH_M)[k] for k in TAIL_KEYS)
    wide = tuple(batch_tail_inputs(dev, g, REOPT_B, REOPT_M)[k] for k in TAIL_KEYS)
    f64 = torch.float64
    y64, A64, c64, basis64 = batch_pricing_inputs(dev, g, BATCH_B, BATCH_M, BATCH_N, dtype=f64)
    ys64, As64, cs64, basis_s64 = batch_pricing_inputs(dev, g, REOPT_B, REOPT_M, REOPT_N, shared=True, dtype=f64)
    small64 = tuple(batch_tail_inputs(dev, g, BATCH_B, BATCH_M, 0, f64)[k] for k in TAIL_KEYS)
    mid64 = tuple(batch_tail_inputs(dev, g, BATCH_B, 128, 0, f64)[k] for k in TAIL_KEYS)
    wide64 = tuple(batch_tail_inputs(dev, g, BATCH_B, 256, 0, f64)[k] for k in TAIL_KEYS)
    B64 = torch.randn(BATCH_B, BATCH_M, BATCH_M, generator=g, device=dev, dtype=f64)
    eta64 = torch.randn(BATCH_B, BATCH_M, generator=g, device=dev, dtype=f64) * 1e-6
    row64 = torch.randn(BATCH_B, BATCH_M, generator=g, device=dev, dtype=f64)
    take = torch.ones(BATCH_B, dtype=torch.bool, device=dev)

    def tail(args, opts=TAIL_OPTS):
        return lambda: hopper.pivot_tail_batched(*args, harris=True, **opts)

    cases = (
        ("batch_pricing shared 256x2048x4096", "batch_pricing_",
         lambda: hopper.choose_entering_batched(y, A, c, 1e-5, no_r, basis), contextlib.nullcontext),
        ("batch_pricing bf16 4096x64x160", "batch_pricing_",
         lambda: hopper.choose_entering_batched(yb, Ab, cb, 1e-5, no_b, basis_b), contextlib.nullcontext),
        ("batch_pricing window 64x512x4096", "batch_pricing_",
         lambda: hopper.choose_entering_batched(ys, As_, cs_, 1e-5, no_s, basis_s, None, win_s),
         contextlib.nullcontext),
        ("batch_pricing window bf16 64x512x4096", "batch_pricing_",
         lambda: hopper.choose_entering_batched(ys, As_b, cs_, 1e-5, no_s, basis_s, None, win_s),
         contextlib.nullcontext),
        ("batch_pricing window shared 256x2048x4096", "batch_pricing_",
         lambda: hopper.choose_entering_batched(y, A, c, 1e-5, no_r, basis, None, win_r),
         contextlib.nullcontext),
        ("batch_tail 4096x64 warp path", "batch_tail_", tail(small), contextlib.nullcontext),
        ("batch_tail 4096x64 block path", "batch_tail_", tail(small), tail_block_path),
        ("batch_tail 256x2048", "batch_tail_", tail(wide), contextlib.nullcontext),
        ("batch_pricing f64 4096x64x160", "batch_pricing_",
         lambda: hopper.choose_entering_batched(y64, A64, c64, 1e-5, no_b, basis64), contextlib.nullcontext),
        ("batch_pricing shared f64 256x2048x4096", "batch_pricing_",
         lambda: hopper.choose_entering_batched(ys64, As64, cs64, 1e-5, no_r, basis_s64), contextlib.nullcontext),
        ("batch_pricing window shared f64 256x2048x4096", "batch_pricing_",
         lambda: hopper.choose_entering_batched(ys64, As64, cs64, 1e-5, no_r, basis_s64, None, win_r),
         contextlib.nullcontext),
        ("batch_tail f64 4096x64 warp path", "batch_tail_", tail(small64, F64_TAIL_OPTS), contextlib.nullcontext),
        ("batch_tail f64 4096x128 warp path", "batch_tail_", tail(mid64, F64_TAIL_OPTS), contextlib.nullcontext),
        ("batch_tail f64 4096x128 block path", "batch_tail_", tail(mid64, F64_TAIL_OPTS), tail_block_path),
        ("batch_tail f64 4096x256 warp path", "batch_tail_", tail(wide64, F64_TAIL_OPTS), contextlib.nullcontext),
        ("batch_tail f64 4096x256 block path", "batch_tail_", tail(wide64, F64_TAIL_OPTS), tail_block_path),
        ("batch_rank1 f64 4096x64", "batch_rank1_kernel",
         lambda: hopper.rank1_update_batched(B64, eta64, row64, take), contextlib.nullcontext),
    )
    out = {}
    calls = 20

    def calls_of(fn):
        for _ in range(calls):
            fn()

    def trace(fn, key):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            calls_of(fn)
            torch.cuda.synchronize()
        by, _, _ = device_summary(prof, True)
        return {k: v / calls for k, v in by.items() if key in k}

    for tag, key, fn, path in cases:
        with path():
            fn()
            torch.cuda.synchronize()
            mine = profiled(lambda: trace(fn, key), bool, tag)
            if not mine:  # no trace held the kernels: CUDA events around the same calls
                mine = {"CUDA events, no trace": 1e3 * elapsed_ms(lambda: calls_of(fn), dev) / calls}
        out[tag] = sum(mine.values())
        check(out[tag] > 0, f"{tag}: no device time in the trace")
        print(f"device us a call, {tag}: {out[tag]:.2f} (" + ", ".join(f"{k[:70]} {v:.2f}" for k, v in mine.items()) + ")")
    return out


def phase_ratio_argmin(dev) -> dict:
    """The classic ratio test's cluster kernel against its plain version,
    bit for bit: Bland on and off (the flag as a bool and as an int32),
    degenerate rows (exact theta = 0 ties), an unbounded column; at one
    block, several (the general route's m = 1088 and 4352), 8 and beyond
    8 x 1024 rows (the stride loop). At m = 8192 it is timed beside
    ``ratio_eta`` with its tail off, which does strictly more work in the
    same shape of kernel."""
    import torch

    from simplex_tpu_torch.kernels import hopper

    g = torch.Generator(device=dev).manual_seed(3)
    rec = {}
    for m in (BENCH_M, BENCH_M - 1, ROUTE_A[0], ROUTE_B[0], 1000, 1024, 1025, 5000, 9000, 17):
        x_b = torch.rand(m, generator=g, device=dev) * 2
        x_b[::7] = 0.0
        alpha = torch.randn(m, generator=g, device=dev)
        basis = torch.randperm(m, generator=g, device=dev).to(torch.int32)
        for bland in (False, True):
            for unbounded, a in ((False, alpha), (True, -alpha.abs() - 1)):
                flag = torch.tensor(bland, device=dev)
                flag = flag.to(torch.int32) if unbounded else flag
                got = hopper.ratio_argmin(x_b, a, basis, 1e-7, flag)
                want = hopper.ratio_argmin_plain(x_b, a, basis, 1e-7, flag)
                torch.cuda.synchronize()
                tag = f"ratio_argmin m={m} bland={bland} unbounded-case={unbounded}"
                for k, name in enumerate(("q", "theta_q", "unbounded")):
                    check(got[k].shape == want[k].shape and got[k].dtype == want[k].dtype,
                          f"{tag}: {name} {got[k].shape} {got[k].dtype} vs {want[k].shape} {want[k].dtype}")
                check(int(got[0]) == int(want[0]), f"{tag}: q {int(got[0])} vs {int(want[0])}")
                check(float(got[1]) == float(want[1]), f"{tag}: theta_q {float(got[1])} vs {float(want[1])}")
                check(bool(got[2]) == bool(want[2]) == unbounded, f"{tag}: unbounded flag")
                print(f"{tag}: cluster of {hopper._ratio_cluster(m)}, q {int(got[0])} theta_q {float(got[1]):.6g} ok")
        if m == BENCH_M:
            flag = torch.tensor(False, device=dev)
            # bytes: x_b, alpha, basis in, three scalars out; ~3 flops a row
            rec = {
                "max_abs_err": 0.0,
                "ms": time_ms(lambda: hopper.ratio_argmin(x_b, alpha, basis, 1e-7, flag), 200),
                "plain_ms": time_ms(
                    lambda: hopper.ratio_argmin_plain(x_b, alpha, basis, 1e-7, flag), 200
                ),
                "ratio_eta_tail_off_ms": time_ms(
                    lambda: hopper.ratio_eta(x_b, alpha, basis, 1e-7, flag, False), 200
                ),
                **bound(12.0 * m + 12, 3.0 * m),
                "library_ms": None,
            }
            print(f"ratio_argmin m={m}, ms between events: {rec['ms']:.4f} (plain {rec['plain_ms']:.4f}; "
                  f"ratio_eta, classic, tail off {rec['ratio_eta_tail_off_ms']:.4f}); bound {rec['bound_ms']:.6f}")
    return rec


@functools.lru_cache(maxsize=None)
def instance(m: int, n: int):
    """``random_dense_lp(m, n, seed=0)``, made once."""
    from simplex_tpu_torch.oracle.generator import random_dense_lp

    return random_dense_lp(m, n, seed=0)


@functools.lru_cache(maxsize=None)
def highs(m: int, n: int):
    from simplex_tpu_torch.oracle.reference import solve_scipy

    return solve_scipy(*instance(m, n))


# results a later phase starts from: the default solves by (m, n), and the
# general route's run on B
KEPT: dict = {}


def timed_solve(dev, m, n, opts):
    """``solve`` on ``instance(m, n)`` from a synchronized start, with the
    kernels' launch counts, the pivot steps taken and the host reads of
    that run alone. Returns (result, wall seconds, counts, steps, reads)."""
    return timed_solve_of(dev, *instance(m, n), opts)


def timed_solve_of(dev, A, b, c, opts, mesh=None):
    """:func:`timed_solve` on the LP (A, b, c); A may be sparse. With
    ``mesh``, ``solve_sharded`` on it (this process's rank), whose
    collectives the caller reads from ``sharded.collectives``."""
    import torch

    from simplex_tpu_torch import solve, solve_sharded
    from simplex_tpu_torch.core import solver, step
    from simplex_tpu_torch.dist import sharded
    from simplex_tpu_torch.dist.card_check import count_calls
    from simplex_tpu_torch.kernels import hopper

    torch.cuda.synchronize()
    hopper.reset_launches()
    step.reset_host_reads()
    sharded.reset_collectives()
    with count_calls(solver, "pivot_step") as steps:
        t0 = time.perf_counter()
        if mesh is None:
            res = solve(A, b, c, options=opts, device=dev)
        else:
            res = solve_sharded(A, b, c, mesh, options=opts, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return res, wall, dict(hopper.launches), steps[0], dict(step.host_reads)


@contextlib.contextmanager
def loop_timer():
    """Seconds spent in the solver's pivot loops while the block runs, each
    loop synchronized at both ends: the solve without its set-up, its
    verify-round refactorizations and its polish. Yields a one-item list."""
    import torch

    from simplex_tpu_torch.core import solver

    inner, spent = solver._pivot_loop, [0.0]

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **k)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    solver._pivot_loop = timed
    try:
        yield spent
    finally:
        solver._pivot_loop = inner


def residual64(dev, m, n, res) -> float:
    """|A_B x_b - b|_inf in float64 for the returned basis."""
    A, b, _ = instance(m, n)
    return residual64_of(dev, A, b, res)


def residual64_of(dev, A, b, res) -> float:
    """:func:`residual64` for the dense LP matrix A and rhs b."""
    import numpy as np
    import torch

    A_d = torch.as_tensor(A, device=dev)
    basis = torch.as_tensor(res.basis.astype(np.int64), device=dev)
    x_b = torch.as_tensor(res.x_b, device=dev).double()
    r = A_d.index_select(1, basis).double() @ x_b - torch.as_tensor(b, device=dev).double()
    return float(r.abs().max())


def kkt64(dev, m, n, res, b=None) -> str:
    """An f64 check of the returned basis without an oracle: primal
    residual and sign, dual feasibility (reduced costs of the f64 duals)
    and the duality gap. Raises when the duals are infeasible. ``b``
    replaces the instance's rhs (a warm restart's)."""
    A, b0, c = instance(m, n)
    return kkt64_of(dev, A, b0 if b is None else b, c, res, f"{m}x{n}")


def kkt64_of(dev, A, b, c, res, tag, max_infeas=None) -> str:
    """:func:`kkt64` on the LP (A, b, c); a scipy.sparse A is checked
    through its float64 columns and a float64 SpMV on the card. Fails on
    a float64 primal infeasibility above ``max_infeas`` when given."""
    import numpy as np
    import torch

    from simplex_tpu_torch import sparse as sp

    if sp.is_sparse(A):
        A64 = sp.from_scipy(A, torch.float64, dev)
    else:
        A64 = torch.as_tensor(A, device=dev).double()
    b64 = torch.as_tensor(b, device=dev).double()
    c64 = torch.as_tensor(c, device=dev).double()
    basis = torch.as_tensor(res.basis.astype(np.int64), device=dev)
    A_B = sp.gather_columns(A64, basis) if sp.is_sparse(A) else A64.index_select(1, basis)
    x_b = torch.linalg.solve(A_B, b64)
    y = torch.linalg.solve(A_B.T, c64.index_select(0, basis))
    d = (sp.rmatvec(A64, y) if sp.is_sparse(A) else y @ A64) - c64  # optimal iff all >= -eps
    resid = float((A_B @ torch.as_tensor(res.x_b, device=dev).double() - b64).abs().max())
    gap = float(y @ b64) - float(c64.index_select(0, basis) @ x_b)
    min_d = float(d.min())
    # dual feasibility is the optimality test the solve certified; primal
    # infeasibility of order feas_tol is reported (the Harris ratio test
    # trades it for pivot size), and refused above max_infeas when given
    check(min_d >= -KKT_TOL, f"{tag}: min reduced cost {min_d}")
    if max_infeas is not None:
        check(float(x_b.min()) >= -max_infeas, f"{tag}: f64 min x_b {float(x_b.min())} below -{max_infeas}")
    return (
        f"f64 KKT: |A_B x_b - b|_inf {resid:.3e}, min x_b {float(x_b.min()):.3e}, "
        f"min reduced cost {min_d:.3e}, y.b - c.x {gap:.3e}, feas_err {res.feas_err:.3e}"
    )


def phase_solve(dev) -> dict:
    """The default path: sample, 2048 x 4096 against HiGHS, and the bench
    instance's 512-pivot window, where every step launches each of its
    three kernels once."""
    import numpy as np

    from simplex_tpu_torch import SimplexOptions, SolveStatus, load_lp, solve
    from simplex_tpu_torch.oracle.reference import relative_gap

    A, b, c = load_lp(ROOT / "tests" / "data" / "sample.txt")
    res = solve(A, b, c, device=dev)
    check(res.status == SolveStatus.OPTIMAL, f"sample: {res.status!r}")
    check(abs(res.z - 9.0) < 1e-5, f"sample: z = {res.z}")
    check(np.allclose(res.x, [1, 3, 0, 0], atol=1e-5), f"sample: x = {res.x}")
    print(f"sample.txt: OPTIMAL z {res.z} x {res.x.tolist()} pivots {res.iters}")

    res, wall, _, _, _ = timed_solve(dev, SMALL_M, SMALL_N, SimplexOptions())
    KEPT[(SMALL_M, SMALL_N)] = res
    ref = highs(SMALL_M, SMALL_N)
    gap = relative_gap(res.z, ref.z)
    check(res.status == SolveStatus.OPTIMAL, f"{SMALL_M}x{SMALL_N}: {res.status!r}")
    check(gap <= GAP_TOL, f"{SMALL_M}x{SMALL_N}: rel gap {gap:.3e} vs HiGHS")
    print(
        f"random_dense_lp({SMALL_M}, {SMALL_N}, seed=0): OPTIMAL z {res.z!r} HiGHS {ref.z!r} "
        f"rel_gap {gap:.3e} feas_err {res.feas_err:.3e} pivots {res.iters} wall {wall:.2f} s"
    )

    opts = SimplexOptions(max_iter=BENCH_WINDOW)
    with loop_timer() as loop:
        res, wall, counts, steps, reads = timed_solve(dev, BENCH_M, BENCH_N, opts)
    check(res.status == SolveStatus.MAX_ITER, f"{BENCH_M}x{BENCH_N}: {res.status!r}")
    check(res.iters == BENCH_WINDOW, f"{BENCH_M}x{BENCH_N}: {res.iters} pivots")
    for name in ("pricing_scan", "ratio_eta", "rank1_update"):
        check(counts[name] == BENCH_WINDOW, f"{name}: {counts[name]} launches in {BENCH_WINDOW} pivot steps")
    check(counts["ratio_argmin"] == 0, f"ratio_argmin: {counts['ratio_argmin']} launches")
    KEPT["window"] = (res, wall, reads, loop[0])
    resid = residual64(dev, BENCH_M, BENCH_N, res)
    print(
        f"random_dense_lp({BENCH_M}, {BENCH_N}, seed=0), max_iter={BENCH_WINDOW}: "
        f"{res.status.name} after {res.iters} pivots in {wall:.3f} s "
        f"({res.iters / wall:.1f} pivots/s end to end, setup and polish included; the pivot loop "
        f"alone {res.iters / loop[0]:.1f}); z {res.z!r}; f64 residual |A_B x_b - b|_inf {resid:.3e}; launches {counts}; "
        f"host reads {reads}"
    )
    return counts


def phase_pricing_rules(dev) -> dict:
    """Devex and steepest edge: 2048 x 4096 against HiGHS; the bench
    instance under steepest edge, eager and deferred, over the 512-pivot
    window and to OPTIMAL. Returns the launch counts per path."""
    from simplex_tpu_torch import SimplexOptions, SolveStatus
    from simplex_tpu_torch.oracle.reference import relative_gap

    paths = {}
    ref = highs(SMALL_M, SMALL_N)
    for rule in ("devex", "steepest"):
        res, wall, counts, steps, reads = timed_solve(dev, SMALL_M, SMALL_N, SimplexOptions(pricing=rule))
        gap = relative_gap(res.z, ref.z)
        check(res.status == SolveStatus.OPTIMAL, f"{rule} {SMALL_M}x{SMALL_N}: {res.status!r}")
        check(gap <= GAP_TOL, f"{rule} {SMALL_M}x{SMALL_N}: rel gap {gap:.3e} vs HiGHS")
        check(counts["ratio_eta"] == steps, f"{rule}: ratio_eta {counts['ratio_eta']} launches in {steps} steps")
        check(counts["rank1_update"] == steps, f"{rule}: rank1_update {counts['rank1_update']} launches in {steps} steps")
        check(counts["pricing_scan"] > 0, f"{rule}: no exact pricing pass (the terminal step needs one)")
        print(
            f"{rule} random_dense_lp({SMALL_M}, {SMALL_N}, seed=0): OPTIMAL z {res.z!r} HiGHS {ref.z!r} "
            f"rel_gap {gap:.3e} feas_err {res.feas_err:.3e} pivots {res.iters} (default path: "
            f"{KEPT[(SMALL_M, SMALL_N)].iters}) wall {wall:.2f} s; launches {counts}; host reads {reads}"
        )
        paths[f"{rule} {SMALL_M}x{SMALL_N}"] = counts
    cold = KEPT[(BENCH_M, BENCH_N)]
    for defer in (0, 16):
        tag = f"steepest update_defer={defer}"
        opts = SimplexOptions(pricing="steepest", update_defer=defer, max_iter=BENCH_WINDOW)
        res, wall, counts, steps, reads = timed_solve(dev, BENCH_M, BENCH_N, opts)
        check(res.status == SolveStatus.MAX_ITER and res.iters == BENCH_WINDOW, f"{tag}: {res.status!r} {res.iters}")
        check(counts["ratio_eta"] == steps, f"{tag}: ratio_eta {counts['ratio_eta']} launches in {steps} steps")
        check(counts["rank1_update"] == (0 if defer else steps),
              f"{tag}: rank1_update {counts['rank1_update']} launches in {steps} steps")
        resid = residual64(dev, BENCH_M, BENCH_N, res)
        check(resid <= 1e-4, f"{tag}: f64 residual {resid}")
        per_pivot = (reads["control"] + reads["branch"]) / res.iters
        print(
            f"{tag} on random_dense_lp({BENCH_M}, {BENCH_N}, seed=0), max_iter={BENCH_WINDOW}: "
            f"{res.status.name} after {res.iters} pivots ({steps} steps) in {wall:.3f} s "
            f"({res.iters / wall:.1f} pivots/s end to end, setup and polish included); z {res.z!r}; "
            f"f64 residual {resid:.3e}; launches {counts} ({counts['pricing_scan'] // 2} exact passes); "
            f"host reads {reads} ({per_pivot:.3f} per pivot)"
        )
        paths[f"{tag} window"] = counts
        res, wall, counts, steps, reads = timed_solve(
            dev, BENCH_M, BENCH_N, SimplexOptions(pricing="steepest", update_defer=defer)
        )
        check(res.status == SolveStatus.OPTIMAL, f"{tag} full solve: {res.status!r}")
        check(counts["ratio_eta"] == steps, f"{tag}: ratio_eta {counts['ratio_eta']} launches in {steps} steps")
        check(counts["pricing_scan"] > 0, f"{tag}: no exact pricing pass")
        if not defer:
            check(counts["rank1_update"] == steps, f"{tag}: rank1_update {counts['rank1_update']} in {steps} steps")
        gap = relative_gap(res.z, cold.z)
        print(
            f"{tag} full solve random_dense_lp({BENCH_M}, {BENCH_N}, seed=0): OPTIMAL z {res.z!r} "
            f"(default path {cold.z!r}, rel {gap:.3e}) after {res.iters} pivots ({steps} steps; default path "
            f"{cold.iters}) in {wall:.2f} s ({res.iters / wall:.1f} pivots/s); launches {counts}; "
            f"host reads {reads} ({(reads['control'] + reads['branch']) / max(1, res.iters):.3f} per pivot); "
            + kkt64(dev, BENCH_M, BENCH_N, res)
        )
        check(gap <= GAP_TOL, f"{tag}: z {res.z} vs the default path's {cold.z}")
        paths[f"{tag} full"] = counts
        KEPT[f"steepest update_defer={defer} full"] = res
    return paths


def warm_run(dev, A, b2, c, prev):
    """``reoptimize`` once from a synchronized start. Returns (result, wall
    seconds, dual pivots, launches of the dual loop, launches of the whole
    call, host reads)."""
    import torch

    from simplex_tpu_torch import reoptimize
    from simplex_tpu_torch.core import dual, step
    from simplex_tpu_torch.kernels import hopper

    seen = {}
    inner = dual.dual_solve_state

    def counted(*a, **k):
        before = dict(hopper.launches)
        s = inner(*a, **k)
        seen["pivots"] = int(s.iters)
        seen["launches"] = {n: hopper.launches[n] - before[n] for n in before}
        return s

    torch.cuda.synchronize()
    hopper.reset_launches()
    step.reset_host_reads()
    dual.dual_solve_state = counted
    try:
        t0 = time.perf_counter()
        res = reoptimize(A, b2, c, prev, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        dual.dual_solve_state = inner
    check(seen["launches"]["rank1_update"] == seen["pivots"],
          f"dual loop: rank1_update {seen['launches']['rank1_update']} launches in {seen['pivots']} dual pivots")
    return res, wall, seen["pivots"], seen["launches"], dict(hopper.launches), dict(step.host_reads)


def phase_warm_restart(dev) -> dict:
    """``ranging`` and ``reoptimize`` from the default solves' results: one
    b_i moved inside its allowable range, then past it."""
    import numpy as np

    from simplex_tpu_torch import SolveStatus, ranging
    from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy

    paths = {}
    for m, n in ((SMALL_M, SMALL_N), (BENCH_M, BENCH_N)):
        A, b, c = instance(m, n)
        cold = KEPT[(m, n)]
        tag = f"warm restart {m}x{n}"
        prev = cold
        # the dual loop's exit test: feas_tol (1 + |x_b|_inf)
        entry_tol = 1e-6 * (1 + float(np.abs(cold.x_b).max()))
        if cold.feas_err > entry_tol:
            prev, wall, dual_piv, _, _, _ = warm_run(dev, A, b, c, cold)
            check(prev.status == SolveStatus.OPTIMAL, f"{tag}: repair {prev.status!r}")
            print(
                f"{tag}: the cold basis is primal infeasible by {cold.feas_err:.3e} (> {entry_tol:.3e}); "
                f"reoptimize on the unchanged b: {dual_piv} dual + {prev.iters - dual_piv} primal pivots in "
                f"{wall:.2f} s, feas_err {prev.feas_err:.3e}, z {prev.z!r} (cold {cold.z!r})"
            )
        t0 = time.perf_counter()
        rng = ranging(A, b, c, prev.basis, device=dev)
        t_rng = time.perf_counter() - t0
        check(rng.ok, f"{tag}: ranging could not invert the basis")
        # the row with the widest finite upward range no larger than b_i
        # itself: raising b_i keeps the LP feasible (its slack absorbs it).
        # b_lo may sit just above 0 where a basic value is negative within
        # the solver's tolerance; moving up inside the range only helps it
        room = np.where(np.isfinite(rng.b_hi) & (rng.b_hi <= np.abs(b)), rng.b_hi, -np.inf)
        i = int(np.argmax(room))
        check(room[i] > 1e-3, f"{tag}: no row with a usable finite range (best {room[i]})")
        print(f"{tag}: ranging in {t_rng:.2f} s; row {i}: b {b[i]:.6f}, allowable delta "
              f"[{rng.b_lo[i]:.6f}, {rng.b_hi[i]:.6f}], y_i {rng.y[i]:.6f}")
        for where, factor in (("inside", 0.5), ("outside", 1.5)):
            b2 = np.array(b, np.float64)
            b2[i] += factor * rng.b_hi[i]
            b2 = b2.astype(np.float32)
            res, wall, dual_piv, dual_launches, counts, reads = warm_run(dev, A, b2, c, prev)
            check(res.status == SolveStatus.OPTIMAL, f"{tag} {where}: {res.status!r}")
            same = sorted(res.basis.tolist()) == sorted(prev.basis.tolist())
            if where == "inside":
                check(dual_piv == 0, f"{tag} inside: {dual_piv} dual pivots")
                check(same, f"{tag} inside: the basis changed")
                # inside the range the optimum moves at rate y_i
                want = prev.z + float(rng.y[i]) * factor * float(rng.b_hi[i])
                check(relative_gap(res.z, want) <= GAP_TOL, f"{tag} inside: z {res.z} vs z + y_i delta {want}")
                verdict = f"z + y_i delta {want!r}"
            else:
                check(dual_piv > 0, f"{tag} outside: no dual pivot")
                check(not same, f"{tag} outside: the basis did not change")
                if (m, n) == (SMALL_M, SMALL_N):
                    ref = solve_scipy(A, b2, c)
                    gap = relative_gap(res.z, ref.z)
                    check(gap <= GAP_TOL, f"{tag} outside: rel gap {gap:.3e} vs HiGHS")
                    verdict = f"HiGHS {ref.z!r} rel_gap {gap:.3e}"
                else:
                    verdict = kkt64(dev, m, n, res, b2)
            print(
                f"{tag}, b_{i} + {factor} x its range ({where}): OPTIMAL z {res.z!r}; {dual_piv} dual + "
                f"{res.iters - dual_piv} primal clean-up pivots in {wall:.2f} s (cold solve: {cold.iters} "
                f"pivots); same basis {same}; feas_err {res.feas_err:.3e}; {verdict}; dual loop launches "
                f"{dual_launches}; all launches {counts}; host reads {reads}"
            )
            paths[f"{tag} {where}"] = counts
    return paths


def phase_general_warm(dev) -> dict:
    """``solve_general(warm=)`` on B with every b_i moved by up to 5%,
    from the token of the cold run, against HiGHS."""
    import numpy as np
    import torch

    from simplex_tpu_torch import SolveStatus, solve_general
    from simplex_tpu_torch.core import step
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy_general

    lp, cold = KEPT["general B"]
    check(cold.warm is not None, "general warm: the cold run left no token")
    rng = np.random.default_rng(0)
    lp2 = lp._replace(b=np.asarray(lp.b) * (1 + 0.05 * rng.uniform(-1, 1, np.shape(lp.b))))
    t0 = time.perf_counter()
    ref = solve_scipy_general(lp2)
    t_ref = time.perf_counter() - t0
    torch.cuda.synchronize()
    hopper.reset_launches()
    step.reset_host_reads()
    t0 = time.perf_counter()
    res = solve_general(lp2, warm=cold.warm, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(hopper.launches)
    tag = "general B warm, b moved 5%"
    check(res.status == ref.status, f"{tag}: {res.status!r} vs HiGHS {ref.status!r}")
    check(res.phase1_iters == 0, f"{tag}: phase 1 ran")
    note = ""
    if ref.status == SolveStatus.OPTIMAL:
        gap = relative_gap(res.z, ref.z)
        viol = general_violation(lp2, res.x)
        note = f" z {res.z!r} HiGHS {ref.z!r} rel_gap {gap:.3e} violation {viol:.3e};"
        check(gap <= GAP_TOL, f"{tag}: rel gap {gap:.3e} vs HiGHS")
        check(viol <= FEAS_TOL, f"{tag}: violation {viol:.3e}")
        check(counts["rank1_update"] > 0, f"{tag}: rank1_update never launched")
    print(
        f"{tag}: {res.status.name};{note} {res.iters} pivots, no phase 1 (cold: {cold.iters}, "
        f"{cold.phase1_iters} in phase 1) in {wall:.2f} s (HiGHS {t_ref:.2f} s); launches {counts}; "
        f"host reads {dict(step.host_reads)}"
    )
    return {tag: counts}


def phase_device_ops(dev) -> None:
    """Device operations a pivot of the default path issues, from a
    profiled stretch of the solver's pivot loop on the bench instance
    (``simplex_tpu_torch.bench.profile_canonical``): every kernel, memset
    and copy the card ran, over the pivots taken. Fails above
    MAX_DEVICE_OPS_PER_PIVOT."""
    from simplex_tpu_torch import SimplexOptions
    from simplex_tpu_torch.bench.profile_canonical import profile_loop

    A, b, c = instance(BENCH_M, BENCH_N)
    rec = profiled(lambda: profile_loop(A, b, c, SimplexOptions(), dev, warm=32, window=128),
                   lambda r: r["device_us_per_pivot"] > 0, "default path profile")
    ops = rec["device_ops_per_pivot"]
    print(
        f"default path, {rec['pivots_traced']} profiled pivots: {ops:.2f} device ops a pivot "
        f"(limit {MAX_DEVICE_OPS_PER_PIVOT}), {rec['device_us_per_pivot']:.1f} device us and "
        f"{rec['wall_ms_per_pivot']:.3f} wall ms a pivot, busy {rec['device_busy']:.1%}; "
        f"launches a pivot {rec['launches_per_pivot']}; largest items (us a pivot) {rec['top_us_per_pivot']}"
    )
    check(rec["device_us_per_pivot"] > 0, "the profiler saw no device time")
    check(ops <= MAX_DEVICE_OPS_PER_PIVOT, f"{ops:.2f} device ops a pivot on the default path")
    for name in ("pricing_scan", "ratio_eta", "rank1_update"):
        check(rec["launches_per_pivot"][name] == 1.0, f"{name}: {rec['launches_per_pivot'][name]} launches a pivot")


def phase_ratio_device_time(dev, dtype=None) -> dict:
    """Device time of one launch of each ratio kernel at m = 8192, from a
    profiler trace of the per-op bench's loop, in ``dtype`` (float32 when
    None)."""
    import torch

    from simplex_tpu_torch.bench.kernels import ratio_device_us

    dtype = torch.float32 if dtype is None else dtype

    def once():
        try:
            return ratio_device_us(BENCH_M, device=dev, dtype=dtype)
        except RuntimeError as e:  # the trace did not hold the launches
            print(e)
            return None

    us = profiled(once, lambda r: r is not None and all(v > 0 for v in r.values()), f"ratio kernels {dtype}")
    check(us is not None, "the profiler did not record the ratio kernels' launches")
    print(f"device us a launch at m={BENCH_M}, {dtype}: {us}")
    check(all(v > 0 for v in us.values()), "the profiler saw no device time for a ratio kernel")
    return us


def phase_full_solve(dev) -> None:
    """The benchmark instance solved to OPTIMAL with the default options."""
    from simplex_tpu_torch import SimplexOptions, SolveStatus

    res, wall, _, _, _ = timed_solve(dev, BENCH_M, BENCH_N, SimplexOptions())
    KEPT[(BENCH_M, BENCH_N)] = res
    check(res.status == SolveStatus.OPTIMAL, f"full solve: {res.status!r}")
    print(
        f"full solve random_dense_lp({BENCH_M}, {BENCH_N}, seed=0): OPTIMAL z {res.z!r} "
        f"after {res.iters} pivots in {wall:.2f} s ({res.iters / wall:.1f} pivots/s); "
        + kkt64(dev, BENCH_M, BENCH_N, res)
    )


def phase_flagship_window(dev) -> dict:
    """bench.py's option set over the 512-pivot window, with multiple
    pricing on (64) and off. Every step launches ratio_eta once; without
    multiple pricing every pivot prices through pricing_scan at least once;
    the deferred update never launches rank1_update."""
    from simplex_tpu_torch import SimplexOptions, SolveStatus

    paths = {}
    for mp in (FLAGSHIP["multi_price"], 0):
        opts = SimplexOptions(max_iter=BENCH_WINDOW, **{**FLAGSHIP, "multi_price": mp})
        res, wall, counts, steps, reads = timed_solve(dev, BENCH_M, BENCH_N, opts)
        tag = f"flagship multi_price={mp}"
        check(res.status == SolveStatus.MAX_ITER, f"{tag}: {res.status!r}")
        check(res.iters == BENCH_WINDOW, f"{tag}: {res.iters} pivots")
        check(counts["ratio_eta"] == steps, f"{tag}: ratio_eta {counts['ratio_eta']} launches in {steps} steps")
        check(counts["rank1_update"] == 0, f"{tag}: rank1_update {counts['rank1_update']} launches")
        if mp == 0:
            check(counts["pricing_scan"] >= res.iters, f"{tag}: pricing_scan {counts['pricing_scan']} launches")
        resid = residual64(dev, BENCH_M, BENCH_N, res)
        check(resid <= 1e-4, f"{tag}: f64 residual {resid}")
        per_pivot = (reads["control"] + reads["branch"]) / res.iters
        print(
            f"{tag} on random_dense_lp({BENCH_M}, {BENCH_N}, seed=0), max_iter={BENCH_WINDOW}: "
            f"{res.status.name} after {res.iters} pivots ({steps} steps) in {wall:.3f} s "
            f"({res.iters / wall:.1f} pivots/s end to end, setup and polish included); "
            f"z {res.z!r}; f64 residual |A_B x_b - b|_inf {resid:.3e}; launches {counts}; "
            f"host reads {reads} ({per_pivot:.3f} per pivot)"
        )
        paths[tag] = counts
    return paths


def phase_flagship_full(dev) -> None:
    """bench.py's option set solved to OPTIMAL: 2048 x 4096 against HiGHS,
    and the bench instance with bench.py's full-solve refactor cadence."""
    from simplex_tpu_torch import SimplexOptions, SolveStatus
    from simplex_tpu_torch.oracle.reference import relative_gap

    opts = SimplexOptions(refactor_every=FLAGSHIP_REFACTOR, **FLAGSHIP)
    res, wall, counts, _, reads = timed_solve(dev, SMALL_M, SMALL_N, opts)
    ref = highs(SMALL_M, SMALL_N)
    gap = relative_gap(res.z, ref.z)
    check(res.status == SolveStatus.OPTIMAL, f"flagship {SMALL_M}x{SMALL_N}: {res.status!r}")
    check(gap <= GAP_TOL, f"flagship {SMALL_M}x{SMALL_N}: rel gap {gap:.3e} vs HiGHS")
    print(
        f"flagship random_dense_lp({SMALL_M}, {SMALL_N}, seed=0): OPTIMAL z {res.z!r} HiGHS {ref.z!r} "
        f"rel_gap {gap:.3e} feas_err {res.feas_err:.3e} pivots {res.iters} wall {wall:.2f} s; "
        f"launches {counts}; host reads {reads}"
    )
    res, wall, counts, _, reads = timed_solve(dev, BENCH_M, BENCH_N, opts)
    check(res.status == SolveStatus.OPTIMAL, f"flagship full solve: {res.status!r}")
    print(
        f"flagship full solve random_dense_lp({BENCH_M}, {BENCH_N}, seed=0), "
        f"refactor_every={FLAGSHIP_REFACTOR}: OPTIMAL z {res.z!r} after {res.iters} pivots "
        f"in {wall:.2f} s ({res.iters / wall:.1f} pivots/s); launches {counts}; "
        f"host reads {reads}; " + kkt64(dev, BENCH_M, BENCH_N, res)
    )


def phase_bench_ops(dev) -> dict:
    """The per-op bench on both backends: the path that runs ratio_argmin."""
    from simplex_tpu_torch.bench.kernels import bench_ops, record_line
    from simplex_tpu_torch.kernels import hopper

    counts = {}
    for backend in ("hopper", "torch"):
        hopper.reset_launches()
        ops = bench_ops(BENCH_M, BENCH_N, k=32, backend=backend, device=dev)
        counts[backend] = dict(hopper.launches)
        print(record_line(BENCH_M, BENCH_N, backend, dev, ops))
    check(counts["hopper"]["ratio_argmin"] > 0, "per-op bench: ratio_argmin never launched")
    check(not any(counts["torch"].values()), f"per-op bench, torch backend: launches {counts['torch']}")
    return counts["hopper"]


class RouteProbe:
    """Times the general route's stages and counts kernel launches per
    solver call, by wrapping the module functions the route calls (the
    wrappers are removed on exit). ``calls`` holds one record per
    ``solve`` call of the route, labelled by what it is: phase 2 (and its
    penalty retries) starts from the phase-1 bounds state and so passes
    ``at_upper0``; phase 1 does not."""

    def __init__(self):
        self.seconds = collections.Counter()
        self.calls = []
        self._undo = []

    def _wrap(self, module, name, stage):
        inner = getattr(module, name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return inner(*a, **k)
            finally:
                self.seconds[stage] += time.perf_counter() - t0

        setattr(module, name, timed)
        self._undo.append((module, name, inner))

    def __enter__(self):
        import torch

        from simplex_tpu_torch.core import solver, twophase
        from simplex_tpu_torch.kernels import hopper

        presolve_mod = sys.modules["simplex_tpu_torch.presolve"]
        self._wrap(twophase, "_preprocess_bounds", "standardize")
        self._wrap(twophase, "_standardize", "standardize")
        self._wrap(twophase, "_drive_out_artificials", "driveout")
        self._wrap(presolve_mod, "presolve", "presolve")
        self._wrap(presolve_mod, "postsolve", "presolve")
        self._wrap(solver, "finalize_result", "polish")
        inner = twophase.solve

        def solve(*a, **k):
            before = dict(hopper.launches)
            polish0 = self.seconds["polish"]
            t0 = time.perf_counter()
            r = inner(*a, **k)
            torch.cuda.synchronize()
            self.calls.append({
                "phase": 2 if "at_upper0" in k else 1,
                "seconds": time.perf_counter() - t0 - (self.seconds["polish"] - polish0),
                "pivots": r.iters,
                "status": r.status.name,
                "feas_err": r.feas_err,
                "launches": {n: hopper.launches[n] - before[n] for n in before},
            })
            return r

        twophase.solve = solve
        self._undo.append((twophase, "solve", inner))
        return self

    def __exit__(self, *exc):
        for module, name, inner in reversed(self._undo):
            setattr(module, name, inner)
        return False

    def phases(self, res):
        """(phase 1 record or None, the phase-2 records) of the route's
        result ``res``; raises unless the calls seen add up to it."""
        p1 = [c for c in self.calls if c["phase"] == 1]
        p2 = [c for c in self.calls if c["phase"] == 2]
        check(len(p1) <= 1 and len(p2) >= 1, f"route probe: solver calls {[c['phase'] for c in self.calls]}")
        got = (p1[0]["pivots"] if p1 else 0, sum(c["pivots"] for c in self.calls))
        check(got == (res.phase1_iters, res.iters), f"route probe: pivots {got} vs the result's")
        return (p1[0] if p1 else None), p2


def general_violation(lp, x) -> float:
    """The largest row or bound violation of x in the LP's own (f64)
    terms, over max(1, |b|_inf)."""
    import numpy as np
    import scipy.sparse as sps

    A = lp.A.tocsr().astype(np.float64) if sps.issparse(lp.A) else np.asarray(lp.A, np.float64)
    r = A @ x - np.asarray(lp.b, np.float64)
    sign = {"L": 1.0, "G": -1.0}
    viol = [abs(ri) if t == "E" else max(0.0, sign[t] * ri) for ri, t in zip(r, lp.row_types)]
    k = len(x)
    lo = np.zeros(k) if lp.lower is None else np.asarray(lp.lower, np.float64)
    up = np.full(k, np.inf) if lp.upper is None else np.asarray(lp.upper, np.float64)
    worst = max(max(viol, default=0.0), float(np.max(lo - x, initial=0.0)),
                float(np.max(x - up, initial=0.0)))
    return worst / max(1.0, float(np.abs(lp.b).max()))


def general_run(dev, tag, lp, ref, opts, presolve):
    """``solve_general`` once from a synchronized start, with the launch
    counts set to 0 just before; checks it against HiGHS (``ref``) and
    returns (result, probe, launches)."""
    import torch

    from simplex_tpu_torch import SolveStatus, solve_general
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle.reference import relative_gap

    torch.cuda.synchronize()
    hopper.reset_launches()
    with RouteProbe() as probe:
        t0 = time.perf_counter()
        res = solve_general(lp, options=opts, presolve=presolve, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = dict(hopper.launches)
    check(res.status == SolveStatus.OPTIMAL, f"{tag}: {res.status!r}")
    p1, p2 = probe.phases(res)
    gap = relative_gap(res.z, ref.z)
    feas = max(c["feas_err"] for c in p2)
    viol = general_violation(lp, res.x)
    st = probe.seconds
    print(
        f"{tag}: {res.status.name} z {res.z!r} HiGHS {ref.z!r} rel_gap {gap:.3e} "
        f"feas_err (f64, bounded) {feas:.3e} violation (original rows, bounds) {viol:.3e}; "
        f"pivots phase 1 {res.phase1_iters} total {res.iters}; wall {wall:.3f} s: "
        f"presolve {st['presolve']:.3f}, standardize {st['standardize']:.3f}, "
        f"phase 1 {p1['seconds'] if p1 else 0.0:.3f}, driveout {st['driveout']:.3f}, "
        f"phase 2 {sum(c['seconds'] for c in p2):.3f}, polish {st['polish']:.3f} s; "
        f"launches phase 1 {p1['launches'] if p1 else {}}, "
        f"phase 2 {[c['launches'] for c in p2]}"
    )
    check(gap <= GAP_TOL, f"{tag}: rel gap {gap:.3e} vs HiGHS")
    check(feas <= FEAS_TOL, f"{tag}: feas_err {feas:.3e}")
    check(viol <= FEAS_TOL, f"{tag}: violation {viol:.3e}")
    return res, probe, counts


def phase_mps_cli(dev) -> dict:
    """Every tests/data/*.mps through ``python -m simplex_tpu_torch.cli
    solve FILE`` (in process) on the card, against HiGHS on the same
    instance: the exit code, and the printed optimum (instance sense,
    %g) within GAP_TOL."""
    import torch

    from simplex_tpu_torch import SolveStatus, cli
    from simplex_tpu_torch.core.twophase import GeneralLP
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy, solve_scipy_general

    counts = collections.Counter()
    for path in sorted((ROOT / "tests" / "data").glob("*.mps")):
        loaded, c0, maximize = cli._load(str(path), True)
        if isinstance(loaded, GeneralLP):
            ref = solve_scipy_general(loaded)
        else:
            A, b, c, _ = loaded
            ref = solve_scipy(A, b, c)
        torch.cuda.synchronize()
        hopper.reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["solve", str(path), "--device", str(dev)])
        wall = time.perf_counter() - t0
        counts.update(hopper.launches)
        lines = out.getvalue().splitlines()
        route = "general" if isinstance(loaded, GeneralLP) else "canonical"
        note = f"mps {path.name} ({route} route): rc {rc}, '{lines[0]}', {lines[-1]}, wall {wall:.3f} s"
        if ref.status == SolveStatus.OPTIMAL:
            want = (ref.z if maximize else -ref.z) + c0
            got = float(lines[0].split(":")[1])
            gap = relative_gap(got, want)
            print(f"{note}; HiGHS {want!r} rel_gap {gap:.3e} (6 printed digits)")
            check(rc == 0 and gap <= GAP_TOL, f"mps {path.name}: rc {rc}, rel gap {gap:.3e}")
        else:
            print(f"{note}; HiGHS {ref.status.name}")
            check(rc == 2 and lines[0] == ref.status.describe(), f"mps {path.name}: {lines[0]}")
    return dict(counts)


def phase_general(dev) -> dict:
    """The general route at full width: A and B (bounded) under both option
    sets, with and without presolve; C (no bounds) under the default
    options. Returns the launch counts per path."""
    import torch

    from simplex_tpu_torch import SimplexOptions
    from simplex_tpu_torch.oracle.generator import multiperiod_production_lp, transportation_lp
    from simplex_tpu_torch.oracle.reference import solve_scipy_general

    paths = {}
    sets = {"default": SimplexOptions(), "bench-general": SimplexOptions(**GENERAL_BENCH)}
    for size, (T, P) in GENERAL_SIZES.items():
        lp = multiperiod_production_lp(T, P, seed=0)
        t0 = time.perf_counter()
        ref = solve_scipy_general(lp)
        print(f"general {size} multiperiod_production_lp({T}, {P}, seed=0): {len(lp.b)} rows, "
              f"{lp.A.shape[1]} bounded columns; HiGHS {ref.status.name} in {time.perf_counter() - t0:.2f} s")
        for opt_name, opts in sets.items():
            for presolve in (False, True):
                tag = f"general {size} {opt_name} presolve={presolve}"
                res, probe, counts = general_run(dev, tag, lp, ref, opts, presolve)
                if (size, opt_name, presolve) == ("B", "default", False):
                    KEPT["general B"] = (lp, res)
                    KEPT["general B HiGHS"] = ref
                # signed pricing runs through pricing_scan under both option
                # sets (on the bf16 shadow under bench.py --mode general's)
                check(counts["pricing_scan"] > 0, f"{tag}: pricing_scan never launched")
                if opt_name == "default":
                    check(counts["rank1_update"] > 0, f"{tag}: rank1_update never launched")
                paths[tag] = counts
        del lp
        torch.cuda.empty_cache()

    ns, nd = TRANSPORT_C
    lp = transportation_lp(ns, nd, seed=0, balanced=False)
    t0 = time.perf_counter()
    ref = solve_scipy_general(lp)
    print(f"general C transportation_lp({ns}, {nd}, seed=0, balanced=False): {len(lp.b)} rows, "
          f"{lp.A.shape[1]} columns, no bounds; HiGHS {ref.status.name} in {time.perf_counter() - t0:.2f} s")
    tag = "general C default presolve=False"
    KEPT["general C"] = (lp, ref)
    res, probe, counts = general_run(dev, tag, lp, ref, SimplexOptions(), False)
    p1, p2 = probe.phases(res)
    check(p1 is not None, f"{tag}: no phase 1")
    for phase, rec in (("phase 1", p1), ("phase 2", p2[0])):
        for name in ("pricing_scan", "ratio_eta", "rank1_update"):
            check(rec["launches"][name] > 0, f"{tag}: {name} never launched in {phase}")
    paths[tag] = counts
    return paths


SCRATCH = ROOT / "build" / "chip_smoke"  # snapshots (build/ is git-ignored)


def phase_trace(dev) -> dict:
    """The pivot trace on the card: the sample's known path, and 256 pivots
    of the 2048 x 4096 instance against ``solve(max_iter=k)``'s bases. The
    trace prices once more a pivot for ``min_reduced_cost`` (one
    pricing_scan call), so it launches pricing_scan twice a pivot step."""
    import numpy as np
    import torch

    from simplex_tpu_torch import SimplexOptions, SolveStatus, load_lp, solve
    from simplex_tpu_torch.core.trace import trace_pivots
    from simplex_tpu_torch.kernels import hopper

    paths = {}
    A, b, c = load_lp(ROOT / "tests" / "data" / "sample.txt")
    hopper.reset_launches()
    recs = list(trace_pivots(A, b, c, device=dev))
    paths["trace sample"] = dict(hopper.launches)
    got = [(r.entering, r.leaving, r.leaving_row, r.objective) for r in recs]
    check(got == [(0, 3, 1, 7.5), (1, 2, 0, 9.0), (-1, -1, -1, 9.0)], f"trace sample: {got}")
    check(recs[-1].status == SolveStatus.OPTIMAL, f"trace sample: {recs[-1].status!r}")
    check([r.min_reduced_cost for r in recs] == [-3.0, -0.5, 1.0], "trace sample: min reduced costs")
    print(f"trace sample.txt: entering/leaving/row/z {got}; min_e {[r.min_reduced_cost for r in recs]}; "
          f"launches {paths['trace sample']}")

    A, b, c = instance(SMALL_M, SMALL_N)
    opts = SimplexOptions(perturb_after=0)  # the trace arms no perturbation
    torch.cuda.synchronize()
    hopper.reset_launches()
    t0 = time.perf_counter()
    recs = list(trace_pivots(A, b, c, options=opts, max_iter=TRACE_PIVOTS, device=dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(hopper.launches)
    tag = f"trace {SMALL_M}x{SMALL_N}"
    paths[tag] = counts
    check(len(recs) == TRACE_PIVOTS and recs[-1].status == SolveStatus.RUNNING, f"{tag}: {len(recs)} records")
    check(counts["pricing_scan"] == 2 * TRACE_PIVOTS, f"{tag}: pricing_scan {counts['pricing_scan']}")
    for name in ("ratio_eta", "rank1_update"):
        check(counts[name] == TRACE_PIVOTS, f"{tag}: {name} {counts[name]} launches")
    ks = (1, TRACE_PIVOTS // 4, TRACE_PIVOTS // 2, TRACE_PIVOTS)
    for k in ks:
        res = solve(A, b, c, options=SimplexOptions(perturb_after=0, max_iter=k), device=dev)
        check(res.iters == k and np.array_equal(res.basis, recs[k - 1].basis),
              f"{tag}: the basis after {k} pivots differs from solve(max_iter={k})'s")
        check(abs(res.z - recs[k - 1].objective) <= 1e-5 * max(1.0, abs(res.z)), f"{tag}: z after {k} pivots")
    print(f"{tag}: {len(recs)} pivots traced in {wall:.3f} s ({len(recs) / wall:.1f} pivots/s, the records' "
          f"host copies included); the basis after pivots {ks} equals solve(max_iter=k)'s; "
          f"z {recs[-1].objective!r}; launches {counts}")
    return paths


class Stop(Exception):
    """Raised from ``on_chunk`` to stop a checkpointed solve."""


def checkpointed_run(dev, tag, A, b, c, opts, light, want_z, kkt):
    """``solve_with_checkpoints`` stopped after its second snapshot, then
    resumed in a fresh call; the snapshot's save / load seconds and size.
    Returns the launch counts of both calls."""
    import os

    import torch

    from simplex_tpu_torch import SolveStatus
    from simplex_tpu_torch.core import checkpoint as ck
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle.reference import relative_gap

    SCRATCH.mkdir(parents=True, exist_ok=True)
    path = SCRATCH / f"{tag.replace(' ', '_')}.npz"
    if path.exists():
        path.unlink()
    seen = []

    def on_chunk(state):
        seen.append(int(state.iters))
        if len(seen) == 2:
            raise Stop

    # the snapshot kind follows the solve's m (light from LIGHT_FROM_M rows)
    light_from = ck.LIGHT_FROM_M
    ck.LIGHT_FROM_M = A.shape[0] if light else A.shape[0] + 1
    try:
        torch.cuda.synchronize()
        hopper.reset_launches()
        t0 = time.perf_counter()
        try:
            ck.solve_with_checkpoints(A, b, c, path=path, options=opts, on_chunk=on_chunk, device=dev)
            check(False, f"{tag}: the solve ended before its second snapshot")
        except Stop:
            pass
        wall1 = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        state = ck.load_checkpoint(path, A=A, b=b, c=c, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        ck.save_checkpoint(SCRATCH / "resave.npz", state, light=light)
        t_save = time.perf_counter() - t0
        del state
        t0 = time.perf_counter()
        res = ck.solve_with_checkpoints(A, b, c, path=path, options=opts, device=dev)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    finally:
        ck.LIGHT_FROM_M = light_from
    counts = dict(hopper.launches)
    gap = relative_gap(res.z, want_z)
    check(res.status == SolveStatus.OPTIMAL, f"{tag}: resumed {res.status!r}")
    check(gap <= GAP_TOL, f"{tag}: z {res.z} vs the uninterrupted {want_z} (rel {gap:.3e})")
    print(
        f"{tag}: stopped after snapshots at pivots {seen} ({wall1:.2f} s), resumed to OPTIMAL z {res.z!r} "
        f"(uninterrupted {want_z!r}, rel {gap:.3e}) at pivot {res.iters} in {wall2:.2f} s; "
        f"{'light' if light else 'full'} snapshot {size} bytes, save {t_save:.4f} s, load {t_load:.4f} s "
        f"({'inverse rebuilt by an f64 LU on the card' if light else 'inverse read back'}); {kkt(res)}; "
        f"launches {counts}"
    )
    path.unlink()
    return counts


def phase_checkpoint(dev) -> dict:
    """Checkpoint / resume: 8192 x 16384 under steepest edge with light
    snapshots, and 2048 x 4096 under the default options with full ones."""
    from simplex_tpu_torch import SimplexOptions

    paths = {}
    A, b, c = instance(BENCH_M, BENCH_N)
    want = KEPT.get("steepest update_defer=0 full")
    if want is None:  # run alone (--only new)
        want = timed_solve(dev, BENCH_M, BENCH_N, SimplexOptions(pricing="steepest"))[0]
    opts = SimplexOptions(pricing="steepest", checkpoint_every=CHECKPOINT_EVERY)
    tag = f"checkpoint {BENCH_M}x{BENCH_N} steepest light"
    paths[tag] = checkpointed_run(dev, tag, A, b, c, opts, True, want.z,
                                  lambda r: kkt64(dev, BENCH_M, BENCH_N, r))
    A, b, c = instance(SMALL_M, SMALL_N)
    tag = f"checkpoint {SMALL_M}x{SMALL_N} default full"
    opts = SimplexOptions(checkpoint_every=CHECKPOINT_EVERY)
    paths[tag] = checkpointed_run(dev, tag, A, b, c, opts, False, highs(SMALL_M, SMALL_N).z,
                                  lambda r: "z against HiGHS")
    return paths


# exit codes of the JAX CLI where they are not 0: freevar_mi is unbounded;
# transport2x3 is balanced, so +0.1 on a supply row makes the re-solve
# infeasible; trace refuses a general-route input
CLI_RC = {("analyze", "freevar_mi.mps"): 2, ("analyze", "transport2x3.mps"): 2}


def phase_cli_more(dev) -> dict:
    """verify, analyze --reoptimize and trace on sample.txt and every MPS
    file, then solve --sparse on every MPS file against HiGHS."""
    import torch

    from simplex_tpu_torch import SolveStatus, cli
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy, solve_scipy_general

    counts = collections.Counter()
    data = ROOT / "tests" / "data"
    files = [data / "sample.txt"] + sorted(data.glob("*.mps"))
    for path in files:
        for sub in ("verify", "analyze", "trace"):
            argv = [sub, str(path), "--device", str(dev)]
            if sub == "analyze":
                argv += ["--reoptimize", "0=0.1"]
            want = CLI_RC.get((sub, path.name), 1 if (sub == "trace" and path.suffix == ".mps") else 0)
            torch.cuda.synchronize()
            hopper.reset_launches()
            out, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = cli.main(argv)
            wall = time.perf_counter() - t0
            counts.update(hopper.launches)
            lines = (out.getvalue() or err.getvalue()).strip().splitlines()
            print(f"cli {sub} {path.name}: rc {rc} (want {want}), {len(lines)} lines, wall {wall:.3f} s: "
                  f"'{lines[0] if lines else ''}' ... '{lines[-1] if lines else ''}'")
            check(rc == want, f"cli {sub} {path.name}: rc {rc}")
            if sub == "verify":
                check(any("OK" in ln or "status agreed" in ln for ln in lines), f"cli verify {path.name}")
    for path in sorted(data.glob("*.mps")):
        loaded, c0, maximize = cli._load(str(path), True)
        ref = solve_scipy_general(loaded) if hasattr(loaded, "row_types") else solve_scipy(*loaded[:3])
        torch.cuda.synchronize()
        hopper.reset_launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["solve", str(path), "--sparse", "--device", str(dev)])
        counts.update(hopper.launches)
        lines = out.getvalue().splitlines()
        if ref.status == SolveStatus.OPTIMAL:
            want = (ref.z if maximize else -ref.z) + c0
            gap = relative_gap(float(lines[0].split(":")[1]), want)
            print(f"cli solve --sparse {path.name}: rc {rc}, '{lines[0]}', {lines[-1]}; HiGHS {want!r} "
                  f"rel_gap {gap:.3e} (6 printed digits)")
            check(rc == 0 and gap <= GAP_TOL, f"solve --sparse {path.name}: rc {rc}, gap {gap:.3e}")
        else:
            print(f"cli solve --sparse {path.name}: rc {rc}, '{lines[0]}'; HiGHS {ref.status.name}")
            check(rc == 2 and lines[0] == ref.status.describe(), f"solve --sparse {path.name}: {lines[0]}")
    return {"cli verify / analyze / trace / solve --sparse": dict(counts)}


@functools.lru_cache(maxsize=None)
def sparse_instance(m: int, n: int):
    """``bench.py --mode sparse``'s instance (bench.py:632-668), rebuilt
    from its recipe: [A0 | I], A0's 128 x 128 tiles kept with probability
    0.1 (at least one) and uniform(0.2, 1.5) inside, ``default_rng(0)``.
    Returns (dense A, scipy CSC A, b, c)."""
    import numpy as np
    import scipy.sparse as sps

    rng = np.random.default_rng(0)
    k = n - m
    gr, gc = -(-m // SPARSE_TILE), -(-k // SPARSE_TILE)
    mask = rng.uniform(size=(gr, gc)) < SPARSE_DENSITY
    if not mask.any():
        mask[0, 0] = True
    A0 = rng.uniform(0.2, 1.5, (m, k)).astype(np.float32)
    keep = np.kron(mask, np.ones((SPARSE_TILE, SPARSE_TILE), bool))[:m, :k]
    A0[~keep] = 0.0
    A = np.hstack([A0, np.eye(m, dtype=np.float32)])
    b = (A0 @ rng.uniform(0.2, 0.8, k) + rng.uniform(0.1, 1.0, m)).astype(np.float32)
    c = np.concatenate([rng.uniform(0.5, 2, k), np.zeros(m)]).astype(np.float32)
    c[:k] *= (A0 != 0).any(axis=0)
    return A, sps.csc_matrix(A), b, c


def sparse_vs_dense(dev, paths, label, A, A_sp, b, c, opts, name) -> dict:
    """The same LP solved with A dense and with A sparse (scipy CSC) under
    ``opts``: status, z, pivots, seconds, host reads and device syncs a
    pivot of each; the sparse loop must stay within
    MAX_SPARSE_READS_PER_PIVOT; an f64 residual (window) or KKT check
    (OPTIMAL, primal infeasibility within MAX_PRIMAL_INFEAS) of both.
    Returns the two results."""
    import numpy as np

    from simplex_tpu_torch import SolveStatus
    from simplex_tpu_torch.oracle.reference import relative_gap

    runs = {}
    for tag, mat in (("dense", A), ("sparse", A_sp)):
        res, wall, counts, steps, reads, syncs = sync_counted_solve(dev, mat, b, c, opts)
        runs[tag] = res
        paths[f"{label} {name}, {tag} A"] = counts
        per = (reads["control"] + reads["branch"]) / max(1, res.iters)
        print(f"{label} {tag} A, {name}: {res.status.name} z {res.z!r} after {res.iters} pivots "
              f"({steps} steps) in {wall:.2f} s ({res.iters / wall:.1f} pivots/s, set-up and polish included); "
              f"host reads {reads} ({per:.4f} a pivot); device syncs in the pivot loop {syncs} "
              f"({syncs / max(1, res.iters):.4f} a pivot); launches {counts}")
        want = SolveStatus.MAX_ITER if opts.max_iter else SolveStatus.OPTIMAL
        check(res.status == want, f"{label} {tag} {name}: {res.status!r}")
        check(counts["ratio_eta"] == steps and counts["rank1_update"] == steps,
              f"{label} {tag} {name}: ratio_eta / rank1_update launches {counts} in {steps} steps")
        if tag == "sparse":
            check(counts["pricing_scan"] == 0, f"{label} sparse: pricing_scan {counts['pricing_scan']}")
            check(per <= MAX_SPARSE_READS_PER_PIVOT, f"{label} sparse: {per:.4f} host reads a pivot")
            check(syncs / max(1, res.iters) <= MAX_SPARSE_READS_PER_PIVOT,
                  f"{label} sparse: {syncs} device syncs in {res.iters} pivots")
    gap = relative_gap(runs["sparse"].z, runs["dense"].z)
    same = np.array_equal(runs["sparse"].basis, runs["dense"].basis)
    check(gap <= GAP_TOL, f"{label} {name}: sparse z {runs['sparse'].z} vs dense {runs['dense'].z}")
    if opts.max_iter:
        verdict = f"f64 residual of the sparse basis {residual64_of(dev, A, b, runs['sparse']):.3e}"
    else:
        verdict = "; ".join(f"{tag} answer " + kkt64_of(dev, A_sp, b, c, runs[tag], f"{label} {tag}",
                                                        MAX_PRIMAL_INFEAS)
                            for tag in ("sparse", "dense"))
    print(f"{label} {name}: sparse vs dense z rel {gap:.3e}, same basis {same}; {verdict}")
    return runs


def general_instance(name: str):
    """(GeneralLP, HiGHS result) of general C or B, from phase 6 when it
    ran."""
    from simplex_tpu_torch.oracle.generator import multiperiod_production_lp, transportation_lp
    from simplex_tpu_torch.oracle.reference import solve_scipy_general

    if name == "C":
        if "general C" in KEPT:
            return KEPT["general C"]
        lp = transportation_lp(*TRANSPORT_C, seed=0, balanced=False)
    else:
        if "general B" in KEPT:
            return KEPT["general B"][0], KEPT["general B HiGHS"]
        lp = multiperiod_production_lp(*GENERAL_SIZES["B"], seed=0)
    return lp, solve_scipy_general(lp)


def sync_counted_solve(dev, A, b, c, opts):
    """:func:`timed_solve_of` with the device syncs inside the pivot loop
    counted (``torch.cuda.set_sync_debug_mode``: one warning a sync).
    Returns its tuple plus the syncs."""
    import warnings

    import torch

    from simplex_tpu_torch.core import solver

    inner = solver._pivot_loop
    syncs = [0]

    def counted(*a, **k):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return inner(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                syncs[0] += sum("synchroniz" in str(w.message) for w in seen)

    solver._pivot_loop = counted
    try:
        out = timed_solve_of(dev, A, b, c, opts)
    finally:
        solver._pivot_loop = inner
    return (*out, syncs[0])


def pricing_pass_record(dev, A, A_sp, c) -> dict:
    """The sparse pricing pass (SpMV over A^T, then the masked argmin) and
    the dense one (``pricing_scan``) on the same instance, timed with CUDA
    events, beside their bounds; the same choice from both."""
    import torch

    from simplex_tpu_torch import sparse as sp
    from simplex_tpu_torch.kernels import hopper

    m, n = A.shape
    g = torch.Generator(device=dev).manual_seed(0)
    y = torch.randn(m, generator=g, device=dev) * 0.1
    c_d = torch.as_tensor(c, device=dev)
    basis = torch.arange(n - m, n, dtype=torch.int32, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    P = sp.from_scipy(A_sp, torch.float32, dev)
    A_d = torch.as_tensor(A, device=dev)
    p_s, e_s = hopper.choose_entering(y, P, c_d, 1e-5, no, basis)
    p_d, e_d = hopper.choose_entering(y, A_d, c_d, 1e-5, no, basis)
    check(int(p_s) == int(p_d), f"sparse pricing picks {int(p_s)}, dense {int(p_d)}")
    check(abs(float(e_s) - float(e_d)) <= PRICING_RTOL * max(1.0, abs(float(e_d))), "sparse pricing min_e")
    ms_s = time_ms(lambda: hopper.choose_entering(y, P, c_d, 1e-5, no, basis))
    ms_d = time_ms(lambda: hopper.choose_entering(y, A_d, c_d, 1e-5, no, basis))
    bytes_s = 8 * P.nnz + 4 * (n + 1) + 4 * (2 * m + n)  # values + indices, pointers, y, basis, c
    bytes_d = 4 * m * n + 4 * (2 * m + n)
    rec = {
        "nnz": P.nnz, "sparse_ms": ms_s, "sparse_bytes": bytes_s, "sparse_bound_ms": bound(bytes_s, 2 * P.nnz)["bound_ms"],
        "dense_ms": ms_d, "dense_bytes": bytes_d, "dense_bound_ms": bound(bytes_d, 2 * m * n)["bound_ms"],
    }
    print(f"pricing pass on the sparse bench instance {m}x{n} ({P.nnz} nonzeros, k_max {P.k_max}): "
          f"sparse (SpMV + masked argmin) {ms_s:.4f} ms between events, {bytes_s} bytes, bound "
          f"{rec['sparse_bound_ms']:.4f} ms; dense pricing_scan {ms_d:.4f} ms, {bytes_d} bytes, bound "
          f"{rec['dense_bound_ms']:.4f} ms; same choice {int(p_s)}")
    KEPT["pricing pass inputs"] = (y, P, A_d, c_d, no, basis)
    return rec


def phase_sparse(dev) -> dict:
    """Sparse A: the bench-sparse instance solved sparse and dense (the
    default options over the window at 8192 x 16384; steepest edge to
    OPTIMAL at 2048 x 4096); general C and B on scipy CSC against HiGHS; a
    sparse ranging + reoptimize."""
    import numpy as np
    import scipy.sparse as sps
    import torch

    from simplex_tpu_torch import SimplexOptions, SolveStatus, ranging, reoptimize
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy

    paths = {}
    t0 = time.perf_counter()
    A, A_sp, b, c = sparse_instance(BENCH_M, BENCH_N)
    print(f"sparse bench instance {BENCH_M}x{BENCH_N}: {A_sp.nnz} nonzeros ({A_sp.nnz / A.size:.4f} of A), "
          f"dense A {A.nbytes / 2**20:.0f} MiB, CSR values + indices {8 * A_sp.nnz / 2**20:.0f} MiB; "
          f"built on the host in {time.perf_counter() - t0:.2f} s")
    # the default options over bench.py --mode sparse's window (its own
    # run is a window: Dantzig's path on this instance is longer than 1.2 M
    # pivots); to OPTIMAL at 2048 x 4096 below
    sparse_vs_dense(dev, paths, f"bench-sparse {BENCH_M}x{BENCH_N}", A, A_sp, b, c,
                    SimplexOptions(max_iter=BENCH_WINDOW), f"default, max_iter={BENCH_WINDOW}")
    KEPT["pricing pass"] = pricing_pass_record(dev, A, A_sp, c)
    del A, A_sp
    torch.cuda.empty_cache()

    for name in ("C", "B"):
        lp, ref = general_instance(name)
        lp_s = lp._replace(A=sps.csc_matrix(np.asarray(lp.A)))
        tag = f"general {name} sparse A (scipy CSC) default presolve=False"
        res, probe, counts = general_run(dev, tag, lp_s, ref, SimplexOptions(), False)
        # B is bounded: its steps take the plain two-sided ratio test, not
        # ratio_eta; C runs both kernels
        for kname in ("rank1_update", "ratio_eta") if name == "C" else ("rank1_update",):
            check(counts[kname] > 0, f"{tag}: {kname} never launched ({counts})")
        paths[tag] = counts
        torch.cuda.empty_cache()

    # to OPTIMAL at the size HiGHS checks quickly, the same recipe
    A, A_sp, b, c = sparse_instance(SMALL_M, SMALL_N)
    t0 = time.perf_counter()
    ref = solve_scipy(A, b, c)
    print(f"bench-sparse recipe at {SMALL_M}x{SMALL_N}: {A_sp.nnz} nonzeros; HiGHS {ref.status.name} "
          f"z {ref.z!r} in {time.perf_counter() - t0:.2f} s")
    runs = sparse_vs_dense(dev, paths, f"bench-sparse {SMALL_M}x{SMALL_N}", A, A_sp, b, c,
                           SimplexOptions(pricing="steepest"), "steepest, to OPTIMAL")
    res = runs["sparse"]
    gap = relative_gap(res.z, ref.z)
    check(gap <= GAP_TOL, f"sparse {SMALL_M}x{SMALL_N}: z {res.z} HiGHS {ref.z}")
    print(f"bench-sparse {SMALL_M}x{SMALL_N} sparse answer against HiGHS: rel_gap {gap:.3e}")
    t0 = time.perf_counter()
    rng_s = ranging(A_sp, b, c, res.basis, device=dev)
    t_s = time.perf_counter() - t0
    rng_d = ranging(A, b, c, res.basis, device=dev)
    for f in ("b_lo", "b_hi", "c_lo", "c_hi", "y", "x"):
        g, w = getattr(rng_s, f).astype(np.float64), getattr(rng_d, f).astype(np.float64)
        big = ~np.isfinite(w) | (np.abs(w) > 1e6)
        check(np.array_equal(np.sign(g[big]), np.sign(w[big])) and np.allclose(g[~big], w[~big], rtol=1e-4, atol=1e-5),
              f"sparse ranging {f} differs from the dense ranges")
    room = np.where(np.isfinite(rng_s.b_hi) & (rng_s.b_hi <= np.abs(b)), rng_s.b_hi, -np.inf)
    i = int(np.argmax(room))
    b2 = np.array(b, np.float64)
    b2[i] += 1.5 * rng_s.b_hi[i]
    b2 = b2.astype(np.float32)
    torch.cuda.synchronize()
    hopper.reset_launches()
    t0 = time.perf_counter()
    warm = reoptimize(A_sp, b2, c, res, device=dev)
    torch.cuda.synchronize()
    t_w = time.perf_counter() - t0
    counts = dict(hopper.launches)
    ref2 = solve_scipy(A, b2, c)
    gap = relative_gap(warm.z, ref2.z)
    check(warm.status == SolveStatus.OPTIMAL and gap <= GAP_TOL, f"sparse reoptimize: {warm.status!r} gap {gap:.3e}")
    check(counts["rank1_update"] > 0, "sparse reoptimize: rank1_update never launched")
    paths[f"sparse reoptimize {SMALL_M}x{SMALL_N}"] = counts
    print(f"sparse {SMALL_M}x{SMALL_N} (bench-sparse recipe), from the steepest solve's basis: ranging "
          f"in {t_s:.2f} s (equal to the dense ranges); b_{i} + 1.5 x its range: reoptimize {warm.iters} pivots "
          f"in {t_w:.2f} s, z {warm.z!r} HiGHS {ref2.z!r} rel_gap {gap:.3e}; launches {counts}")
    return paths


def phase_sparse_profile(dev) -> None:
    """Device ops and time a pivot of the sparse default path on the
    bench-sparse instance (the same profiled stretch as the dense gate's),
    and the device time of one sparse and one dense pricing pass."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simplex_tpu_torch import SimplexOptions
    from simplex_tpu_torch.bench.profile_canonical import profile_loop
    from simplex_tpu_torch.bench.profile_general import device_summary
    from simplex_tpu_torch.kernels import hopper

    _, A_sp, b, c = sparse_instance(BENCH_M, BENCH_N)
    rec = profiled(lambda: profile_loop(A_sp, b, c, SimplexOptions(), dev, warm=32, window=128),
                   lambda r: r["device_us_per_pivot"] > 0, "sparse profile")
    print(
        f"sparse default path, {rec['pivots_traced']} profiled pivots: {rec['device_ops_per_pivot']:.2f} device "
        f"ops, {rec['device_us_per_pivot']:.1f} device us and {rec['wall_ms_per_pivot']:.3f} wall ms a pivot, "
        f"busy {rec['device_busy']:.1%}; launches a pivot {rec['launches_per_pivot']}; host reads a pivot "
        f"{rec['host_reads_per_pivot']}; largest items (us a pivot) {rec['top_us_per_pivot']}"
    )
    check(rec["device_us_per_pivot"] > 0, "sparse profile: no device time")
    y, P, A_d, c_d, no, basis = KEPT.pop("pricing pass inputs")
    k = 50
    out = {}

    def trace(Am):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(k):
                hopper.choose_entering(y, Am, c_d, 1e-5, no, basis)
            torch.cuda.synchronize()
        return device_summary(prof, True)

    for tag, Am in (("sparse", P), ("dense", A_d)):
        hopper.choose_entering(y, Am, c_d, 1e-5, no, basis)
        torch.cuda.synchronize()
        dev_us, n_ops, _ = profiled(lambda: trace(Am), lambda r: sum(r[0].values()) > 0, f"{tag} pricing pass")
        out[tag] = (sum(dev_us.values()) / k, n_ops / k, dict(dev_us.most_common(4)))
    rec = KEPT["pricing pass"]
    print(f"pricing pass device time on the bench-sparse instance: sparse {out['sparse'][0]:.1f} us a pass in "
          f"{out['sparse'][1]:.1f} device ops (bound {1e3 * rec['sparse_bound_ms']:.1f} us; largest "
          f"{out['sparse'][2]}); dense pricing_scan {out['dense'][0]:.1f} us in {out['dense'][1]:.1f} ops "
          f"(bound {1e3 * rec['dense_bound_ms']:.1f} us)")
    check(out["sparse"][0] > 0 and out["dense"][0] > 0, "pricing pass: no device time")




# --------------------------------------------------------------------------
# batched solves, warm re-solves of many scenarios, PDHG
# --------------------------------------------------------------------------

# bench.py --mode batch's options (bench.py:843-849)
BATCH_OPTS = dict(verify_terminal=False, polish=False, max_iter=1000)
BATCH_SAMPLES = 16  # instances held against HiGHS and the single solve
BATCH_FULL = 10240  # BASELINE.json configs[3]'s "10k small LPs", whole on one card
REOPT_SAMPLES = 8
# dual batch steps of bench-reopt under the profiler: past one re-inversion
# (refactor_every = 256), a third of the call's 1,051 steps
REOPT_TRACED = 320
REOPT_GAP = 1e-4  # tests/test_dual.py:276 holds the warm re-solves to this
PDHG_GAP = 1e-3  # a tol = 1e-4 first-order answer against HiGHS
PDHG_P = 32  # bench.py --mode pdhg --sparse: products per period
PDHG_T, PDHG_T_BIG = 64, 248  # periods: rows 2,112 and 8,184 (the bench's ~8,192)
PDHG_BUDGET = 20000  # iterations of the T = 248 runs


def batch_instances(Bn: int, exact_slack: bool = False):
    """bench.py --mode batch's recipe (bench.py:827-838): Bn copies of
    random_dense_lp(64, 160, seed=0) with 0.01 N(0, 1) added to A and
    0.01 |N(0, 1)| to b, from default_rng(0). The noise also lands on the
    slack identity, while the slack start takes B_inv = I: the instances
    bench.py times are solved for a slightly different basis matrix, in the
    JAX package as here (z about 2e-2 from HiGHS on the CPU in both).
    ``exact_slack`` keeps the identity exact, which makes the slack start
    a true basis and HiGHS a fair judge."""
    import numpy as np

    from simplex_tpu_torch.oracle.generator import random_dense_lp

    m, n = BATCH_M, BATCH_N
    rng = np.random.default_rng(0)
    A0, b0, c0 = random_dense_lp(m, n, seed=0, dtype=np.float32)
    As = np.empty((Bn, m, n), np.float32)
    bs = np.empty((Bn, m), np.float32)
    for i in range(Bn):
        As[i] = A0 + 0.01 * rng.standard_normal((m, n)).astype(np.float32)
        bs[i] = b0 + 0.01 * np.abs(rng.standard_normal(m)).astype(np.float32)
    if exact_slack:
        As[:, :, n - m:] = np.eye(m, dtype=np.float32)
    return As, bs, np.broadcast_to(c0, (Bn, n)).copy()


def highs_bounded(A, b, c, u):
    import numpy as np
    from scipy.optimize import linprog

    r = linprog(-np.asarray(c, np.float64), A_eq=np.asarray(A, np.float64),
                b_eq=np.asarray(b, np.float64),
                bounds=[(0, float(v) if np.isfinite(v) else None) for v in u], method="highs")
    return -r.fun if r.status == 0 else None


HIGHS_POOL_FROM = 1 << 20  # entries of A from which highs_all pays for its processes


def highs_all(problems) -> list:
    """HiGHS (``solve_scipy``) on each (A, b, c) of ``problems``: in spawned
    processes, one a core, once A holds HIGHS_POOL_FROM entries (a phase's
    sampled references one after another cost ~6 s each at 2048 x 4096; a
    process takes seconds to start), else here."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    from simplex_tpu_torch.oracle.reference import solve_scipy

    if len(problems) < 2 or problems[0][0].size < HIGHS_POOL_FROM:
        return [solve_scipy(*p) for p in problems]
    workers = min(len(problems), os.cpu_count() or 1)
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(solve_scipy, *zip(*problems)))


def batch_run(dev, tag, As, bs, cs, extra=None, u=None, highs=True, base=None, refs=None, gap=GAP_TOL) -> dict:
    """solve_batched once through its entry point with the counters set to
    0 just before; prints solves/s, statuses, pivots, batch steps, host
    reads (control and branch apart), the extra pricing passes by cause
    and launches a batch step; holds BATCH_SAMPLES instances against the
    port's single solve under the same options (the same slack start, so a
    witness on any input) and, when ``highs``, against HiGHS (``refs``: a
    dict of HiGHS objectives by instance, filled and reused), each within
    ``gap``. ``base`` replaces bench.py's options."""
    import numpy as np
    import torch

    from simplex_tpu_torch import SimplexOptions, solve, solve_batched
    from simplex_tpu_torch.batch import step as bstep
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle.reference import relative_gap

    opts = SimplexOptions(**{**(BATCH_OPTS if base is None else base), **(extra or {})})
    Bn = As.shape[0]
    torch.cuda.synchronize()
    hopper.reset_launches()
    bstep.reset_host_reads()
    t0 = time.perf_counter()
    res = solve_batched(As, bs, cs, u=u, options=opts, device=dev)
    dt = time.perf_counter() - t0
    counts = dict(hopper.launches)
    steps = bstep.steps["primal"]
    reads = dict(bstep.host_reads)
    branches = dict(bstep.branches)
    st = collections.Counter(res.statuses())
    per = {k: round(v / max(steps, 1), 4) for k, v in counts.items() if v}
    print(f"solve_batched {tag}: {Bn} LPs in {dt:.3f} s -> {Bn / dt:.1f} solves/s; statuses "
          f"{ {s.name: k for s, k in st.items()} }; pivots median {int(np.median(res.iters))} max "
          f"{int(res.iters.max())}; {steps} batch steps; host reads {reads} "
          f"({reads['control'] / max(steps, 1):.4f} control, {reads['branch'] / max(steps, 1):.4f} branch a "
          f"step); extra pricing passes {branches}; launches a step {per}")
    check(st.get(1, 0) == Bn, f"solve_batched {tag}: not every instance OPTIMAL: {st}")
    idx = [int(i) for i in np.linspace(0, Bn - 1, BATCH_SAMPLES).astype(int)]
    refs = {} if refs is None else refs
    if highs:
        todo = [i for i in idx if i not in refs]
        if u is None:
            refs.update(zip(todo, (r.z for r in highs_all([(As[i], bs[i], cs[i]) for i in todo]))))
        else:
            refs.update((i, highs_bounded(As[i], bs[i], cs[i], u)) for i in todo)
    worst_h = worst_s = 0.0
    for i in idx:
        single = solve(As[i], bs[i], cs[i], u=u, options=opts, device=dev)
        worst_s = max(worst_s, relative_gap(float(res.z[i]), single.z))
        if highs:
            worst_h = max(worst_h, relative_gap(float(res.z[i]), refs[i]))
    print(f"solve_batched {tag}: {BATCH_SAMPLES} sampled instances, worst rel gap vs the single solve "
          f"{worst_s:.3e}" + (f", vs HiGHS {worst_h:.3e}" if highs else " (HiGHS not held: see the recipe)"))
    check(worst_s <= gap and worst_h <= gap, f"solve_batched {tag}: gaps {worst_s}, {worst_h}")
    return {"counts": counts, "steps": steps, "seconds": dt, "reads": reads, "branches": branches,
            "pivots": int(res.iters.sum()), "max_pivots": int(res.iters.max())}


def phase_solve_batched(dev) -> dict:
    """solve_batched on bench.py --mode batch's recipe (its options: no
    verify rounds, no polish, max_iter 1000) at B = 4,096 (the JAX bench's)
    and 10,240, held against the single solve, with the one-at-a-time
    figure bench.py prints; then on the recipe with an exact slack
    identity, held against HiGHS and the single solve: fp32 A, the bf16
    shadow, update_defer = 4 and bounds u shared by the batch. Each eager unbounded batch step must launch the three
    batched kernels once each."""
    import numpy as np
    import torch

    from simplex_tpu_torch import SimplexOptions, solve_batched

    paths = {}
    for Bn in (BATCH_B, BATCH_FULL):
        As, bs, cs = batch_instances(Bn)
        if Bn == BATCH_B:
            # bench.py's warm-up call: the first launches of every op
            solve_batched(As, bs, cs, options=SimplexOptions(**BATCH_OPTS), device=dev)
        r = batch_run(dev, f"bench recipe B={Bn}", As, bs, cs, highs=False)
        c, k = r["counts"], r["steps"]
        check(c["batch_pricing"] == c["batch_tail"] == c["batch_rank1"] == k,
              f"batch B={Bn}: launches {c} over {k} batch steps")
        check(r["reads"]["control"] <= k + 1, f"batch B={Bn}: {r['reads']} reads over {k} steps")
        paths[f"solve_batched B={Bn}"] = c
        if Bn == BATCH_B:
            # bench.py's sequential figure: the same entry point, one LP a call
            ns = BATCH_SAMPLES
            opts = SimplexOptions(**BATCH_OPTS)
            solve_batched(As[:1], bs[:1], cs[:1], options=opts, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(ns):
                solve_batched(As[i:i + 1], bs[i:i + 1], cs[i:i + 1], options=opts, device=dev)
            dt1 = time.perf_counter() - t0
            print(f"solve_batched B=1, one at a time: {1e3 * dt1 / ns:.2f} ms a LP -> {ns / dt1:.1f} solves/s; "
                  f"batched over sequential {(Bn / r['seconds']) / (ns / dt1):.1f}x")
        del As, bs, cs
    As, bs, cs = batch_instances(BATCH_B, exact_slack=True)
    rng = np.random.default_rng(2)
    u = np.concatenate([rng.uniform(0.3, 1.0, BATCH_N - BATCH_M) * 4, np.full(BATCH_M, np.inf)]).astype(np.float32)
    for tag, extra, uu in (
        ("exact slack", {}, None),
        ("exact slack, bf16 shadow", {"pricing_dtype": "bfloat16"}, None),
        ("exact slack, update_defer=4", {"update_defer": 4}, None),
        ("exact slack, shared bounds u", {}, u),
    ):
        r = batch_run(dev, f"{tag} B={BATCH_B}", As, bs, cs, extra, uu)
        c, k = r["counts"], r["steps"]
        if not extra and uu is None:
            check(c["batch_pricing"] == c["batch_tail"] == c["batch_rank1"] == k, f"{tag}: launches {c}, {k} steps")
        elif uu is not None:
            check(c["batch_pricing"] == k and c["batch_tail"] == 0 and c["batch_rank1"] == k,
                  f"{tag}: launches {c}, {k} steps")
        elif "update_defer" in extra:
            check(c["batch_pricing"] == c["batch_tail"] == k and c["batch_rank1"] == 0, f"{tag}: launches {c}")
        else:
            check(c["batch_pricing"] >= k and c["batch_tail"] == c["batch_rank1"] == k, f"{tag}: launches {c}")
        paths[f"solve_batched {tag}"] = c
    return paths


def phase_reoptimize_batched(dev) -> dict:
    """reoptimize_batched on bench.py --mode reopt's recipe (bench.py:729-798):
    a cold solve of random_dense_lp(2048, 4096, seed=0) with refactor_every
    = 256, then 256 scenarios b (1 + 0.05 U(-1, 1)) from default_rng(1),
    dense A and A as scipy CSC; 8 sampled scenarios against HiGHS."""
    import numpy as np
    import scipy.sparse as sps
    import torch

    from simplex_tpu_torch import SimplexOptions, SolveStatus, reoptimize_batched, solve
    from simplex_tpu_torch.batch import step as bstep
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle.generator import random_dense_lp
    from simplex_tpu_torch.oracle.reference import relative_gap

    m, n, Bn = REOPT_M, REOPT_N, REOPT_B
    A, b, c = random_dense_lp(m, n, seed=0, dtype=np.float32)
    opts = SimplexOptions(refactor_every=256)
    t0 = time.perf_counter()
    cold = solve(A, b, c, options=opts, device=dev)
    print(f"reopt base {m}x{n}: cold {cold.status.name} {cold.iters} pivots in {time.perf_counter() - t0:.2f} s")
    check(int(cold.status) == 1, "reopt: the cold solve is not OPTIMAL")
    rng = np.random.default_rng(1)
    bs = (np.asarray(b, np.float64)[None, :] * (1 + 0.05 * rng.uniform(-1, 1, (Bn, m)))).astype(np.float32)
    idx = [int(i) for i in np.linspace(0, Bn - 1, REOPT_SAMPLES).astype(int)]
    refs = dict(zip(idx, highs_all([(A, bs[i], c) for i in idx])))
    KEPT["reopt"] = (A, c, cold, bs, refs)
    paths, first = {}, None
    for storage, A_in in (("dense", A), ("scipy CSC", sps.csc_matrix(A))):
        torch.cuda.synchronize()
        hopper.reset_launches()
        bstep.reset_host_reads()
        t0 = time.perf_counter()
        res = reoptimize_batched(A_in, bs, c, cold, options=opts, device=dev)
        dt = time.perf_counter() - t0
        counts, steps = dict(hopper.launches), dict(bstep.steps)
        st = collections.Counter(res.statuses())
        print(f"reoptimize_batched {storage}: {Bn} scenarios in {dt:.3f} s -> {Bn / dt:.1f} scenarios/s; "
              f"statuses { {s.name: k for s, k in st.items()} }; pivots (dual + clean-up) mean "
              f"{float(res.iters.mean()):.2f} max {int(res.iters.max())}; batch steps {steps}; "
              f"host reads {dict(bstep.host_reads)}; launches {counts}; feas_err max {float(res.feas_err.max()):.3e}")
        # the clean-up's primal steps price a dense A through the kernel (A
        # and c shared); no kernel reads a sparse A
        want_pricing = steps["primal"] if storage == "dense" else 0
        check(counts["batch_rank1"] >= steps["dual"] and counts["batch_tail"] == steps["primal"]
              and counts["batch_pricing"] == want_pricing, f"reopt {storage}: launches {counts}, steps {steps}")
        worst = 0.0
        for i, ref in refs.items():
            check(SolveStatus(int(res.status[i])) == ref.status, f"reopt {storage} scenario {i}: status")
            if ref.z is not None:
                worst = max(worst, relative_gap(float(res.z[i]), ref.z))
        print(f"reoptimize_batched {storage}: {REOPT_SAMPLES} sampled scenarios, worst rel gap vs HiGHS {worst:.3e}")
        check(worst <= REOPT_GAP, f"reopt {storage}: gap {worst}")
        if first is None:
            first = res
        else:
            check((res.status == first.status).all(), f"reopt {storage}: statuses differ from dense")
        paths[f"reoptimize_batched {storage}"] = counts
        del res
        torch.cuda.empty_cache()
    return paths


def seg_instances():
    """The segmented cell: SEG_B copies of random_dense_lp(512, 4096,
    seed=0) with 0.01 N(0, 1) on A0's non-slack columns and 0.01 |N(0, 1)|
    on b from default_rng(0) (bench.py --mode batch's noise, the slack
    identity kept exact so that the slack start is a true basis and HiGHS
    a fair judge), c shared."""
    import numpy as np

    from simplex_tpu_torch.oracle.generator import random_dense_lp

    m, n = SEG_M, SEG_N
    rng = np.random.default_rng(0)
    A0, b0, c0 = random_dense_lp(m, n, seed=0, dtype=np.float32)
    As = np.repeat(A0[None], SEG_B, 0)
    bs = np.empty((SEG_B, m), np.float32)
    for i in range(SEG_B):
        As[i, :, : n - m] += 0.01 * rng.standard_normal((m, n - m)).astype(np.float32)
        bs[i] = b0 + 0.01 * np.abs(rng.standard_normal(m)).astype(np.float32)
    return As, bs, np.broadcast_to(c0, (SEG_B, n)).copy()


def phase_batch_rules(dev) -> dict:
    """The batched pricing rules. bench.py --mode batch's own rule cell
    (bench.py:814-832: its recipe at B = 4,096, its options) under devex
    and under steepest edge: one control read a batch step, the stale
    flag inside it, no branch read, and one exact batch_pricing pass on a
    step where some active pick is stale (the tail and rank-1 once a
    step). Then segmented Dantzig (partial_pricing = 8, w = 512 =
    partial_min_segment) on SEG_B instances of 512 x 4096 with an exact
    slack identity, fp32 and on the bf16 shadow (the solver's default
    options, no polish on either side): one windowed launch a step plus
    one a fallback stage, one branch read a step and, on the shadow, one
    more a failed segment; sampled instances within 1e-5 of the single
    solve and of HiGHS."""
    import numpy as np

    paths = {}
    As, bs, cs = batch_instances(BATCH_B)
    for rule in ("devex", "steepest"):
        r = batch_run(dev, f"bench recipe {rule} B={BATCH_B}", As, bs, cs, {"pricing": rule}, highs=False)
        c, k, b = r["counts"], r["steps"], r["branches"]
        check(c["batch_tail"] == c["batch_rank1"] == k and c["batch_pricing"] == b["stale"],
              f"batch {rule}: launches {c} over {k} steps, passes {b}")
        check(r["reads"]["control"] <= k + 1 and r["reads"]["branch"] == 0,
              f"batch {rule}: {r['reads']} reads over {k} steps")
        paths[f"solve_batched {rule} B={BATCH_B}"] = c
    del As, bs, cs
    As, bs, cs = seg_instances()
    refs = KEPT.setdefault("seg refs", {})
    for tag, extra in (("fp32", {}), ("bf16 shadow", {"pricing_dtype": "bfloat16"})):
        r = batch_run(dev, f"segmented S={SEG_S} {tag} {SEG_B}x{SEG_M}x{SEG_N}", As, bs, cs,
                      dict(partial_pricing=SEG_S, **extra), base={"polish": False}, refs=refs)
        c, k, b = r["counts"], r["steps"], r["branches"]
        check(c["batch_pricing"] == k + b["segment"] + b["shadow"]
              and r["reads"]["branch"] == k + (b["segment"] if extra else 0),
              f"segmented {tag}: launches {c}, reads {r['reads']}, passes {b} over {k} steps")
        check(c["batch_tail"] == c["batch_rank1"] == k, f"segmented {tag}: launches {c} over {k} steps")
        got = dict(pivots=r["pivots"], max_pivots=r["max_pivots"], steps=k, segment=b["segment"],
                   shadow=b["shadow"])
        check(got == SEG_PATH[tag], f"segmented {tag}: {got}, the window's parent took {SEG_PATH[tag]}")
        paths[f"solve_batched segmented {tag}"] = c
    return paths


def phase_reopt_rules(dev) -> dict:
    """reoptimize_batched under the rules on bench.py --mode reopt's cell
    (phase 16's cold basis and scenarios): all 256 scenarios under steepest
    edge on dense A and on scipy CSC (the weights recomputed at the switch
    to the primal loop in chunks of scenarios), the first 64 (the 8 HiGHS
    samples among them) under devex and under partial_pricing = 8; sampled
    scenarios within 1e-4 of HiGHS."""
    import numpy as np
    import scipy.sparse as sps
    import torch

    from simplex_tpu_torch import SimplexOptions, SolveStatus, reoptimize_batched
    from simplex_tpu_torch.batch import step as bstep
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle.reference import relative_gap

    A, c, cold, bs, refs = KEPT["reopt"]
    samples = sorted(refs)
    rest = [j for j in range(bs.shape[0]) if j not in refs]
    sel64 = np.array(samples + rest[: 64 - len(samples)])
    paths = {}
    for tag, A_in, rule, sel in (
        ("steepest dense", A, dict(pricing="steepest"), None),
        ("steepest scipy CSC", sps.csc_matrix(A), dict(pricing="steepest"), None),
        ("devex dense", A, dict(pricing="devex"), sel64),
        (f"partial_pricing={SEG_S} dense", A, dict(partial_pricing=SEG_S), sel64),
    ):
        bsel = bs if sel is None else bs[sel]
        Bn = bsel.shape[0]
        opts = SimplexOptions(refactor_every=256, **rule)
        torch.cuda.synchronize()
        hopper.reset_launches()
        bstep.reset_host_reads()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = reoptimize_batched(A_in, bsel, c, cold, options=opts, device=dev)
        dt = time.perf_counter() - t0
        counts, steps, br = dict(hopper.launches), dict(bstep.steps), dict(bstep.branches)
        st = collections.Counter(res.statuses())
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"reoptimize_batched {tag}: {Bn} scenarios in {dt:.3f} s -> {Bn / dt:.1f} scenarios/s; statuses "
              f"{ {s.name: k for s, k in st.items()} }; pivots (dual + clean-up) median "
              f"{int(np.median(res.iters))} max {int(res.iters.max())}; batch steps {steps}; host reads "
              f"{dict(bstep.host_reads)}; extra pricing passes {br}; launches {counts}; feas_err max "
              f"{float(res.feas_err.max()):.3e}; peak device memory {peak:.2f} GiB")
        k = steps["primal"]
        if "CSC" in tag:
            want = 0
        elif "partial" in tag:
            want = k + br["segment"] + br["shadow"]
        else:
            want = br["stale"]
        check(counts["batch_pricing"] == want and counts["batch_tail"] == k and counts["batch_rank1"] >= steps["dual"],
              f"reopt {tag}: launches {counts}, steps {steps}, passes {br}")
        worst = 0.0
        where = {int(j): i for i, j in enumerate(range(Bn) if sel is None else sel)}
        for j, ref in refs.items():
            i = where[j]
            check(SolveStatus(int(res.status[i])) == ref.status, f"reopt {tag} scenario {j}: status")
            if ref.z is not None:
                worst = max(worst, relative_gap(float(res.z[i]), ref.z))
        print(f"reoptimize_batched {tag}: {len(refs)} sampled scenarios, worst rel gap vs HiGHS {worst:.3e}")
        check(worst <= REOPT_GAP, f"reopt {tag}: gap {worst}")
        paths[f"reoptimize_batched {tag}"] = counts
        del res
        torch.cuda.empty_cache()
    return paths


def multiperiod_eq(T: int):
    """bench.py --mode pdhg --sparse's instance (bench.py:567-625):
    multiperiod_production_lp(T, 32, seed=0) in box-bounded equality form,
    float32, with its general form for HiGHS."""
    import numpy as np

    from simplex_tpu_torch.io.canonical import to_equality_form
    from simplex_tpu_torch.oracle.generator import multiperiod_production_lp

    lp = multiperiod_production_lp(T, PDHG_P, seed=0)
    eq = to_equality_form(lp)
    A, b, c, u = (np.asarray(v, np.float32) for v in (eq.A, eq.b, eq.c, eq.u))
    return lp, eq, A, b, c, u


def pdhg_run(dev, tag, A, b, c, u=None, **kw):
    from simplex_tpu_torch import solve_pdhg

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_pdhg(A, b, c, u=u, device=dev, **kw)
    dt = time.perf_counter() - t0
    print(f"pdhg {tag}: {res.status.name} in {res.iters} iterations, {dt:.2f} s -> {res.iters / dt:.0f} it/s; "
          f"rp {res.primal_res:.2e} rd {res.dual_res:.2e} gap {res.gap:.2e}")
    return res, dt


def phase_pdhg(dev) -> dict:
    """PDHG: random_dense_lp(256, 640, seed=0) at tol 1e-4 and bench.py
    --mode pdhg --sparse's multiperiod instance at T = 64, both OPTIMAL and
    within PDHG_GAP of HiGHS; T = 248 (rows 8,184) dense and sparse under a
    PDHG_BUDGET-iteration budget, reported; crossover of the T = 64 sparse
    answer (OPTIMAL, 1e-6 from HiGHS); ``cli solve --algo pdhg
    --crossover`` on tests/data/sample.txt (z = 9)."""
    import numpy as np
    import scipy.sparse as sps
    import torch

    from simplex_tpu_torch import cli, crossover
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle.generator import random_dense_lp
    from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy, solve_scipy_general

    hopper.reset_launches()
    A, b, c = random_dense_lp(256, 640, seed=0, dtype=np.float32)
    res, _ = pdhg_run(dev, "dense 256x640 tol 1e-4", A, b, c, tol=1e-4)
    gap = relative_gap(res.z, solve_scipy(A, b, c).z)
    print(f"pdhg dense 256x640: rel gap vs HiGHS {gap:.3e}")
    check(int(res.status) == 1 and gap <= PDHG_GAP, f"pdhg 256x640: {res.status.name}, gap {gap}")
    lp, eq, A, b, c, u = multiperiod_eq(PDHG_T)
    ref = solve_scipy_general(lp).z
    print(f"multiperiod T={PDHG_T} P={PDHG_P}: {A.shape[0]}x{A.shape[1]} equality form, {np.count_nonzero(A)} nonzeros")
    res, _ = pdhg_run(dev, f"sparse T={PDHG_T}", sps.csr_matrix(A), b, c, u=u, tol=1e-4)
    gap = relative_gap(res.z + eq.z_const, ref)
    print(f"pdhg sparse T={PDHG_T}: rel gap vs HiGHS {gap:.3e}")
    check(int(res.status) == 1 and gap <= PDHG_GAP, f"pdhg sparse T={PDHG_T}: {res.status.name}, gap {gap}")
    t0 = time.perf_counter()
    vert = crossover(sps.csc_matrix(A), b, c, res, u=u, device=dev)
    vgap = relative_gap(vert.z + eq.z_const, ref)
    print(f"crossover T={PDHG_T}: {vert.status.name} in {vert.iters} pivots, {time.perf_counter() - t0:.2f} s, "
          f"rel gap vs HiGHS {vgap:.3e}, feas_err {vert.feas_err:.2e}")
    check(int(vert.status) == 1 and vgap <= 1e-6, f"crossover: {vert.status.name}, gap {vgap}")
    lp, eq, A, b, c, u = multiperiod_eq(PDHG_T_BIG)
    print(f"multiperiod T={PDHG_T_BIG}: {A.shape[0]}x{A.shape[1]}, {np.count_nonzero(A)} nonzeros, "
          f"budget {PDHG_BUDGET} iterations")
    for tag, A_in in (("sparse", sps.csr_matrix(A)), ("dense", A)):
        res, dt = pdhg_run(dev, f"{tag} T={PDHG_T_BIG}", A_in, b, c, u=u, tol=1e-4, max_iter=PDHG_BUDGET)
        check(np.isfinite(res.z) and res.iters > 0, f"pdhg {tag} T={PDHG_T_BIG}: no iterate")
        KEPT[f"pdhg {tag} T={PDHG_T_BIG}"] = (res, dt)
    del A
    torch.cuda.empty_cache()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["solve", str(ROOT / "tests" / "data" / "sample.txt"), "--algo", "pdhg",
                       "--crossover", "--device", str(dev)])
    lines = out.getvalue().splitlines()
    print(f"cli solve --algo pdhg --crossover sample.txt: rc {rc}, '{lines[0]}', {lines[-1]}")
    check(rc == 0 and lines[0] == "Optimum found: 9", f"cli pdhg: {lines[:2]}")
    return {"pdhg (and its crossovers)": dict(hopper.launches)}


# scenarios of the bench entry point's reopt run: bench.py's 4,096 at 8192 x
# 16384 fit no card, and each sampled scenario costs a HiGHS solve of ~6 s
# at 2048 x 4096
BENCH_REOPT_B = 2
# the default option set in the bench entry point's flags
DEFAULT_SET = ["--pricing-dtype", "float32", "--partial-pricing", "0", "--update-defer", "0",
               "--multi-price", "0"]
# the bench entry point's runs (simplex_tpu_torch.bench.run): the arguments
# and the metric each record must name; bench.py's widths, parity, pdhg and
# reopt at the sizes HiGHS and the time limit allow
BENCH_RUNS = {
    "single, flagship": ([], "pivots_per_sec_dense_8192x16384_fp32"),
    "single, default set": (DEFAULT_SET, "pivots_per_sec_dense_8192x16384_fp32"),
    "sparse": (["--mode", "sparse"], "sparse_simplex_pivots_per_sec_8192x16384_fp32"),
    "full, flagship": (["--mode", "full", "--no-oracle"], "seconds_to_optimal_dense_8192x16384_fp32"),
    "parity": (["--mode", "parity", "--m", "2048", "--n", "4096"], "oracle_rel_gap_dense_2048x4096_fp32"),
    "general": (["--mode", "general"], "seconds_to_optimal_general_1088rows_T64P16_fp32"),
    "batch": (["--mode", "batch"], "lp_solves_per_sec_batched_4096x64x160_fp32"),
    "pdhg": (["--mode", "pdhg", "--m", "256", "--n", "640"], "pdhg_seconds_to_kkt1e-4_dense_256x640_fp32"),
    "pdhg, sparse": (["--mode", "pdhg", "--sparse", "--m", "2112"],
                     "pdhg_seconds_to_kkt1e-4_sparse_2112x6208_fp32"),
    "reopt": (["--mode", "reopt", "--m", "2048", "--n", "4096", "--batch", str(BENCH_REOPT_B)],
              f"warm_rhs_scenarios_per_sec_2048x4096_batch{BENCH_REOPT_B}_fp32"),
}


def bench_gates(tag: str, rec: dict, err: str) -> None:
    """What each run's record and log must show: its status, its gap within
    the repo's gate, and its path's kernels launched in the timed window."""
    import re

    launches = rec["launches"]

    def logged(pattern):
        check(re.search(pattern, err, re.M) is not None, f"bench {tag}: no '{pattern}' in the log")

    if tag.startswith("single"):
        pivots = int(re.search(r"^(\d+) pivots in", err, re.M).group(1))
        check(pivots == BENCH_WINDOW, f"bench {tag}: {pivots} pivots")
        if tag == "single, default set":
            # the default path: each of its kernels once a pivot step
            for name in ("pricing_scan", "ratio_eta", "rank1_update"):
                check(launches[name] == pivots, f"bench {tag}: {name} {launches[name]} in {pivots} pivots")
        else:
            check(launches["ratio_eta"] >= pivots, f"bench {tag}: ratio_eta {launches['ratio_eta']}")
    elif tag in ("full, flagship", "parity", "general"):
        logged(r"^OPTIMAL z=")
        if tag == "parity":
            check(rec["value"] <= GAP_TOL, f"bench parity: gap {rec['value']}")
        if tag == "general":
            check(rec["rel_gap_vs_highs"] <= GAP_TOL, f"bench general: gap {rec['rel_gap_vs_highs']}")
        check(launches["pricing_scan" if tag == "general" else "ratio_eta"] > 0, f"bench {tag}: {launches}")
    elif tag == "sparse":
        check(rec["iters"] == {"sparse": BENCH_WINDOW, "dense": BENCH_WINDOW}, f"bench sparse: {rec['iters']}")
        check(launches["pricing_scan"] > 0 and launches["ratio_eta"] > 0, f"bench sparse: {launches}")
    elif tag == "batch":
        logged(r"\((\d+)/\1 optimal")
        check(all(launches[k] > 0 for k in ("batch_pricing", "batch_tail", "batch_rank1")),
              f"bench batch: {launches}")
    elif tag.startswith("pdhg"):
        logged(r"OPTIMAL iters=")
        check(rec["obj_rel_gap_vs_highs"] <= PDHG_GAP, f"bench {tag}: gap {rec['obj_rel_gap_vs_highs']}")
        check(not any(launches.values()), f"bench {tag}: PDHG runs no kernel, {launches}")
    elif tag == "reopt":
        logged(rf"\({BENCH_REOPT_B} OPTIMAL")
        check(rec["worst_sampled_rel_gap_vs_highs"] <= REOPT_GAP,
              f"bench reopt: gap {rec['worst_sampled_rel_gap_vs_highs']}")
        check(launches["batch_rank1"] > 0, f"bench reopt: {launches}")


def phase_bench(dev) -> dict:
    """The port's benchmark entry point, ``python -m
    simplex_tpu_torch.bench.run``, once per mode through ``run.main`` in
    this process (BENCH_RUNS), then ``cli bench`` once as a
    subprocess at 2048 x 4096. ``random_dense_lp(m, n, seed=0)`` and
    HiGHS's answer on 2048 x 4096 come from the caches of earlier phases.
    Each run prints exactly one JSON line on stdout, with the expected
    metric, ``impl`` and this card; each is gated by :func:`bench_gates`.
    Returns the launch counts of each whole run."""
    import re

    import numpy as np
    import torch

    from simplex_tpu_torch.bench import run
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle import generator, reference

    card = card_line()
    original, original_highs = generator.random_dense_lp, reference.solve_scipy

    def unpatched(fn, *args):
        # instance() and highs() import the originals when they run
        generator.random_dense_lp, reference.solve_scipy = original, original_highs
        try:
            return fn(*args)
        finally:
            generator.random_dense_lp, reference.solve_scipy = reused, highs_reused

    def reused(m, n, seed=0, dtype=np.float32, degenerate=False):
        if (seed, np.dtype(dtype), degenerate) != (0, np.float32, False):
            return original(m, n, seed, dtype, degenerate)
        return unpatched(instance, m, n)

    def highs_reused(A, b, c):
        # HiGHS on instance(2048, 4096) itself: the answer earlier phases have
        if np.shape(A) == (SMALL_M, SMALL_N) and all(
                x is y for x, y in zip((A, b, c), unpatched(instance, SMALL_M, SMALL_N))):
            return unpatched(highs, SMALL_M, SMALL_N)
        return original_highs(A, b, c)

    def record(tag, out, err, metric):
        lines = out.splitlines()
        check(len(lines) == 1, f"bench {tag}: {len(lines)} lines on stdout")
        rec = json.loads(lines[0])
        check(rec["metric"] == metric, f"bench {tag}: metric {rec['metric']}")
        check(rec["impl"] == "simplex_tpu_torch" and rec["card"] == card, f"bench {tag}: {rec['impl']}, {rec['card']}")
        tail = [ln for ln in err.splitlines() if re.search(r"pivots/s|OPTIMAL|solves/s|scenarios/s|rel_gap", ln)]
        print(f"bench {tag}: {' | '.join(tail)}")
        print(f"bench {tag} record: {lines[0]}")
        return rec

    paths = {}
    generator.random_dense_lp, reference.solve_scipy = reused, highs_reused
    try:
        for tag, (argv, metric) in BENCH_RUNS.items():
            out, err = io.StringIO(), io.StringIO()
            torch.cuda.synchronize()
            hopper.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = run.main(argv)
            wall = time.perf_counter() - t0
            paths[f"bench {tag}"] = dict(hopper.launches)
            check(rc == 0, f"bench {tag}: rc {rc}")
            rec = record(tag, out.getvalue(), err.getvalue(), metric)
            bench_gates(tag, rec, err.getvalue())
            print(f"bench {tag}: {wall:.1f} s in all")
            torch.cuda.empty_cache()
    finally:
        generator.random_dense_lp, reference.solve_scipy = original, original_highs
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "simplex_tpu_torch.cli", "bench", "--m", str(SMALL_M), "--n", str(SMALL_N)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    check(proc.returncode == 0, f"cli bench: rc {proc.returncode}: {proc.stderr[-2000:]}")
    record("cli bench", proc.stdout, proc.stderr, f"pivots_per_sec_dense_{SMALL_M}x{SMALL_N}_fp32")
    print(f"cli bench: {time.perf_counter() - t0:.1f} s in all (a new process)")
    return paths


def phase_batch_profile(dev) -> dict:
    """Device ops and device time a batch step from a torch.profiler trace
    of a whole solve_batched call (after the other profiles): bench.py
    --mode batch's recipe at B = 4,096 under Dantzig, devex and steepest
    edge, and the first SEG_TRACED steps of the segmented cell (fp32 and
    the bf16 shadow, where the window prices every step); then the device time a call of the
    redesigned batched kernels (``batch_kernel_device_us``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simplex_tpu_torch import SimplexOptions, solve_batched
    from simplex_tpu_torch.batch import step as bstep
    from simplex_tpu_torch.bench.profile_general import device_summary

    def traced(tag, As, bs, cs, opts):
        solve_batched(As, bs, cs, options=opts, device=dev)
        torch.cuda.synchronize()

        def once():
            bstep.reset_host_reads()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                solve_batched(As, bs, cs, options=opts, device=dev)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            by, ops, _ = device_summary(prof, True)
            return by, ops, wall

        by, ops, wall = profiled(once, lambda r: r[1] > 0 and sum(r[0].values()) > 0, f"batch profile {tag}")
        steps = max(bstep.steps["primal"], 1)
        total = sum(by.values())
        per = {k: v / steps for k, v in by.most_common(8)}
        print(f"batch profile {tag}: {steps} batch steps; {ops / steps:.2f} device ops and "
              f"{total / steps:.1f} device us a batch step, {1e3 * wall / steps:.3f} wall ms a step (traced), "
              f"busy {1e-3 * total / (1e3 * wall):.1%}; reads {dict(bstep.host_reads)}, extra passes "
              f"{dict(bstep.branches)}; largest (us a step): "
              + ", ".join(f"{k[:60]} {v:.1f}" for k, v in per.items()))
        check(ops > 0 and total > 0, f"batch profile {tag}: no device time")
        kern = {name: sum(v for k, v in by.items() if key in k) / steps
                for name, key in (("batch_pricing", "batch_pricing_"), ("batch_tail", "batch_tail_"),
                                  ("batch_rank1", "batch_rank1_kernel"))}
        return {"device_us_per_batch_step": total / steps, "device_ops_per_batch_step": ops / steps,
                "kernel_device_us": kern}

    As, bs, cs = batch_instances(BATCH_B)
    out = {rule: traced(f"B={BATCH_B} {rule}", As, bs, cs, SimplexOptions(**BATCH_OPTS, pricing=rule))
           for rule in ("dantzig", "devex", "steepest")}
    out["dantzig f64"] = traced(f"B={BATCH_B} dantzig f64", As, bs, cs,
                                SimplexOptions(**BATCH_OPTS, dtype=torch.float64))
    del As, bs, cs
    As, bs, cs = seg_instances()
    for tag, extra in (("fp32", {}), ("bf16 shadow", {"pricing_dtype": "bfloat16"})):
        out[f"segmented {tag}"] = traced(
            f"segmented S={SEG_S} {tag} {SEG_B}x{SEG_M}x{SEG_N}, first {SEG_TRACED} steps", As, bs, cs,
            SimplexOptions(polish=False, partial_pricing=SEG_S, max_iter=SEG_TRACED, **extra))
    return dict(out["dantzig"], rules=out, kernel_calls_device_us=batch_kernel_device_us(dev))


def phase_warm_and_pdhg_profile(dev) -> dict:
    """Where the time of bench-reopt and of a PDHG iteration goes: the
    first REOPT_TRACED dual batch steps of a ``reoptimize_batched`` call on
    bench-reopt (dense A, phase 16's cold basis and scenarios; the whole
    call's 1,051 steps traced took two minutes of the script), one
    re-inversion among them, and 640
    PDHG iterations (5 windows) of the 256 x 640 and T = 64 sparse
    instances, each traced by torch.profiler: device ops and device us a
    dual batch step or an iteration, and the largest items."""
    import numpy as np
    import scipy.sparse as sps
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simplex_tpu_torch import SimplexOptions, reoptimize_batched, solve_pdhg
    from simplex_tpu_torch.batch import step as bstep
    from simplex_tpu_torch.bench.profile_general import device_summary
    from simplex_tpu_torch.oracle.generator import random_dense_lp

    def traced(fn):
        def once():
            bstep.reset_host_reads()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = fn()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            by, ops, _ = device_summary(prof, True)
            return out, by, ops, wall

        return profiled(once, lambda r: sum(r[1].values()) > 0, "warm batched or PDHG profile")

    def report(tag, by, ops, wall, per, unit):
        total = sum(by.values())
        top = ", ".join(f"{k[:60]} {v / per:.1f}" for k, v in by.most_common(6))
        print(f"{tag}: {per} {unit}s; {ops / per:.2f} device ops and {total / per:.1f} device us a {unit}, "
              f"{1e3 * wall / per:.3f} wall ms a {unit} (traced); largest (us a {unit}): {top}")
        check(total > 0, f"{tag}: no device time")
        return {"device_us": total / per, "device_ops": ops / per, "wall_ms_traced": 1e3 * wall / per}

    out = {}
    A, c, cold, bs, _ = KEPT.pop("reopt")
    opts = SimplexOptions(refactor_every=256, max_iter=REOPT_TRACED)
    _, by, ops, wall = traced(lambda: reoptimize_batched(A, bs, c, cold, options=opts, device=dev))
    out["reopt"] = report("bench-reopt dual loop profile", by, ops, wall, bstep.steps["dual"], "dual batch step")
    del A
    torch.cuda.empty_cache()
    A, b, c = random_dense_lp(256, 640, seed=0, dtype=np.float32)
    iters = 640
    _, by, ops, wall = traced(lambda: solve_pdhg(A, b, c, tol=1e-12, max_iter=iters, device=dev))
    out["pdhg dense"] = report("pdhg 256x640 profile", by, ops, wall, iters, "iteration")
    _, _, A, b, c, u = multiperiod_eq(PDHG_T)
    _, by, ops, wall = traced(lambda: solve_pdhg(sps.csr_matrix(A), b, c, u=u, tol=1e-12, max_iter=iters,
                                                 device=dev))
    out["pdhg sparse"] = report(f"pdhg sparse T={PDHG_T} profile", by, ops, wall, iters, "iteration")
    return out


# ---- the column-sharded solve and the sharded batch ----------------------

SHARD_RANKS = 2  # gloo ranks of the one-card sharded run (NCCL refuses a card twice)
# the 2048 x 4096 option sets solved to OPTIMAL on the shards, against HiGHS
SHARDED_SETS = {
    "default": {},
    "flagship, multi-price off": {**FLAGSHIP, "multi_price": 0},
    "devex": {"pricing": "devex"},
}


def phase_shard_pricing(dev) -> dict:
    """``pricing_scan`` on a column shard: its own contiguous (m, n / R)
    copy, ``base_col`` at the shard's first column, global basis ids, rows
    chunked as the (m, n) pass chunks them. Against its plain version, and
    bit for bit against the pass over the whole matrix restricted to the
    shard (c = -inf on the other columns pushes them out of the min). Timed
    at the shard shapes of 2 and 4 ranks, with the shard's own chunking
    beside the whole matrix's."""
    import torch

    from simplex_tpu_torch.kernels import hopper

    g = torch.Generator(device=dev).manual_seed(3)
    m, n = BENCH_M, BENCH_N
    y = torch.randn(m, generator=g, device=dev)
    A = torch.randn(m, n, generator=g, device=dev)
    c = torch.randn(n, generator=g, device=dev)
    eps = 1e-5
    rec = {}
    for R in (2, 4):
        w = n // R
        lo = n - w  # the last shard: base_col != 0
        A_loc, c_loc = A[:, lo:].contiguous(), c[lo:].contiguous()
        e = y @ A - c
        basis = masked_basis(e, m, g, n, 0)  # global ids, some in this shard
        got = hopper.pricing_scan(y, A_loc, c_loc, eps, None, basis, lo, chunk_n=n)
        plain = hopper.pricing_scan_plain(y, A_loc, c_loc, eps, None, basis, lo)
        c_out = c.clone()
        c_out[:lo] = -float("inf")
        whole = hopper.pricing_scan(y, A, c_out, eps, None, basis, 0)
        torch.cuda.synchronize()
        min_k, p_k, neg_k = float(got[0]), int(got[1]), int(got[2])
        err = abs(min_k - float(plain[0]))
        check(err <= PRICING_RTOL * abs(float(plain[0])), f"shard pricing R={R}: min {min_k} vs plain {float(plain[0])}")
        check(p_k == int(plain[1]) and neg_k == int(plain[2]),
              f"shard pricing R={R}: p {p_k}, first {neg_k} vs plain {int(plain[1])}, {int(plain[2])}")
        check(got[0].view(torch.int32).item() == whole[0].view(torch.int32).item() and lo + p_k == int(whole[1]),
              f"shard pricing R={R}: {min_k!r} at {lo + p_k} vs the whole pass's {float(whole[0])!r} at {int(whole[1])}")
        own = hopper.pricing_scan(y, A_loc, c_loc, eps, None, basis, lo)
        torch.cuda.synchronize()
        same = own[0].view(torch.int32).item() == got[0].view(torch.int32).item()
        rec[f"{m}x{w}"] = {
            "max_abs_err": err,
            "ms": time_ms(lambda: hopper.pricing_scan(y, A_loc, c_loc, eps, None, basis, lo, chunk_n=n)),
            "own_chunks_ms": time_ms(lambda: hopper.pricing_scan(y, A_loc, c_loc, eps, None, basis, lo)),
            "plain_ms": time_ms(lambda: hopper.pricing_scan_plain(y, A_loc, c_loc, eps, None, basis, lo)),
            **bound(4.0 * (m * w + 2 * m + w), 2.0 * m * w),
            "chunks": hopper._pricing_chunks(m, n)[1], "own_chunks": hopper._pricing_chunks(m, w)[1],
        }
        r = rec[f"{m}x{w}"]
        print(f"pricing_scan on shard {R} of {R} ({m}x{w}, base_col {lo}): min_e {min_k!r} p {lo + p_k}, bit for bit "
              f"the whole pass's; its own chunking ({r['own_chunks']} chunks, not {r['chunks']}) "
              f"{'gives the same bits' if same else 'gives other bits'}; ms {r['ms']:.4f} "
              f"(own chunks {r['own_chunks_ms']:.4f}, plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f})")
        del A_loc
    return rec


def sharded_run(dev, mesh, A, b, c, opts) -> dict:
    """One ``solve_sharded`` through :func:`timed_solve_of`, with the
    collectives of the run and the seconds of its pivot loops."""
    from simplex_tpu_torch.dist import sharded

    with loop_timer() as loop:
        res, wall, counts, steps, reads = timed_solve_of(dev, A, b, c, opts, mesh=mesh)
    return dict(res=res, wall=wall, loop=loop[0], counts=counts, steps=steps, reads=reads,
                collectives=collections.Counter(sharded.collectives))


def sharded_rank(rank: int, world: int, port: int, dev_type: str, out) -> None:
    """One gloo rank of the one-card sharded run (a spawned process): the
    window, the 2048 x 4096 option sets, and bench-batch over the ranks."""
    import traceback

    import torch
    import torch.distributed as dist

    from simplex_tpu_torch import SimplexOptions, solve_batched
    from simplex_tpu_torch.dist.mesh import initialize_multihost, make_mesh
    from simplex_tpu_torch.kernels import hopper

    initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        mesh = make_mesh(device=dev_type)
        dev = torch.device("cuda", torch.cuda.current_device()) if dev_type == "cuda" else torch.device("cpu")
        rec = {"window": sharded_run(dev, mesh, *instance(BENCH_M, BENCH_N), SimplexOptions(max_iter=BENCH_WINDOW))}
        for tag, kw in SHARDED_SETS.items():
            rec[tag] = sharded_run(dev, mesh, *instance(SMALL_M, SMALL_N), SimplexOptions(**kw))
        As, bs, cs = batch_instances(BATCH_B)
        bmesh = make_mesh(("batch",), device=dev_type)
        torch.cuda.synchronize()
        hopper.reset_launches()
        t0 = time.perf_counter()
        res = solve_batched(As, bs, cs, options=SimplexOptions(**BATCH_OPTS), mesh=bmesh, device=dev)
        rec["batch"] = dict(res=res, wall=time.perf_counter() - t0, counts=dict(hopper.launches))
        out.put((rank, "ok", rec))
    except Exception:
        out.put((rank, "err", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def check_sharded_window(tag, run, single, single_reads) -> None:
    """A sharded window against the single solve's: the same pivots, basis
    and z; each kernel once a pivot step; two collectives a pivot step; the
    single solve's host reads."""
    res, k = run["res"], run["steps"]
    check(res.status == single.status and res.iters == single.iters,
          f"{tag}: {res.status!r} after {res.iters} vs {single.status!r} after {single.iters}")
    check((res.basis == single.basis).all() and res.z == single.z,
          f"{tag}: basis or z {res.z!r} differs from the single solve's {single.z!r}")
    for name in ("pricing_scan", "ratio_eta", "rank1_update"):
        check(run["counts"][name] == k, f"{tag}: {name} {run['counts'][name]} launches in {k} pivot steps")
    col = run["collectives"]
    check(col["choose_entering"] == col["gather_column_cost"] == k, f"{tag}: collectives {col} in {k} steps")
    check(run["reads"] == single_reads, f"{tag}: host reads {run['reads']} vs the single solve's {single_reads}")


def phase_sharded(dev) -> dict:
    """The column-sharded solve: at world size 1 over NCCL (a group of this
    process), then at world size 2 on this one card over gloo (two spawned
    ranks on cuda:0), on the bench instance's 512-pivot window, pivot for
    pivot against the single solve (phase 3's run); at world size 2 also
    the 2048 x 4096 instance to OPTIMAL under the default, the flagship
    without multiple pricing and devex against HiGHS, and bench-batch's
    4,096 x 64 x 160 through ``solve_batched(mesh=)`` against the call
    without a mesh."""
    import multiprocessing

    import numpy as np
    import torch.distributed as dist

    from simplex_tpu_torch import SimplexOptions, solve_batched
    from simplex_tpu_torch.dist.mesh import free_port, make_mesh
    from simplex_tpu_torch.oracle.reference import relative_gap

    single, s_wall, s_reads, s_loop = KEPT["window"]
    paths = {}
    mesh = make_mesh(device=dev.type)  # a group of one, NCCL on the card
    try:
        run = sharded_run(dev, mesh, *instance(BENCH_M, BENCH_N), SimplexOptions(max_iter=BENCH_WINDOW))
    finally:
        dist.destroy_process_group()
    check_sharded_window("sharded window, world 1 (nccl)", run, single, s_reads)
    k = run["steps"]
    print(f"solve_sharded world 1 (nccl), {BENCH_M}x{BENCH_N} window: {run['res'].iters} pivots in "
          f"{run['wall']:.3f} s ({run['res'].iters / run['wall']:.1f} pivots/s end to end, the pivot loop "
          f"alone {run['res'].iters / run['loop']:.1f}; the single solve {single.iters / s_wall:.1f} and "
          f"{single.iters / s_loop:.1f}); same basis and z {run['res'].z!r}; launches {run['counts']}; "
          f"collectives {run['collectives']} ({sum(run['collectives'].values()) / k:.3f} a pivot step); "
          f"host reads {run['reads']}")
    paths["sharded window, world 1"] = run["counts"]

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=sharded_rank, args=(r, SHARD_RANKS, port, dev.type, out)) for r in range(SHARD_RANKS)]
    for p in procs:
        p.start()
    recs, errors = {}, []
    try:
        for _ in procs:
            rank, kind, val = out.get(timeout=600)
            if kind == "ok":
                recs[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    check(not errors, "sharded ranks failed:\n" + "\n".join(errors))
    for rank in range(SHARD_RANKS):
        rec = recs[rank]
        check_sharded_window(f"sharded window, world {SHARD_RANKS} (gloo), rank {rank}", rec["window"], single, s_reads)
        paths[f"sharded window, world {SHARD_RANKS}, rank {rank}"] = rec["window"]["counts"]
    w = recs[0]["window"]
    print(f"solve_sharded world {SHARD_RANKS} (gloo, one card), window: {w['res'].iters} pivots in {w['wall']:.3f} s "
          f"({w['res'].iters / w['wall']:.1f} pivots/s end to end, the pivot loop alone "
          f"{w['res'].iters / w['loop']:.1f}); same basis and z on every rank; launches (rank 0) {w['counts']}; "
          f"collectives {w['collectives']}; host reads {w['reads']}")
    ref = highs(SMALL_M, SMALL_N)
    for tag in SHARDED_SETS:
        runs = [recs[r][tag] for r in range(SHARD_RANKS)]
        res = runs[0]["res"]
        for other in runs[1:]:
            check(other["res"].z == res.z and (other["res"].basis == res.basis).all(), f"sharded {tag}: ranks disagree")
        gap = relative_gap(res.z, ref.z)
        check(res.status.name == "OPTIMAL" and gap <= GAP_TOL, f"sharded {tag}: {res.status!r}, rel gap {gap:.3e}")
        k = runs[0]["steps"]
        print(f"solve_sharded world {SHARD_RANKS}, {SMALL_M}x{SMALL_N} {tag}: OPTIMAL z {res.z!r} HiGHS {ref.z!r} "
              f"rel_gap {gap:.3e} feas_err {res.feas_err:.3e} pivots {res.iters} in {runs[0]['wall']:.2f} s; "
              f"collectives {runs[0]['collectives']} ({sum(runs[0]['collectives'].values()) / k:.3f} a pivot step); "
              f"host reads {runs[0]['reads']}; launches {runs[0]['counts']}")
        for rank in range(SHARD_RANKS):
            paths[f"sharded {tag}, rank {rank}"] = recs[rank][tag]["counts"]
    As, bs, cs = batch_instances(BATCH_B)
    base = solve_batched(As, bs, cs, options=SimplexOptions(**BATCH_OPTS), device=dev)
    for rank in range(SHARD_RANKS):
        b = recs[rank]["batch"]
        check((b["res"].status == base.status).all(), f"sharded batch rank {rank}: statuses differ")
        check(np.allclose(b["res"].z, base.z, rtol=1e-6, atol=0), f"sharded batch rank {rank}: z differs beyond 1e-6")
        paths[f"solve_batched over {SHARD_RANKS} ranks, rank {rank}"] = b["counts"]
    b = recs[0]["batch"]
    print(f"solve_batched over {SHARD_RANKS} ranks (gloo, one card), B={BATCH_B}: {b['wall']:.3f} s "
          f"({BATCH_B / b['wall']:.1f} solves/s) against the call without a mesh; statuses equal, worst z rel diff "
          f"{float(np.max(np.abs(b['res'].z - base.z) / np.maximum(np.abs(base.z), 1e-30))):.3e}; launches rank 0 {b['counts']}")
    return paths


# ---- sharded PDHG and the 2-D solve -----------------------------------------

RESUME_M, RESUME_N = 512, 1024  # the 2-D chunk-resume's instance
# the 2 x 2 gloo ranks: the default over a window of TWO_D_WINDOW pivots at
# 2048 x 4096, held against the single solve's window (the same vertex;
# degenerate ties may seat a column in another row); devex and the
# flagship with multiple pricing to OPTIMAL against HiGHS. A devex window
# is no check: the shard's w = rho A_loc rounds apart from the whole
# matrix's product on the card, and near-ties of the pick then part.
TWO_D_WINDOW = 256
# z and x of one vertex polished in f64 by the row-sharded inverse against
# the single solve's whole inverse: the two agree to rounding
TWO_D_Z_TOL = 1e-9
TWO_D_WINDOW_SETS = {"default": {}}
# The flagship runs at 1024 x 2048 (2048 x 4096 until the float64 phases
# needed the time), its 8 segments of 256 columns kept active by
# partial_min_segment
TWO_D_FULL = {
    "devex": ((RESUME_M, RESUME_N), {"pricing": "devex"}),
    "flagship with multi-price": (
        (1024, 2048), {**FLAGSHIP, "refactor_every": FLAGSHIP_REFACTOR, "partial_min_segment": 256}),
}
# iterations of the two-rank sharded PDHG at 256 x 640 (held against
# solve_pdhg on the same budget): to OPTIMAL takes 56,320, 94 s over gloo
PDHG_RANKS_BUDGET = 4096


def phase_sharded_pdhg(dev) -> dict:
    """Column-sharded PDHG at world size 1 over NCCL (a group of this
    process) on bench.py --mode pdhg --sparse's multiperiod instance at
    T = 248, sparse and dense, under phase 17's budget and tolerance,
    against ``solve_pdhg`` on the same settings (status equal, z within
    PDHG_GAP; HiGHS too where it ends OPTIMAL), with iterations/s."""
    import numpy as np
    import scipy.sparse as sps
    import torch.distributed as dist

    from simplex_tpu_torch.dist import sharded
    from simplex_tpu_torch.dist.mesh import make_mesh
    from simplex_tpu_torch.fo import solve_pdhg_sharded
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy_general

    import torch

    lp, eq, A, b, c, u = multiperiod_eq(PDHG_T_BIG)
    mesh = make_mesh(device=dev.type)  # a group of one, NCCL on the card
    hopper.reset_launches()
    try:
        for tag, A_in in (("sparse", sps.csr_matrix(A)), ("dense", A)):
            if f"pdhg {tag} T={PDHG_T_BIG}" not in KEPT:  # run alone (--only sharded)
                KEPT[f"pdhg {tag} T={PDHG_T_BIG}"] = pdhg_run(
                    dev, f"{tag} T={PDHG_T_BIG}", A_in, b, c, u=u, tol=1e-4, max_iter=PDHG_BUDGET)
            single, s_dt = KEPT[f"pdhg {tag} T={PDHG_T_BIG}"]
            sharded.reset_collectives()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve_pdhg_sharded(A_in, b, c, mesh, u=u, tol=1e-4, max_iter=PDHG_BUDGET, device=dev)
            dt = time.perf_counter() - t0
            gap = relative_gap(res.z, single.z)
            col = {k: v for k, v in sharded.collectives.items() if v}
            print(f"solve_pdhg_sharded world 1 (nccl) {tag} T={PDHG_T_BIG}: {res.status.name} in {res.iters} "
                  f"iterations, {dt:.2f} s -> {res.iters / dt:.0f} it/s (solve_pdhg {single.status.name} in "
                  f"{single.iters}, {single.iters / s_dt:.0f} it/s); rp {res.primal_res:.2e} rd {res.dual_res:.2e} "
                  f"gap {res.gap:.2e}; z rel diff from solve_pdhg {gap:.3e}; collectives {col}")
            check(res.status == single.status and gap <= PDHG_GAP and np.isfinite(res.z),
                  f"sharded pdhg {tag}: {res.status.name} vs {single.status.name}, z rel diff {gap}")
            if int(res.status) == 1:
                hgap = relative_gap(res.z + eq.z_const, solve_scipy_general(lp).z)
                check(hgap <= PDHG_GAP, f"sharded pdhg {tag}: {hgap} from HiGHS")
    finally:
        dist.destroy_process_group()
    return {f"sharded pdhg world 1, T={PDHG_T_BIG}": dict(hopper.launches)}


def two_d_rank(rank: int, world: int, port: int, dev_type: str, out) -> None:
    """One of the four gloo ranks on this card (a spawned process): sharded
    PDHG over ranks 0-1 at 256 x 640 under ``PDHG_RANKS_BUDGET``, the 2-D
    solve on a 2 x 2 mesh (``TWO_D_WINDOW_SETS`` over ``TWO_D_WINDOW``
    pivots at 2048 x 4096, ``TWO_D_FULL`` to OPTIMAL), a
    chunk-resume of the 2-D checkpointed solve, and the dryrun's modes
    (``dist/dryrun.py`` ``run_modes``) over the four ranks; each run's
    result, wall, launches, collectives and pivot steps."""
    import tempfile
    import traceback

    import numpy as np
    import torch
    import torch.distributed as dist

    from simplex_tpu_torch import SimplexOptions
    from simplex_tpu_torch.dist import dryrun, sharded, sharded2d
    from simplex_tpu_torch.dist.card_check import count_calls
    from simplex_tpu_torch.dist.checkpoint2d import solve_sharded_2d_with_checkpoints
    from simplex_tpu_torch.dist.mesh import COLS_AXIS, ROWS_AXIS, initialize_multihost, make_mesh
    from simplex_tpu_torch.fo import solve_pdhg_sharded
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle.generator import random_dense_lp

    initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        pmesh = make_mesh((COLS_AXIS,), devices=[0, 1], device=dev_type)
        mesh = make_mesh((ROWS_AXIS, COLS_AXIS), shape=(2, 2), device=dev_type)
        dev = torch.device("cuda", torch.cuda.current_device()) if dev_type == "cuda" else torch.device("cpu")
        sync = torch.cuda.synchronize if dev_type == "cuda" else (lambda: None)
        rec = {}

        def timed(fn, barrier=True):
            hopper.reset_launches()
            sharded.reset_collectives()
            sync()
            if barrier:
                dist.barrier()
            with count_calls(sharded2d, "_step") as steps:
                t0 = time.perf_counter()
                res = fn()
                sync()
                wall = time.perf_counter() - t0
            return dict(res=res, wall=wall, counts=dict(hopper.launches), steps=steps[0],
                        collectives=dict(sharded.collectives))

        Ap, bp, cp = random_dense_lp(256, 640, seed=0, dtype=np.float32)
        if pmesh.get_coordinate() is not None:
            rec["pdhg"] = timed(lambda: solve_pdhg_sharded(Ap, bp, cp, pmesh, tol=1e-4, max_iter=PDHG_RANKS_BUDGET,
                                                           device=dev), barrier=False)
        runs = {tag: ((SMALL_M, SMALL_N), {**kw, "max_iter": TWO_D_WINDOW}) for tag, kw in TWO_D_WINDOW_SETS.items()}
        for tag, ((m, n), kw) in {**runs, **TWO_D_FULL}.items():
            A, b, c = instance(m, n)
            rec[tag] = timed(lambda: sharded2d.solve_sharded_2d(A, b, c, mesh, options=SimplexOptions(**kw),
                                                                  device=dev))
        A, b, c = instance(RESUME_M, RESUME_N)
        direct = sharded2d.solve_sharded_2d(A, b, c, mesh, device=dev)
        half = direct.iters // 2
        path = [tempfile.mkdtemp(prefix="chip_smoke_2d_") if rank == 0 else None]
        dist.broadcast_object_list(path, src=0)
        ck = f"{path[0]}/c2d.npz"
        opts = SimplexOptions(checkpoint_every=max(1, half // 2), max_iter=half)
        part = timed(lambda: solve_sharded_2d_with_checkpoints(A, b, c, mesh, path=ck, options=opts, device=dev))
        opts = SimplexOptions(checkpoint_every=max(1, half // 2))
        resumed = timed(lambda: solve_sharded_2d_with_checkpoints(A, b, c, mesh, path=ck, options=opts, device=dev))
        rec["resume"] = dict(direct=direct, part=part, resumed=resumed)
        t0 = time.perf_counter()
        rec["dryrun"] = (dryrun.run_modes(world, dev_type), time.perf_counter() - t0)
        dist.barrier()
        out.put((rank, "ok", rec))
    except Exception:
        out.put((rank, "err", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def phase_sharded_2d(dev) -> dict:
    """The 2-D solve: a 1 x 1 mesh at world size 1 over NCCL on the bench
    instance's 512-pivot window against the single solve (phase 3's run:
    the same pivots, basis and z), launching ``pricing_scan`` and
    ``rank1_update`` once a pivot step; then four gloo ranks on this one
    card (NCCL refuses a card twice): sharded PDHG over two of them at
    256 x 640 against ``solve_pdhg`` on the same budget (status equal, z
    within PDHG_GAP), the 2 x 2 mesh under ``TWO_D_WINDOW_SETS`` over
    ``TWO_D_WINDOW`` pivots at 2048 x 4096 against the single solve's
    window (the same pivots and basic columns, x and z within TWO_D_Z_TOL;
    each rank pricing its (2048, 1024) columns and updating its (1024,
    2048) rows of the inverse every step) and under ``TWO_D_FULL`` to
    OPTIMAL against HiGHS (GAP_TOL), and a
    chunk-resume at 512 x 1024 (stopped halfway in chunks of a quarter,
    resumed from the light snapshot to the direct solve's z); last the
    modes of ``python -m simplex_tpu_torch.dist.dryrun --ranks 4`` on the
    same four ranks, every distributed mode against HiGHS."""
    import multiprocessing

    import numpy as np
    import torch.distributed as dist

    from simplex_tpu_torch import SimplexOptions, solve
    from simplex_tpu_torch.dist import sharded, sharded2d
    from simplex_tpu_torch.dist.card_check import count_calls
    from simplex_tpu_torch.dist.mesh import COLS_AXIS, ROWS_AXIS, free_port, make_mesh
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle.reference import relative_gap

    import torch

    single, s_wall, s_reads, s_loop = KEPT["window"]
    paths = {}
    mesh = make_mesh((ROWS_AXIS, COLS_AXIS), shape=(1, 1), device=dev.type)
    A, b, c = instance(BENCH_M, BENCH_N)
    hopper.reset_launches()
    sharded.reset_collectives()
    try:
        with count_calls(sharded2d, "_step") as steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sharded2d.solve_sharded_2d(A, b, c, mesh, options=SimplexOptions(max_iter=BENCH_WINDOW), device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    counts, k = dict(hopper.launches), steps[0]
    same = bool((res.basis == single.basis).all() and res.z == single.z)
    print(f"solve_sharded_2d 1x1 (nccl), {BENCH_M}x{BENCH_N} window: {res.status.name} after {res.iters} pivots in "
          f"{wall:.3f} s ({res.iters / wall:.1f} pivots/s end to end; the single solve {single.iters / s_wall:.1f}); "
          f"{'the same basis and z as' if same else 'another basis or z than'} the single window "
          f"(z {res.z!r} vs {single.z!r}); launches {counts} in {k} steps; collectives "
          f"{ {n: v for n, v in sharded.collectives.items() if v} }")
    check(res.iters == single.iters == BENCH_WINDOW, f"2-D window: {res.iters} pivots")
    check(same, f"2-D window: basis or z {res.z!r} differs from the single window's {single.z!r}")
    for name in ("pricing_scan", "rank1_update"):
        check(counts[name] == k, f"2-D window: {name} {counts[name]} launches in {k} pivot steps")
    paths["2-D window, 1x1 (nccl)"] = counts
    A, b, c = instance(SMALL_M, SMALL_N)
    windows = {tag: solve(A, b, c, options=SimplexOptions(max_iter=TWO_D_WINDOW, **kw), device=dev)
               for tag, kw in TWO_D_WINDOW_SETS.items()}

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=two_d_rank, args=(r, 4, port, dev.type, out)) for r in range(4)]
    for p in procs:
        p.start()
    recs, errors = {}, []
    try:
        for _ in procs:
            rank, kind, val = out.get(timeout=600)
            if kind == "ok":
                recs[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    check(not errors, "2-D ranks failed:\n" + "\n".join(errors))
    from simplex_tpu_torch.oracle.generator import random_dense_lp

    Ap, bp, cp = random_dense_lp(256, 640, seed=0, dtype=np.float32)
    p0, p1 = recs[0]["pdhg"], recs[1]["pdhg"]
    one, _ = pdhg_run(dev, "dense 256x640, the two ranks' budget", Ap, bp, cp, tol=1e-4, max_iter=PDHG_RANKS_BUDGET)
    gap = relative_gap(p0["res"].z, one.z)
    print(f"solve_pdhg_sharded over 2 gloo ranks, 256x640: {p0['res'].status.name} in {p0['res'].iters} iterations, "
          f"{p0['wall']:.2f} s ({p0['res'].iters / p0['wall']:.0f} it/s); z rel diff from solve_pdhg on the same "
          f"budget {gap:.3e}; rp {p0['res'].primal_res:.2e}; collectives {p0['collectives']}")
    check(p0["res"].status == one.status and p0["res"].iters == one.iters and gap <= PDHG_GAP
          and p1["res"].z == p0["res"].z, f"sharded pdhg 2 ranks: {p0['res'].status.name}, z rel diff {gap}")
    for tag in [*TWO_D_WINDOW_SETS, *TWO_D_FULL]:
        runs = [recs[r][tag] for r in range(4)]
        r0 = runs[0]["res"]
        for other in runs[1:]:
            check(other["res"].z == r0.z and (other["res"].basis == r0.basis).all(), f"2-D {tag}: ranks disagree")
        k = runs[0]["steps"]
        if tag in windows:
            one = windows[tag]
            # the vertex: the same set of basic columns, x and z; and each
            # result's x_b in its own basis order
            same_set = bool(np.array_equal(np.sort(r0.basis), np.sort(one.basis)))
            moved = int((r0.basis != one.basis).sum())
            zdiff = relative_gap(r0.z, one.z)
            xdiff = float(np.abs(r0.x - one.x).max())
            ordered = all(np.allclose(r.x[r.basis], r.x_b, rtol=1e-6, atol=1e-9) for r in (r0, one))
            if moved:
                rows = np.flatnonzero(r0.basis != one.basis)[:8]
                print(f"2-D {tag} window, rows whose basic column differs (row, 2-D, single): "
                      f"{[(int(i), int(r0.basis[i]), int(one.basis[i])) for i in rows]}")
            check(r0.status == one.status and r0.iters == one.iters == TWO_D_WINDOW and same_set and ordered
                  and zdiff <= TWO_D_Z_TOL and xdiff <= TWO_D_Z_TOL * max(1.0, float(np.abs(one.x).max())),
                  f"2-D {tag} window: {r0.status!r} after {r0.iters}, z {r0.z!r} vs the single solve's "
                  f"{one.status!r} after {one.iters}, z {one.z!r} (rel diff {zdiff:.3e}); the same basic "
                  f"columns: {same_set} ({moved} rows hold another); x differs by {xdiff:.3e}; x_b in basis "
                  f"order: {ordered}")
            verdict = (f"{r0.status.name} after {r0.iters} pivots, the single window's basic columns ({moved} of "
                       f"{len(one.basis)} rows in another order), x within {xdiff:.3e}; z {r0.z!r} vs {one.z!r} "
                       f"(rel diff {zdiff:.3e})")
        else:
            ref = highs(*TWO_D_FULL[tag][0])
            gap = relative_gap(r0.z, ref.z)
            check(r0.status.name == "OPTIMAL" and gap <= GAP_TOL, f"2-D {tag}: {r0.status!r}, rel gap {gap:.3e}")
            verdict = (f"OPTIMAL z {r0.z!r} HiGHS {ref.z!r} rel_gap {gap:.3e} feas_err {r0.feas_err:.3e}; "
                       f"{r0.iters} pivots")
        m, n = TWO_D_FULL[tag][0] if tag in TWO_D_FULL else (SMALL_M, SMALL_N)
        print(f"solve_sharded_2d 2x2 (4 gloo ranks, one card), {m}x{n} {tag}: {verdict} in "
              f"{runs[0]['wall']:.2f} s; collectives {runs[0]['collectives']} "
              f"({sum(runs[0]['collectives'].values()) / k:.3f} a pivot step); launches rank 0 {runs[0]['counts']}")
        for rank in range(4):
            paths[f"2-D 2x2 {tag}, rank {rank}"] = runs[rank]["counts"]
            if tag == "default":
                # each rank prices its columns and updates its rows every step
                c_r, k_r = runs[rank]["counts"], runs[rank]["steps"]
                check(c_r["pricing_scan"] == c_r["rank1_update"] == k_r,
                      f"2-D {tag} rank {rank}: launches {c_r} in {k_r} pivot steps")
    rs = recs[0]["resume"]
    direct, part, resumed = rs["direct"], rs["part"]["res"], rs["resumed"]["res"]
    print(f"solve_sharded_2d_with_checkpoints 2x2, {RESUME_M}x{RESUME_N}: stopped {part.status.name} after "
          f"{part.iters} pivots, resumed {resumed.status.name} after {resumed.iters} (direct {direct.iters}); z "
          f"{resumed.z!r} vs the direct {direct.z!r}")
    check(part.status.name == "MAX_ITER" and resumed.status.name == "OPTIMAL" and resumed.iters > part.iters
          and relative_gap(resumed.z, direct.z) <= GAP_TOL, "2-D chunk-resume")
    line, secs = recs[0]["dryrun"]
    print(f"dryrun modes over 4 gloo ranks, {secs:.1f} s: {line}")
    check(all(recs[r]["dryrun"][0] == line for r in range(4)), "dryrun: ranks disagree")
    return paths


# --------------------------------------------------------------------------
# float64 through the single-card kernels
# --------------------------------------------------------------------------

# float64 tolerances, each with its reason
F64_PRICING_RTOL = 1e-12  # float64 sums of up to 9000 terms taken in another order
F64_TAIL_DEFER_RTOL = 1e-12  # the deferred row: fma in pair order against a matrix product
F64_RANK1_ATOL = 1e-12  # addr_ may fuse the multiply-add; the kernel rounds each (exact vs B + outer)
F64_GAP_TOL = 1e-9  # a float64 solve against HiGHS (the JAX suite's float64 gate, tests/test_corpus.py)
F64_CORPUS_GAP = 1e-6  # tests/test_corpus.py's gate
F64_TAIL_M = (17, 1024, 1025, BENCH_M, 9000)
F64_TRACE_PIVOTS = 64
F64_TAIL_OPTS = dict(TAIL_OPTS, eps=1e-9)  # the float64 default eps


def f64_options(**kw):
    import torch

    from simplex_tpu_torch import SimplexOptions

    return SimplexOptions(dtype=torch.float64, **kw)


def f64_check_scan(tag, y, Av, cv, eps) -> float:
    """The three-output scan in float64 against its plain version: every
    pick equal, min_e within F64_PRICING_RTOL. Returns |min_e error|."""
    import torch

    from simplex_tpu_torch.kernels import hopper

    min_k, p_k, neg_k = hopper.pricing_scan(y, Av, cv, eps)
    min_p, p_p, neg_p = hopper.pricing_scan_plain(y, Av, cv, eps)
    torch.cuda.synchronize()
    check(min_k.dtype == torch.float64, f"{tag}: min_e {min_k.dtype}")
    err = abs(float(min_k) - float(min_p))
    check(err <= F64_PRICING_RTOL * abs(float(min_p)), f"{tag}: min {float(min_k)!r} vs {float(min_p)!r}")
    check((int(p_k), int(neg_k)) == (int(p_p), int(neg_p)),
          f"{tag}: picks {int(p_k)}, {int(neg_k)} vs plain {int(p_p)}, {int(neg_p)}")
    print(f"{tag}: min_e {float(min_k)!r} (plain {float(min_p)!r}) p {int(p_k)} first below {int(neg_k)} ok")
    return err


def f64_check_choose(tag, dev, y, Av, cv, basis, lo, eps, at_upper=None) -> float:
    """The one-call form in float64 (mask, choice and offset in the kernel;
    signed under ``at_upper``) against its plain version, Bland off and
    on: the same column, min within F64_PRICING_RTOL, never a basic
    column where it improves. Returns the worst |min| error."""
    import torch

    from simplex_tpu_torch.kernels import hopper, ops

    worst = 0.0
    pen = ops.add_basic_penalty(torch.zeros_like(cv), basis, lo)
    for bland in (False, True):
        flag = torch.tensor(bland, device=dev)
        if at_upper is None:
            p_k, min_k = hopper.choose_entering(y, Av, cv, eps, flag, basis, lo)
            p_p, min_p = hopper.choose_entering_plain(y, Av, cv, eps, flag, basis, lo)
        else:
            args = (y, Av, cv, at_upper, basis, lo, eps, flag)
            p_k, min_k = hopper.choose_entering_bounded(*args)
            p_p, min_p = ops.choose_entering_bounded(*args)
        torch.cuda.synchronize()
        name = f"{tag} bland={bland}"
        p_k, p_p, min_k, min_p = int(p_k), int(p_p), float(min_k), float(min_p)
        err = abs(min_k - min_p)
        check(err <= F64_PRICING_RTOL * abs(min_p), f"{name}: min {min_k!r} vs {min_p!r}")
        check(p_k == p_p, f"{name}: p {p_k} vs plain {p_p}")
        if min_k < -eps:
            check(float(pen[p_k - lo]) == 0.0, f"{name}: picked basic column {p_k}")
        worst = max(worst, err)
        print(f"{name}: p {p_k} min {min_k!r} ok")
    return worst


def phase_f64_pricing(dev) -> dict:
    """``pricing_scan`` in float64 against its plain version: the bench's
    8192 x 16384 (16-byte loads), odd shapes (element loads; more row
    chunks than pass 2's float64 tile; one row chunk), an exact tie, the
    strided segment view (aligned and not), the bf16 shadow with float64
    y and c (full and a segment), the one-call form with the basic-column
    mask and the signed mode at the bounded route's shapes; timed beside
    its plain version, ``torch.mv(A.T, y)`` (the product alone) and its
    bound."""
    import torch

    from simplex_tpu_torch.kernels import hopper, ops

    g = torch.Generator(device=dev).manual_seed(10)
    eps = 1e-9
    rec = {}
    worst = 0.0
    for m, n in ((BENCH_M, BENCH_N), (BENCH_M - 1, BENCH_N - 1), (9000, 1001), (24, 4099)):
        y = torch.randn(m, generator=g, device=dev, dtype=torch.float64)
        A = torch.randn(m, n, generator=g, device=dev, dtype=torch.float64)
        c = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
        worst = max(worst, f64_check_scan(f"pricing_scan f64 {m}x{n}", y, A, c, eps))
        c_tie = torch.zeros(n, device=dev, dtype=torch.float64)
        c_tie[40] = c_tie[n - 100] = 5.0
        _, p_tie, neg_tie = hopper.pricing_scan(torch.zeros_like(y), A, c_tie, eps)
        check(int(p_tie) == 40 and int(neg_tie) == 40, f"pricing f64 tie: {int(p_tie)}, {int(neg_tie)}")
        e = y @ A - c
        n_total, lo = (n, 0) if n >= m else (2 * m, m // 2)
        basis = masked_basis(e, m, g, n_total, lo)
        worst = max(worst, f64_check_choose(f"choose_entering f64 {m}x{n}", dev, y, A, c, basis, lo, eps))
        if (m, n) == (BENCH_M, BENCH_N):
            no = torch.tensor(False, device=dev)
            w = n // FLAGSHIP["partial_pricing"]
            views = {"segment": (3 * w, A[:, 3 * w : 4 * w]), "segment, unaligned": (1, A[:, 1 : 1 + w])}
            for tag, (v0, Av) in views.items():
                cv = c[v0 : v0 + w]
                worst = max(worst, f64_check_scan(f"pricing_scan f64 {tag} {tuple(Av.shape)}", y, Av, cv, eps))
                worst = max(worst, f64_check_choose(f"choose_entering f64 {tag}", dev, y, Av, cv, basis, v0, eps))
            rec = {
                "ms": time_ms(lambda: hopper.choose_entering(y, A, c, eps, no, basis)),
                "plain_ms": time_ms(lambda: ops.choose_entering(y, A, c, eps, no, basis)),
                "scan_ms": time_ms(lambda: hopper.pricing_scan(y, A, c, eps)),
                # the product alone (cuBLAS DGEMV): the pass without its choice
                "library_ms": time_ms(lambda: torch.mv(A.T, y)),
                **bound(8.0 * (m * n + 2 * m + n) + 4 * m + 24, 2.0 * m * n, PEAK_FP64_S),
            }
            print(f"pricing_scan f64 {m}x{n}, ms: one-call {rec['ms']:.4f} (plain {rec['plain_ms']:.4f}), "
                  f"scan {rec['scan_ms']:.4f}, torch.mv(A.T, y) {rec['library_ms']:.4f}, "
                  f"bound {rec['bound_ms']:.4f}")
            # the bf16 shadow with float64 y and c: the sums in float64
            Ab = A.to(torch.bfloat16)
            del A
            shadow = {"bf16": (0, Ab, c), "bf16 segment": (3 * w, Ab[:, 3 * w : 4 * w], c[3 * w : 4 * w])}
            for tag, (v0, Av, cv) in shadow.items():
                worst = max(worst, f64_check_scan(f"pricing_scan f64 {tag} {tuple(Av.shape)}", y, Av, cv, eps))
                worst = max(worst, f64_check_choose(f"choose_entering f64 {tag}", dev, y, Av, cv, basis, v0, eps))
            rec["bf16"] = {
                "ms": time_ms(lambda: hopper.choose_entering(y, Ab, c, eps, no, basis)),
                "plain_ms": time_ms(lambda: ops.choose_entering(y, Ab, c, eps, no, basis)),
                **bound(2.0 * m * n + 8.0 * (2 * m + n) + 4 * m + 24, 2.0 * m * n, PEAK_FP64_S),
            }
            seg = Ab[:, 3 * w : 4 * w]
            rec["bf16_segment"] = {
                "ms": time_ms(lambda: hopper.choose_entering(y, seg, c[3 * w : 4 * w], eps, no, basis, 3 * w), 100),
                "plain_ms": time_ms(lambda: ops.choose_entering(y, seg, c[3 * w : 4 * w], eps, no, basis, 3 * w), 100),
                **bound(2.0 * m * w + 8.0 * (2 * m + w) + 4 * m + 24, 2.0 * m * w, PEAK_FP64_S),
            }
            print(f"pricing_scan f64 y / c on the bf16 shadow, ms: full {rec['bf16']['ms']:.4f} "
                  f"(plain {rec['bf16']['plain_ms']:.4f}, bound {rec['bf16']['bound_ms']:.4f}); segment "
                  f"{rec['bf16_segment']['ms']:.4f} (plain {rec['bf16_segment']['plain_ms']:.4f}, bound "
                  f"{rec['bf16_segment']['bound_ms']:.4f})")
            del Ab, seg
        else:
            del A
    # the signed mode (the bounded rule) at the bounded route's shapes
    for m, n in (ROUTE_A, ROUTE_B):
        w = n // GENERAL_BENCH["partial_pricing"]
        y = torch.randn(m, generator=g, device=dev, dtype=torch.float64)
        A = torch.randn(m, n, generator=g, device=dev, dtype=torch.float64)
        Ab = A.to(torch.bfloat16)
        c = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
        at_up = torch.rand(n, generator=g, device=dev) < 0.4
        basis = torch.randperm(n, generator=g, device=dev)[:m].to(torch.int32)
        for tag, Av, v0, wv in (("f64", A, 0, n), ("bf16", Ab, 0, n), ("bf16 segment", Ab[:, 3 * w : 4 * w], 3 * w, w)):
            worst = max(worst, f64_check_choose(
                f"bounded pricing f64 y / c, {tag} A {m}x{wv} (base {v0})", dev, y, Av, c[v0 : v0 + wv],
                basis, v0, eps, at_up[v0 : v0 + wv]))
        if (m, n) == ROUTE_B:
            no = torch.tensor(False, device=dev)
            args = (y, A, c, at_up, basis, 0, eps, no)
            rec["signed"] = {
                "shape": f"{m}x{n}",
                "ms": time_ms(lambda: hopper.choose_entering_bounded(*args)),
                "plain_ms": time_ms(lambda: ops.choose_entering_bounded(*args)),
                **bound(8.0 * (m * n + 2 * m + n) + n + 4 * m + 24, 3.0 * m * n, PEAK_FP64_S),
            }
            print(f"bounded pricing f64 {m}x{n}, ms: {rec['signed']['ms']:.4f} (plain "
                  f"{rec['signed']['plain_ms']:.4f}), bound {rec['signed']['bound_ms']:.4f}")
        del A, Ab
    rec["max_abs_err"] = worst
    return rec


def tail_inputs64(dev, g, m: int) -> dict:
    """:func:`tail_inputs` in float64 (the same draws, widened)."""
    return {k: v.double() if v.is_floating_point() else v for k, v in tail_inputs(dev, g, m).items()}


def phase_f64_ratio(dev) -> tuple:
    """The ratio kernels in float64 against their plain versions, bit for
    bit: ``ratio_eta`` with its tail off, ``ratio_argmin``, and
    ``pivot_tail`` eager (every leaf bitwise) and deferred (row q and y
    within F64_TAIL_DEFER_RTOL), with the steps that must change nothing;
    at one block, two, eight and beyond 8 x 1024 rows. Returns the records
    of ``ratio_eta`` and ``ratio_argmin``."""
    import torch

    from simplex_tpu_torch.kernels import hopper

    g = torch.Generator(device=dev).manual_seed(11)
    rec, rec_arg = {}, {}
    worst = 0.0
    for m in F64_TAIL_M:
        t = tail_inputs64(dev, g, m)
        x_b, alpha, basis = t["x_b"], t["alpha"], t["basis"]
        cases = [(h, b, alpha) for h in (True, False) for b in (False, True)]
        cases += [(True, False, -alpha.abs() - 1), (False, True, -alpha.abs() - 1)]
        for harris, bland, a in cases:
            flag = torch.tensor(bland, device=dev)
            got = hopper.ratio_eta(x_b, a, basis, 1e-7, flag, harris, 1e-6)
            want = hopper.ratio_eta_plain(x_b, a, basis, 1e-7, flag, harris, 1e-6)
            torch.cuda.synchronize()
            tag = f"ratio_eta f64 m={m} harris={harris} bland={bland} unbounded-case={a is not alpha}"
            check(got[1].dtype == got[3].dtype == torch.float64, f"{tag}: dtypes")
            for k, (gv, wv) in enumerate(zip(got, want)):
                check(torch.equal(gv, wv), f"{tag}: output {k} differs: {gv} vs {wv}")
            if not harris:
                q, th, unb = hopper.ratio_argmin(x_b, a, basis, 1e-7, flag)
                qp, thp, unbp = hopper.ratio_argmin_plain(x_b, a, basis, 1e-7, flag)
                torch.cuda.synchronize()
                check(th.dtype == torch.float64 and (int(q), bool(unb)) == (int(qp), bool(unbp))
                      and torch.equal(th, thp), f"ratio_argmin f64 m={m} bland={bland}: {int(q)} {float(th)!r} "
                      f"vs {int(qp)} {float(thp)!r}")
            print(f"{tag}: q {int(got[0])} theta_q {float(got[1])!r} ok (and ratio_argmin where classic)")
        for defer in (False, True):
            kind = "deferred" if defer else "eager"
            variants = {
                "": {},
                "positive x_b": {"x_b": x_b + 0.25},
                "bland": {"degen": torch.tensor(64, dtype=torch.int32, device=dev)},
                "optimal": {"min_e": torch.tensor(0.0, device=dev, dtype=torch.float64)},
                "unbounded": {"alpha": -alpha.abs() - 1},
                "non-finite min_e": {"min_e": torch.tensor(float("nan"), device=dev, dtype=torch.float64)},
                "non-finite theta": {"x_b": torch.full_like(x_b, float("inf"))},
            }
            for name, change in variants.items():
                for harris in ((True, False) if name in ("", "positive x_b") else (True,)):
                    worst = max(worst, check_tail(
                        f"pivot_tail f64 m={m} {kind} {name or 'pivoting'} harris={harris}", dev,
                        {**t, **change}, harris, defer, F64_TAIL_DEFER_RTOL, F64_TAIL_OPTS))
        if m == BENCH_M:
            no = torch.tensor(False, device=dev)
            args = tuple(t[k] for k in (
                "x_b", "alpha", "basis", "y", "c_b", "B_inv", "min_e", "e_p", "c_p", "p", "iters", "degen"))
            # bytes: x_b, alpha, y, c_b and row q of B_inv in, eta, row, x_b,
            # y, c_b out (8 each), basis in and out (4 each); ~12 flops a row
            rec = {
                "ms": time_ms(lambda: hopper.pivot_tail(*args, harris=True, **F64_TAIL_OPTS), 200),
                "plain_ms": time_ms(lambda: hopper.pivot_tail_plain(*args, harris=True, **F64_TAIL_OPTS), 50),
                "ratio_only_ms": time_ms(lambda: hopper.ratio_eta(x_b, alpha, basis, 1e-7, no, True), 200),
                "ratio_only_plain_ms": time_ms(lambda: hopper.ratio_eta_plain(x_b, alpha, basis, 1e-7, no, True), 200),
                **bound(8.0 * 10 * m + 4.0 * 2 * m + 64, 12.0 * m, PEAK_FP64_S),
                "library_ms": None,
            }
            rec_arg = {
                "ms": time_ms(lambda: hopper.ratio_argmin(x_b, alpha, basis, 1e-7, no), 200),
                "plain_ms": time_ms(lambda: hopper.ratio_argmin_plain(x_b, alpha, basis, 1e-7, no), 200),
                **bound(8.0 * 2 * m + 4.0 * m + 13, 2.0 * m, PEAK_FP64_S),
                "library_ms": None,
            }
            print(f"pivot_tail f64 m={m}, ms: {rec['ms']:.4f} (plain {rec['plain_ms']:.4f}); tail off "
                  f"{rec['ratio_only_ms']:.4f} (plain {rec['ratio_only_plain_ms']:.4f}); ratio_argmin "
                  f"{rec_arg['ms']:.4f} (plain {rec_arg['plain_ms']:.4f}); bound {rec['bound_ms']:.6f}")
        del t
    rec["max_abs_err"] = rec_arg["max_abs_err"] = worst
    return rec, rec_arg


def phase_f64_rank1(dev) -> dict:
    """``rank1_update`` in float64: bit for bit the unfused B + outer(eta,
    row) (the plain expression without a fused multiply-add) on the whole
    inverse (16-byte accesses, and element accesses at m - 1) and on row
    blocks (the whole update's rows); ``addr_`` within F64_RANK1_ATOL;
    timed beside ``addr_`` and its bound."""
    import torch

    from simplex_tpu_torch.kernels import hopper

    g = torch.Generator(device=dev).manual_seed(12)
    rec, worst = {}, 0.0
    for m in (BENCH_M, BENCH_M - 1):
        B = torch.randn(m, m, generator=g, device=dev, dtype=torch.float64)
        eta = torch.randn(m, generator=g, device=dev, dtype=torch.float64)
        row = B[m // 3].clone()
        got = hopper.rank1_update(B.clone(), eta, row)
        want = B + torch.outer(eta, row)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"rank1_update f64 m={m}: differs from B + outer(eta, row)")
        err = float((got - hopper.rank1_update_plain(B.clone(), eta, row)).abs().max())
        check(err <= F64_RANK1_ATOL, f"rank1_update f64 m={m}: {err} from addr_")
        worst = max(worst, err)
        print(f"rank1_update f64 m={m}: bit for bit B + outer(eta, row); {err:.3e} from addr_")
        if m == BENCH_M:
            for R in (2, 4):
                r0 = (R - 1) * (m // R)
                blk = B[r0 : r0 + m // R].clone()
                out = hopper.rank1_update(blk, eta[r0 : r0 + m // R].clone(), row)
                torch.cuda.synchronize()
                check(torch.equal(out, got[r0 : r0 + m // R]), f"rank1_update f64 row block {m // R}x{m}")
                print(f"rank1_update f64 row block {m // R}x{m} (rows {r0}..): bit for bit the whole update's rows")
                del blk, out
            small = eta * 1e-6
            rec = {
                "ms": time_ms(lambda: hopper.rank1_update(B, small, row)),
                "plain_ms": time_ms(lambda: hopper.rank1_update_plain(B, small, row)),
                **bound(16.0 * m * m + 16 * m, 2.0 * m * m, PEAK_FP64_S),
                "library_ms": time_ms(lambda: B.addr_(small, row)),
            }
            print(f"rank1_update f64 m={m}, ms: {rec['ms']:.4f} (plain {rec['plain_ms']:.4f}, addr_ "
                  f"{rec['library_ms']:.4f}), bound {rec['bound_ms']:.4f}")
        del B, got, want
    rec["max_abs_err"] = worst
    return rec


def f64_kernel_counts(tag, counts, steps) -> None:
    """The default path's three kernels, each launched once a pivot step."""
    for name in ("pricing_scan", "ratio_eta", "rank1_update"):
        check(counts[name] == steps, f"{tag}: {name} {counts[name]} launches in {steps} pivot steps")


def phase_f64_solve(dev) -> dict:
    """Float64 solves on the card under the default options (the kernels'
    float64 instantiations): the sample (z = 9, x = (1, 3)), Beale's
    cycler under both ratio tests (z = 0.05), the Klee-Minty ladder at n =
    4, 6, 8 (Dantzig 2^n - 1 pivots, steepest edge 1, devex fewer), the
    structured corpus and every MPS fixture through ``solve_general``
    against HiGHS at 1e-6, and ``random_dense_lp(2048, 4096)`` against
    HiGHS at 1e-9, each eager pivot step launching the three kernels once."""
    import numpy as np

    from simplex_tpu_torch import GeneralLP, SolveStatus, load_lp, read_mps, solve_general
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle import generator as gen
    from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy, solve_scipy_general

    paths = {}
    A, b, c = load_lp(ROOT / "tests" / "data" / "sample.txt", dtype=np.float64)
    res, _, counts, steps, _ = timed_solve_of(dev, A, b, c, f64_options())
    check(res.status == SolveStatus.OPTIMAL and res.z == 9.0 and list(res.x) == [1.0, 3.0, 0.0, 0.0],
          f"sample f64: {res.status!r} z {res.z} x {res.x}")
    f64_kernel_counts("sample f64", counts, steps)
    print(f"sample.txt f64: OPTIMAL z {res.z} x {res.x.tolist()} pivots {res.iters}; launches {counts}")
    paths["f64 sample"] = counts
    A, b, c = gen.beale_cycling_lp()
    for ratio in ("harris", "classic"):
        res, _, counts, steps, _ = timed_solve_of(dev, A, b, c, f64_options(ratio=ratio, bland_after=8))
        check(res.status == SolveStatus.OPTIMAL and abs(res.z - 0.05) < 1e-9, f"Beale f64 {ratio}: {res.status!r} {res.z!r}")
        print(f"Beale f64 {ratio}: OPTIMAL z {res.z!r} pivots {res.iters}; launches {counts}")
        paths[f"f64 Beale {ratio}"] = counts
    for n in (4, 6, 8):
        A, b, c = gen.klee_minty_lp(n)
        z_ref = solve_scipy(A, b, c).z
        piv = {}
        for pricing in ("dantzig", "devex", "steepest"):
            res, _, counts, steps, _ = timed_solve_of(dev, A, b, c, f64_options(ratio="classic", pricing=pricing))
            check(res.status == SolveStatus.OPTIMAL and abs(res.z - z_ref) < 1e-9 * z_ref,
                  f"Klee-Minty f64 n={n} {pricing}: {res.status!r} {res.z!r} vs {z_ref!r}")
            check(counts["ratio_eta"] == steps, f"Klee-Minty f64 n={n} {pricing}: ratio_eta {counts}")
            if pricing == "dantzig":
                f64_kernel_counts(f"Klee-Minty f64 n={n}", counts, steps)
            piv[pricing] = res.iters
            paths[f"f64 Klee-Minty n={n} {pricing}"] = counts
        check(piv["dantzig"] == 2 ** n - 1 and piv["steepest"] == 1 and piv["devex"] < piv["dantzig"],
              f"Klee-Minty f64 n={n}: pivots {piv}")
        print(f"Klee-Minty f64 n={n}: z {z_ref!r}, pivots {piv}")

    def mps(name):
        prob = read_mps(ROOT / "tests" / "data" / name)
        cc = prob.c if prob.maximize else -prob.c
        return GeneralLP(A=prob.A, b=prob.b, c=cc, row_types=prob.row_types, lower=prob.lower, upper=prob.upper)

    corpus = {
        "transportation 8x6 balanced": lambda: gen.transportation_lp(8, 6, seed=2, balanced=True),
        "transportation 64x48": lambda: gen.transportation_lp(64, 48, seed=11, balanced=False),
        "assignment 32": lambda: gen.assignment_lp(32, seed=12),
        "production 512x128": lambda: gen.production_lp(512, 128, seed=13),
        "multiperiod 32x16": lambda: gen.multiperiod_production_lp(32, 16, seed=0),
        **{f: (lambda f=f: mps(f)) for f in sorted(p.name for p in (ROOT / "tests" / "data").glob("*.mps"))},
    }
    for name, make in corpus.items():
        lp = make()
        hopper.reset_launches()
        t0 = time.perf_counter()
        res = solve_general(lp, options=f64_options(), device=dev)
        wall = time.perf_counter() - t0
        ref = solve_scipy_general(lp)
        check(res.status == ref.status, f"corpus f64 {name}: {res.status!r} vs HiGHS {ref.status!r}")
        gap = relative_gap(res.z, ref.z) if ref.status == SolveStatus.OPTIMAL else 0.0
        check(gap < F64_CORPUS_GAP, f"corpus f64 {name}: gap {gap:.3e}")
        if name.startswith("assignment"):
            x = np.round(res.x.reshape(32, 32))
            check(np.all(x.sum(axis=0) == 1) and np.all(x.sum(axis=1) == 1), "assignment f64: not a permutation")
        counts = dict(hopper.launches)
        print(f"corpus f64 {name}: {res.status.name} z {res.z!r} HiGHS {ref.z!r} gap {gap:.3e} pivots "
              f"{res.iters} in {wall:.2f} s; launches {counts}")
        paths[f"f64 corpus {name}"] = counts
    res, wall, counts, steps, _ = timed_solve(dev, SMALL_M, SMALL_N, f64_options())
    ref = highs(SMALL_M, SMALL_N)
    gap = relative_gap(res.z, ref.z)
    check(res.status == SolveStatus.OPTIMAL and gap <= F64_GAP_TOL, f"f64 {SMALL_M}x{SMALL_N}: {res.status!r} gap {gap:.3e}")
    f64_kernel_counts(f"f64 {SMALL_M}x{SMALL_N}", counts, steps)
    KEPT[("f64", SMALL_M, SMALL_N)] = res
    print(f"random_dense_lp({SMALL_M}, {SMALL_N}) f64: OPTIMAL z {res.z!r} HiGHS {ref.z!r} rel_gap {gap:.3e} "
          f"feas_err {res.feas_err:.3e} pivots {res.iters} wall {wall:.2f} s; launches {counts}")
    paths[f"f64 {SMALL_M}x{SMALL_N}"] = counts
    return paths


def phase_f64_bench(dev) -> dict:
    """The bench instance in float64 under the default options: the
    512-pivot window (pivots/s; each kernel once a pivot), then solved to
    OPTIMAL with the f64 KKT check, its feas_err beside the fp32 solve's
    (phase 3's, when it ran)."""
    from simplex_tpu_torch import SolveStatus

    paths = {}
    with loop_timer() as loop:
        res, wall, counts, steps, reads = timed_solve(dev, BENCH_M, BENCH_N, f64_options(max_iter=BENCH_WINDOW))
    check(res.status == SolveStatus.MAX_ITER and res.iters == BENCH_WINDOW, f"f64 window: {res.status!r} {res.iters}")
    f64_kernel_counts("f64 window", counts, steps)
    check(steps == BENCH_WINDOW, f"f64 window: {steps} pivot steps")
    KEPT["f64 window"] = (res, wall, reads, loop[0])
    print(f"random_dense_lp({BENCH_M}, {BENCH_N}) f64, max_iter={BENCH_WINDOW}: {res.iters} pivots in "
          f"{wall:.3f} s ({res.iters / wall:.1f} pivots/s end to end; the pivot loop alone "
          f"{res.iters / loop[0]:.1f}); launches {counts}; host reads {reads}")
    paths["f64 default window"] = counts
    res, wall, counts, steps, _ = timed_solve(dev, BENCH_M, BENCH_N, f64_options())
    check(res.status == SolveStatus.OPTIMAL, f"f64 full solve: {res.status!r}")
    f64_kernel_counts("f64 full solve", counts, steps)
    fp32 = KEPT.get((BENCH_M, BENCH_N))
    print(f"full solve random_dense_lp({BENCH_M}, {BENCH_N}) f64: OPTIMAL z {res.z!r} after {res.iters} pivots "
          f"in {wall:.2f} s ({res.iters / wall:.1f} pivots/s); " + kkt64(dev, BENCH_M, BENCH_N, res)
          + ("" if fp32 is None else f"; the fp32 solve: z {fp32.z!r}, {fp32.iters} pivots, "
             f"feas_err {fp32.feas_err:.3e}"))
    paths["f64 full solve"] = counts
    return paths


def phase_f64_entry_points(dev) -> dict:
    """Every other single-card entry point in float64 on the kernels, at
    2048 x 4096 against HiGHS where it answers a solve: the flagship set
    (bf16 shadow, 8 segments, defer 16, multiple pricing 64) and without
    multiple pricing, devex, steepest edge (eager and deferred), sparse A,
    ``reoptimize`` after one b_i moved and ``ranging`` of the answer,
    ``trace_pivots`` over 64 pivots (its bases equal ``solve(max_iter=k)``'s),
    ``solve_with_checkpoints`` stopped after two chunks and resumed, the
    bounded route's ``solve_general`` with presolve on multiperiod (32, 16),
    and ``cli solve --fp64`` without ``--backend``."""
    import numpy as np
    import scipy.sparse as sps

    from simplex_tpu_torch import SolveStatus, ranging, reoptimize, solve, solve_general, trace_pivots
    from simplex_tpu_torch.core import checkpoint
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle import generator as gen
    from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy, solve_scipy_general

    paths = {}
    A, b, c = instance(SMALL_M, SMALL_N)
    ref = highs(SMALL_M, SMALL_N)
    sets = {
        "flagship": dict(refactor_every=FLAGSHIP_REFACTOR, **FLAGSHIP),
        "flagship, multi-price off": dict(refactor_every=FLAGSHIP_REFACTOR, **{**FLAGSHIP, "multi_price": 0}),
        "devex": dict(pricing="devex"),
        "steepest": dict(pricing="steepest"),
        "steepest, defer 16": dict(pricing="steepest", update_defer=16),
    }
    for tag, kw in sets.items():
        res, wall, counts, steps, _ = timed_solve(dev, SMALL_M, SMALL_N, f64_options(**kw))
        gap = relative_gap(res.z, ref.z)
        check(res.status == SolveStatus.OPTIMAL and gap <= F64_GAP_TOL, f"f64 {tag}: {res.status!r} gap {gap:.3e}")
        check(counts["ratio_eta"] == steps, f"f64 {tag}: ratio_eta {counts['ratio_eta']} in {steps} steps")
        print(f"f64 {tag} {SMALL_M}x{SMALL_N}: OPTIMAL gap {gap:.3e} pivots {res.iters} ({steps} steps) "
              f"in {wall:.2f} s; launches {counts}")
        paths[f"f64 {tag}"] = counts
    res, wall, counts, steps, _ = timed_solve_of(dev, sps.csc_matrix(np.asarray(A, np.float64)), b, c, f64_options())
    gap = relative_gap(res.z, ref.z)
    check(res.status == SolveStatus.OPTIMAL and gap <= F64_GAP_TOL, f"f64 sparse: {res.status!r} gap {gap:.3e}")
    check(counts["ratio_eta"] == counts["rank1_update"] == steps and counts["pricing_scan"] == 0,
          f"f64 sparse: launches {counts} in {steps} steps")
    print(f"f64 sparse A (CSC) {SMALL_M}x{SMALL_N}: OPTIMAL gap {gap:.3e} pivots {res.iters} in {wall:.2f} s; "
          f"launches {counts}")
    paths["f64 sparse"] = counts
    base = KEPT[("f64", SMALL_M, SMALL_N)]
    b2 = np.asarray(b, np.float64).copy()
    b2[7] *= 1.5
    hopper.reset_launches()
    t0 = time.perf_counter()
    warm = reoptimize(A, b2, c, base, options=f64_options(), device=dev)
    wall = time.perf_counter() - t0
    wref = solve_scipy(A, b2, c)
    gap = relative_gap(warm.z, wref.z)
    check(warm.status == SolveStatus.OPTIMAL and gap <= F64_GAP_TOL, f"f64 reoptimize: {warm.status!r} gap {gap:.3e}")
    print(f"f64 reoptimize (b_7 x 1.5): OPTIMAL gap {gap:.3e} pivots {warm.iters} in {wall:.2f} s; "
          f"launches {dict(hopper.launches)}")
    paths["f64 reoptimize"] = dict(hopper.launches)
    rg = ranging(A, b, c, base.basis, device=dev)
    # strong duality of the ranged basis: y.b is the optimum (ranging runs
    # in float32, so the gate is the fp32 one)
    yb = float(np.asarray(rg.y, np.float64) @ np.asarray(b, np.float64))
    check(rg.ok and relative_gap(yb, base.z) <= GAP_TOL, f"f64 ranging: ok {rg.ok}, y.b {yb!r} vs z {base.z!r}")
    print(f"f64 ranging of the answer: ok, y.b {yb!r} against z {base.z!r}")
    hopper.reset_launches()
    k = F64_TRACE_PIVOTS
    recs = list(trace_pivots(A, b, c, options=f64_options(perturb_after=0), max_iter=k, device=dev))
    counts = dict(hopper.launches)
    cut = solve(A, b, c, options=f64_options(perturb_after=0, max_iter=k), device=dev)
    check(len(recs) == k and np.array_equal(recs[-1].basis, cut.basis) and cut.iters == k,
          f"f64 trace: {len(recs)} records; the basis against solve(max_iter={k})'s")
    check(counts["pricing_scan"] == 2 * k and counts["ratio_eta"] == counts["rank1_update"] == k,
          f"f64 trace: launches {counts} in {k} pivots")
    print(f"f64 trace_pivots over {k} pivots: the basis of solve(max_iter={k}); launches {counts}")
    paths["f64 trace"] = counts
    path = SCRATCH / "f64.npz"
    SCRATCH.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    seen = []

    def stop_after_two(state):
        seen.append(int(state.iters))
        if len(seen) == 2:
            raise Stop

    opts = f64_options(checkpoint_every=CHECKPOINT_EVERY)
    try:
        checkpoint.solve_with_checkpoints(A, b, c, path=path, options=opts, on_chunk=stop_after_two, device=dev)
    except Stop:
        pass
    hopper.reset_launches()
    res = checkpoint.solve_with_checkpoints(A, b, c, path=path, options=opts, device=dev)
    gap = relative_gap(res.z, ref.z)
    check(res.status == SolveStatus.OPTIMAL and gap <= F64_GAP_TOL and res.iters > seen[-1],
          f"f64 checkpoint resume: {res.status!r} gap {gap:.3e} iters {res.iters} after {seen}")
    print(f"f64 solve_with_checkpoints: stopped at {seen}, resumed to OPTIMAL at {res.iters} pivots, gap {gap:.3e}; "
          f"launches {dict(hopper.launches)}")
    paths["f64 checkpoint resume"] = dict(hopper.launches)
    lp = gen.multiperiod_production_lp(32, 16, seed=0)
    hopper.reset_launches()
    t0 = time.perf_counter()
    res = solve_general(lp, options=f64_options(), presolve=True, device=dev)
    wall = time.perf_counter() - t0
    gref = solve_scipy_general(lp)
    gap = relative_gap(res.z, gref.z)
    check(res.status == SolveStatus.OPTIMAL and gap <= F64_GAP_TOL, f"f64 general: {res.status!r} gap {gap:.3e}")
    check(hopper.launches["pricing_scan"] > 0, f"f64 general: launches {dict(hopper.launches)}")
    print(f"f64 solve_general(presolve) multiperiod (32, 16): OPTIMAL gap {gap:.3e} pivots "
          f"{res.iters} in {wall:.2f} s; launches {dict(hopper.launches)}")
    paths["f64 general"] = dict(hopper.launches)
    from simplex_tpu_torch import cli

    buf = io.StringIO()
    hopper.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["solve", str(ROOT / "tests" / "data" / "sample.txt"), "--fp64", "--device", str(dev)])
    out = buf.getvalue()
    check(rc == 0 and out.startswith("Optimum found: 9"), f"cli solve --fp64: {rc} {out!r}")
    print(f"cli solve sample.txt --fp64 (default backend): {out.splitlines()[0]}; launches {dict(hopper.launches)}")
    paths["f64 cli solve"] = dict(hopper.launches)
    return paths


F64_REOPT_B = 2  # bench-reopt's scenarios in float64 (bench.py --mode reopt --batch 2)
F64_SHARD_RANKS = 4  # gloo ranks on the card: 1-D over two of them, 2-D over 2 x 2
F64_CLASSIC_LP = (16, 40, 3)  # random_dense_lp(m, n, seed) whose float32 keys broke the 2-D classic test


def phase_f64_batched(dev) -> dict:
    """The batched modes in float64 under the default backend (the three
    batched kernels' float64 instantiations): bench.py --mode batch's
    recipe at B = 4,096 (its options) with solves/s, launches and reads a
    batch step, 16 sampled instances within F64_GAP_TOL of the single
    float64 solve; the recipe with an exact slack identity also against
    HiGHS; bench-reopt's cold basis and F64_REOPT_B scenarios through
    ``reoptimize_batched`` against HiGHS; the segmented cell (SEG_B x
    SEG_M x SEG_N, partial_pricing = SEG_S) against the single solve and
    HiGHS. Each eager batch step launches each batched kernel once (the
    segmented cell one pricing launch more a fallback stage)."""
    import numpy as np
    import torch

    from simplex_tpu_torch import SimplexOptions, SolveStatus, reoptimize_batched, solve, solve_batched
    from simplex_tpu_torch.batch import step as bstep
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle.reference import relative_gap

    f64 = {"dtype": torch.float64}
    paths = {}
    As, bs, cs = batch_instances(BATCH_B)
    solve_batched(As, bs, cs, options=SimplexOptions(**BATCH_OPTS, **f64), device=dev)  # first launches
    r = batch_run(dev, f"f64 bench recipe B={BATCH_B}", As, bs, cs, f64, highs=False, gap=F64_GAP_TOL)
    c, k = r["counts"], r["steps"]
    check(c["batch_pricing"] == c["batch_tail"] == c["batch_rank1"] == k, f"f64 batch: launches {c} over {k} steps")
    check(r["reads"]["control"] <= k + 1, f"f64 batch: {r['reads']} reads over {k} steps")
    paths[f"f64 solve_batched B={BATCH_B}"] = c
    As, bs, cs = batch_instances(BATCH_B, exact_slack=True)
    r = batch_run(dev, f"f64 exact slack B={BATCH_B}", As, bs, cs, f64, gap=F64_GAP_TOL)
    c, k = r["counts"], r["steps"]
    check(c["batch_pricing"] == c["batch_tail"] == c["batch_rank1"] == k, f"f64 exact slack: launches {c}")
    paths[f"f64 solve_batched exact slack B={BATCH_B}"] = c
    del As, bs, cs

    A, b, c0 = instance(REOPT_M, REOPT_N)
    opts = SimplexOptions(refactor_every=256, **f64)
    t0 = time.perf_counter()
    cold = solve(A, b, c0, options=opts, device=dev)
    check(cold.status == SolveStatus.OPTIMAL, f"f64 reopt base: {cold.status!r}")
    print(f"f64 reopt base {REOPT_M}x{REOPT_N}: cold OPTIMAL, {cold.iters} pivots in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(1)
    bsr = np.asarray(b, np.float64)[None, :] * (1 + 0.05 * rng.uniform(-1, 1, (F64_REOPT_B, REOPT_M)))
    refs = highs_all([(A, bsr[i], c0) for i in range(F64_REOPT_B)])
    torch.cuda.synchronize()
    hopper.reset_launches()
    bstep.reset_host_reads()
    t0 = time.perf_counter()
    res = reoptimize_batched(A, bsr, c0, cold, options=opts, device=dev)
    wall = time.perf_counter() - t0
    counts, steps = dict(hopper.launches), dict(bstep.steps)
    check(counts["batch_rank1"] >= steps["dual"] and counts["batch_tail"] == counts["batch_pricing"] == steps["primal"],
          f"f64 reopt: launches {counts}, steps {steps}")
    worst = 0.0
    for i, ref in enumerate(refs):
        check(SolveStatus(int(res.status[i])) == ref.status, f"f64 reopt scenario {i}: status {res.status[i]}")
        if ref.z is not None:
            worst = max(worst, relative_gap(float(res.z[i]), ref.z))
    check(worst <= F64_GAP_TOL, f"f64 reopt: gap {worst:.3e}")
    print(f"f64 reoptimize_batched {REOPT_M}x{REOPT_N}, {F64_REOPT_B} scenarios: {wall:.3f} s; statuses "
          f"{res.status.tolist()}; pivots {res.iters.tolist()}; batch steps {steps}; worst rel gap vs HiGHS "
          f"{worst:.3e}; feas_err {res.feas_err.tolist()}; launches {counts}")
    paths["f64 reoptimize_batched"] = counts

    As, bs, cs = seg_instances()
    refs = KEPT.setdefault("seg refs", {})
    r = batch_run(dev, f"f64 segmented S={SEG_S} {SEG_B}x{SEG_M}x{SEG_N}", As, bs, cs,
                  dict(partial_pricing=SEG_S, **f64), base={"polish": False}, refs=refs, gap=F64_GAP_TOL)
    c, k, br = r["counts"], r["steps"], r["branches"]
    check(c["batch_pricing"] == k + br["segment"] + br["shadow"] and c["batch_tail"] == c["batch_rank1"] == k,
          f"f64 segmented: launches {c}, passes {br} over {k} steps")
    paths["f64 solve_batched segmented"] = c
    return paths


def f64_sharded_rank(rank: int, world: int, port: int, dev_type: str, out) -> None:
    """One of F64_SHARD_RANKS gloo ranks on the card, in float64: the 2-D
    classic and Harris (Bland from the first degenerate pivot) solves of
    F64_CLASSIC_LP on a 2 x 2 mesh, then over ranks 0 and 1 ``solve_sharded``
    at 2048 x 4096 to OPTIMAL and bench-batch through ``solve_batched(mesh=)``
    (the others wait at the next barrier)."""
    import traceback

    import numpy as np
    import torch
    import torch.distributed as dist

    from simplex_tpu_torch import SimplexOptions, solve_batched
    from simplex_tpu_torch.dist import sharded, sharded2d
    from simplex_tpu_torch.dist.mesh import COLS_AXIS, ROWS_AXIS, initialize_multihost, make_mesh
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle.generator import random_dense_lp

    initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        mesh2 = make_mesh((ROWS_AXIS, COLS_AXIS), shape=(2, 2), device=dev_type)
        mesh1 = make_mesh((COLS_AXIS,), devices=[0, 1], device=dev_type)
        bmesh = make_mesh(("batch",), devices=[0, 1], device=dev_type)
        dev = torch.device("cuda", torch.cuda.current_device()) if dev_type == "cuda" else torch.device("cpu")
        rec = {}
        m, n, seed = F64_CLASSIC_LP
        A, b, c = random_dense_lp(m, n, seed=seed, dtype=np.float64)
        for tag, kw in (("classic", {"ratio": "classic"}), ("harris, bland_after=1", {"bland_after": 1})):
            hopper.reset_launches()
            sharded.reset_collectives()
            res = sharded2d.solve_sharded_2d(A, b, c, mesh2, options=SimplexOptions(dtype=torch.float64, **kw),
                                             device=dev)
            rec[tag] = dict(res=res, counts=dict(hopper.launches), collectives=dict(sharded.collectives))
        if mesh1.get_coordinate() is not None:
            A, b, c = instance(SMALL_M, SMALL_N)
            hopper.reset_launches()
            sharded.reset_collectives()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sharded.solve_sharded(A, b, c, mesh1, options=SimplexOptions(dtype=torch.float64), device=dev)
            torch.cuda.synchronize()
            rec["1-D"] = dict(res=res, wall=time.perf_counter() - t0, counts=dict(hopper.launches),
                              collectives=dict(sharded.collectives))
            As, bs, cs = batch_instances(BATCH_B)
            hopper.reset_launches()
            t0 = time.perf_counter()
            res = solve_batched(As, bs, cs, options=SimplexOptions(**BATCH_OPTS, dtype=torch.float64), mesh=bmesh,
                                device=dev)
            rec["batch"] = dict(res=res, wall=time.perf_counter() - t0, counts=dict(hopper.launches))
        dist.barrier()
        out.put((rank, "ok", rec))
    except Exception:
        out.put((rank, "err", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def phase_f64_sharded(dev) -> dict:
    """The sharded modes in float64 under the default backend, their MIN
    keys in float64: at world size 1 over NCCL the 1-D and the 1 x 1 2-D
    windows of the bench instance (BENCH_WINDOW pivots) against the single
    float64 window (the same pivots, basis and z; each kernel once a pivot
    step; two collectives a 1-D pivot step); then F64_SHARD_RANKS gloo
    ranks on this card: the 2-D solve on 2 x 2 under the classic ratio
    test and under Harris with Bland's rule from the first degenerate
    pivot on F64_CLASSIC_LP (the case whose float32 theta key returned a
    wrong OPTIMAL) against HiGHS and the single solve (F64_GAP_TOL,
    feas_err at most F64_GAP_TOL, the same z on every rank); over two of
    them ``solve_sharded`` at 2048 x 4096 to OPTIMAL against HiGHS and
    bench-batch's ``solve_batched(mesh=)`` against the call without a
    mesh."""
    import multiprocessing

    import numpy as np
    import torch
    import torch.distributed as dist

    from simplex_tpu_torch import SimplexOptions, solve, solve_batched
    from simplex_tpu_torch.dist import sharded, sharded2d
    from simplex_tpu_torch.dist.card_check import count_calls
    from simplex_tpu_torch.dist.mesh import COLS_AXIS, ROWS_AXIS, free_port, make_mesh
    from simplex_tpu_torch.kernels import hopper
    from simplex_tpu_torch.oracle.generator import random_dense_lp
    from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy

    if "f64 window" not in KEPT:
        phase_f64_bench(dev)
    single, s_wall, s_reads, s_loop = KEPT["f64 window"]
    window = f64_options(max_iter=BENCH_WINDOW)
    paths = {}
    mesh = make_mesh(device=dev.type)
    try:
        run = sharded_run(dev, mesh, *instance(BENCH_M, BENCH_N), window)
    finally:
        dist.destroy_process_group()
    check_sharded_window("f64 sharded window, world 1 (nccl)", run, single, s_reads)
    print(f"f64 solve_sharded world 1 (nccl), {BENCH_M}x{BENCH_N} window: {run['res'].iters} pivots in "
          f"{run['wall']:.3f} s ({run['res'].iters / run['wall']:.1f} pivots/s; the single float64 solve "
          f"{single.iters / s_wall:.1f}); same basis and z {run['res'].z!r}; collectives {dict(run['collectives'])}")
    paths["f64 sharded window, world 1"] = run["counts"]
    mesh = make_mesh((ROWS_AXIS, COLS_AXIS), shape=(1, 1), device=dev.type)
    A, b, c = instance(BENCH_M, BENCH_N)
    hopper.reset_launches()
    sharded.reset_collectives()
    try:
        with count_calls(sharded2d, "_step") as steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sharded2d.solve_sharded_2d(A, b, c, mesh, options=window, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    counts, k = dict(hopper.launches), steps[0]
    check(res.iters == single.iters == BENCH_WINDOW and bool((res.basis == single.basis).all()) and res.z == single.z,
          f"f64 2-D window: {res.iters} pivots, z {res.z!r} vs the single window's {single.z!r}")
    for name in ("pricing_scan", "rank1_update"):
        check(counts[name] == k, f"f64 2-D window: {name} {counts[name]} launches in {k} pivot steps")
    print(f"f64 solve_sharded_2d 1x1 (nccl), {BENCH_M}x{BENCH_N} window: {res.iters} pivots in {wall:.3f} s "
          f"({res.iters / wall:.1f} pivots/s); the same basis and z as the single float64 window; launches "
          f"{counts} in {k} steps; collectives { {n: v for n, v in sharded.collectives.items() if v} }")
    paths["f64 2-D window, 1x1 (nccl)"] = counts

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=f64_sharded_rank, args=(r, F64_SHARD_RANKS, port, dev.type, out))
             for r in range(F64_SHARD_RANKS)]
    for p in procs:
        p.start()
    recs, errors = {}, []
    try:
        for _ in procs:
            rank, kind, val = out.get(timeout=600)
            if kind == "ok":
                recs[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    check(not errors, "f64 sharded ranks failed:\n" + "\n".join(errors))
    m, n, seed = F64_CLASSIC_LP
    A, b, c = random_dense_lp(m, n, seed=seed, dtype=np.float64)
    ref = solve_scipy(A, b, c)
    one = solve(A, b, c, options=f64_options(ratio="classic"), device=dev)
    for tag in ("classic", "harris, bland_after=1"):
        res = recs[0][tag]["res"]
        for r in range(1, F64_SHARD_RANKS):
            other = recs[r][tag]["res"]
            check(other.z == res.z and (other.basis == res.basis).all(), f"f64 2-D {tag}: ranks disagree")
        gap, gap1 = relative_gap(res.z, ref.z), relative_gap(res.z, one.z)
        check(res.status.name == "OPTIMAL" and gap <= F64_GAP_TOL and gap1 <= F64_GAP_TOL
              and res.feas_err <= F64_GAP_TOL,
              f"f64 2-D {tag}: {res.status!r} z {res.z!r} HiGHS {ref.z!r} single {one.z!r} feas_err {res.feas_err}")
        print(f"f64 solve_sharded_2d 2x2 (gloo) {tag}, random_dense_lp{F64_CLASSIC_LP}: OPTIMAL z {res.z!r} "
              f"(HiGHS {ref.z!r}, single {one.z!r}) feas_err {res.feas_err:.3e} pivots {res.iters}; every rank "
              f"the same; collectives {recs[0][tag]['collectives']}")
        for r in range(F64_SHARD_RANKS):
            paths[f"f64 2-D {tag}, rank {r}"] = recs[r][tag]["counts"]
    ref = highs(SMALL_M, SMALL_N)
    runs = [recs[r]["1-D"] for r in range(2)]
    res = runs[0]["res"]
    check(runs[1]["res"].z == res.z and (runs[1]["res"].basis == res.basis).all(), "f64 1-D: ranks disagree")
    gap = relative_gap(res.z, ref.z)
    check(res.status.name == "OPTIMAL" and gap <= F64_GAP_TOL, f"f64 1-D: {res.status!r} rel gap {gap:.3e}")
    col = runs[0]["collectives"]
    print(f"f64 solve_sharded over 2 ranks (gloo, one card), {SMALL_M}x{SMALL_N}: OPTIMAL z {res.z!r} HiGHS "
          f"{ref.z!r} rel_gap {gap:.3e} feas_err {res.feas_err:.3e} pivots {res.iters} in {runs[0]['wall']:.2f} s; "
          f"collectives {col}; launches {runs[0]['counts']}")
    As, bs, cs = batch_instances(BATCH_B)
    base = solve_batched(As, bs, cs, options=SimplexOptions(**BATCH_OPTS, dtype=torch.float64), device=dev)
    for r in range(2):
        paths[f"f64 sharded 1-D {SMALL_M}x{SMALL_N}, rank {r}"] = runs[r]["counts"]
        bt = recs[r]["batch"]
        check((bt["res"].status == base.status).all() and np.allclose(bt["res"].z, base.z, rtol=F64_GAP_TOL, atol=0),
              f"f64 sharded batch rank {r}: statuses differ, or z beyond {F64_GAP_TOL} of the call without a mesh")
        paths[f"f64 solve_batched over 2 ranks, rank {r}"] = bt["counts"]
    print(f"f64 solve_batched over 2 ranks (gloo, one card), B={BATCH_B}: {recs[0]['batch']['wall']:.3f} s; "
          f"statuses equal and z within {F64_GAP_TOL} of the call without a mesh; launches rank 0 "
          f"{recs[0]['batch']['counts']}")
    return paths


def phase_f64_bench_ops(dev) -> dict:
    """The per-op bench in float64 on the hopper backend: the path that
    runs ``ratio_argmin`` in float64."""
    import torch

    from simplex_tpu_torch.bench.kernels import bench_ops, record_line
    from simplex_tpu_torch.kernels import hopper

    hopper.reset_launches()
    ops = bench_ops(BENCH_M, BENCH_N, k=32, backend="hopper", device=dev, dtype=torch.float64)
    counts = dict(hopper.launches)
    print(record_line(BENCH_M, BENCH_N, "hopper", dev, ops, torch.float64))
    check(counts["ratio_argmin"] > 0, "per-op bench f64: ratio_argmin never launched")
    return counts


def f64_device_ops(dev) -> dict:
    """:func:`phase_device_ops` for the float64 default path: device ops
    and device us a pivot of a profiled stretch of the bench instance's
    pivot loop in float64; the same limits."""
    from simplex_tpu_torch.bench.profile_canonical import profile_loop

    A, b, c = instance(BENCH_M, BENCH_N)
    rec = profiled(lambda: profile_loop(A, b, c, f64_options(), dev, warm=32, window=128),
                   lambda r: r["device_us_per_pivot"] > 0, "f64 default path profile")
    ops = rec["device_ops_per_pivot"]
    print(
        f"f64 default path, {rec['pivots_traced']} profiled pivots: {ops:.2f} device ops a pivot "
        f"(limit {MAX_DEVICE_OPS_PER_PIVOT}), {rec['device_us_per_pivot']:.1f} device us and "
        f"{rec['wall_ms_per_pivot']:.3f} wall ms a pivot, busy {rec['device_busy']:.1%}; "
        f"launches a pivot {rec['launches_per_pivot']}; largest items (us a pivot) {rec['top_us_per_pivot']}"
    )
    check(rec["device_us_per_pivot"] > 0, "the profiler saw no device time (f64)")
    check(ops <= MAX_DEVICE_OPS_PER_PIVOT, f"{ops:.2f} device ops a pivot on the f64 default path")
    for name in ("pricing_scan", "ratio_eta", "rank1_update"):
        check(rec["launches_per_pivot"][name] == 1.0, f"f64 {name}: {rec['launches_per_pivot'][name]} launches a pivot")
    return rec


def f64_kernel_phases(dev) -> dict:
    """The float64 kernel checks; their records by name."""
    import torch

    recs = {"pricing_scan_f64": phase_f64_pricing(dev)}
    torch.cuda.empty_cache()
    recs["ratio_eta_f64"], recs["ratio_argmin_f64"] = phase_f64_ratio(dev)
    recs["rank1_update_f64"] = phase_f64_rank1(dev)
    torch.cuda.empty_cache()
    recs.update(phase_batch_kernels(dev, torch.float64))
    torch.cuda.empty_cache()
    return recs


def add_f64_profile(recs: dict, prof: dict, ratio_us: dict) -> None:
    """The float64 default path's device us a pivot and each float64
    kernel's own share of it (profiler), and the ratio kernels' device us a
    launch in float64, into the float64 records."""
    for name in ("pricing_scan_f64", "ratio_eta_f64", "rank1_update_f64"):
        recs[name]["f64_default_pivot_device_us"] = prof["device_us_per_pivot"]
        recs[name]["f64_default_device_ops_per_pivot"] = prof["device_ops_per_pivot"]
    for key, us in prof["top_us_per_pivot"].items():
        for name, symbol in (("pricing_scan_f64", "pricing_"), ("ratio_eta_f64", "pivot_tail_kernel"),
                             ("rank1_update_f64", "rank1_kernel")):
            if symbol in key and "<double" in key:
                dev_us = recs[name].setdefault("device_us_per_pivot", 0.0)
                recs[name]["device_us_per_pivot"] = dev_us + us
    recs["ratio_argmin_f64"]["device_us"] = ratio_us["ratio_argmin"]
    recs["ratio_eta_f64"]["ratio_only_device_us"] = ratio_us["ratio_eta, harris, tail off"]
    recs["ratio_eta_f64"]["ratio_only_classic_device_us"] = ratio_us["ratio_eta, classic, tail off"]


def add_call_device_us(recs: dict, us: dict) -> None:
    """The record's keys for ``batch_kernel_device_us``'s times."""
    recs["batch_pricing"]["reopt_device_us"] = us["batch_pricing shared 256x2048x4096"]
    recs["batch_pricing"]["bf16_device_us"] = us["batch_pricing bf16 4096x64x160"]
    recs["batch_pricing"]["window_device_us"] = us["batch_pricing window 64x512x4096"]
    recs["batch_pricing"]["window_bf16_device_us"] = us["batch_pricing window bf16 64x512x4096"]
    recs["batch_pricing"]["window_shared_device_us"] = us["batch_pricing window shared 256x2048x4096"]
    recs["batch_tail"]["device_us"] = us["batch_tail 4096x64 warp path"]
    recs["batch_tail"]["block_path_device_us"] = us["batch_tail 4096x64 block path"]
    recs["batch_tail"]["cleanup_device_us"] = us["batch_tail 256x2048"]
    if "batch_pricing_f64" in recs:
        recs["batch_pricing_f64"]["device_us"] = us["batch_pricing f64 4096x64x160"]
        recs["batch_pricing_f64"]["reopt_device_us"] = us["batch_pricing shared f64 256x2048x4096"]
        recs["batch_pricing_f64"]["window_shared_device_us"] = us["batch_pricing window shared f64 256x2048x4096"]
        recs["batch_tail_f64"]["device_us"] = us["batch_tail f64 4096x64 warp path"]
        recs["batch_tail_f64"]["m128_warp_device_us"] = us["batch_tail f64 4096x128 warp path"]
        recs["batch_tail_f64"]["m128_block_device_us"] = us["batch_tail f64 4096x128 block path"]
        recs["batch_tail_f64"]["m256_warp_device_us"] = us["batch_tail f64 4096x256 warp path"]
        recs["batch_tail_f64"]["m256_block_device_us"] = us["batch_tail f64 4096x256 block path"]
        recs["batch_rank1_f64"]["device_us"] = us["batch_rank1 f64 4096x64"]


def timed(fn):
    """``fn`` that prints its own seconds when it returns or raises."""

    @functools.wraps(fn)
    def run(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            print(f"phase {fn.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)

    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["kernels", "new", "sharded", "bench", "f64"], default=None,
                    help="kernels: stop after the kernel checks; new: the kernel build, then only "
                         "the batched, warm-batched and PDHG phases and the batch profile; sharded: "
                         "the kernel build, rank-1 on row blocks, pricing on a shard, the default "
                         "window and every distributed phase; bench: the kernel build and the bench "
                         "entry point's runs; f64: the kernel build, the float64 kernel checks, the "
                         "float64 solves and their profile (no final ok line in any of them)")
    args = ap.parse_args(argv)
    if not (ROOT / "simplex_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    for name, fn in list(globals().items()):
        if name.startswith("phase_") and callable(fn):
            globals()[name] = timed(fn)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t_start = time.perf_counter()
    phase_build()
    if args.only == "new":
        for phase in (phase_solve_batched, phase_reoptimize_batched, phase_batch_rules,
                      phase_reopt_rules, phase_pdhg):
            for tag, counts in phase(dev).items():
                print(f"launches on path '{tag}': {counts}")
            torch.cuda.empty_cache()
        print(f"batch profile: {phase_batch_profile(dev)}")
        print(f"warm batched and PDHG profiles: {phase_warm_and_pdhg_profile(dev)}")
        print(f"new phases: {time.perf_counter() - t_start:.1f} s")
        print(card)
        return 0
    if args.only == "bench":
        for tag, counts in phase_bench(dev).items():
            print(f"launches on path '{tag}': {counts}")
        print(f"bench phase: {time.perf_counter() - t_start:.1f} s")
        print(card)
        return 0
    if args.only == "f64":
        recs = f64_kernel_phases(dev)
        paths = {}
        for phase in (phase_f64_solve, phase_f64_bench, phase_f64_entry_points, phase_f64_batched,
                      phase_f64_sharded):
            paths.update(phase(dev))
            torch.cuda.empty_cache()
        paths["f64 per-op bench (hopper)"] = phase_f64_bench_ops(dev)
        add_f64_profile(recs, f64_device_ops(dev), phase_ratio_device_time(dev, torch.float64))
        for tag, counts in paths.items():
            print(f"launches on path '{tag}': {counts}")
        print(f"f64 phases: {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": recs}))
        print(card)
        return 0
    if args.only == "sharded":
        phase_rank1(dev)
        phase_shard_pricing(dev)
        paths = {"default window": phase_solve(dev)}
        paths.update(phase_sharded(dev))
        paths.update(phase_sharded_pdhg(dev))
        paths.update(phase_sharded_2d(dev))
        for tag, counts in paths.items():
            print(f"launches on path '{tag}': {counts}")
        print(f"sharded phases: {time.perf_counter() - t_start:.1f} s")
        print(card)
        return 0
    recs = {
        "pricing_scan": phase_pricing(dev),
        "ratio_argmin": phase_ratio_argmin(dev),
        "ratio_eta": phase_ratio_eta(dev),
        "rank1_update": phase_rank1(dev),
    }
    bf16 = phase_pricing_bf16(dev)
    recs["pricing_scan"]["shapes"] = {f"bf16 {tag}": r for tag, r in bf16.items()}
    recs["pricing_scan"]["shapes"].update(
        {f"shard {tag}": r for tag, r in phase_shard_pricing(dev).items()})
    phase_pricing_bounded(dev)
    torch.cuda.empty_cache()
    recs.update(f64_kernel_phases(dev))
    recs.update(phase_batch_kernels(dev))
    torch.cuda.empty_cache()
    if args.only == "kernels":
        print(f"kernel checks: {time.perf_counter() - t_start:.1f} s")
        add_call_device_us(recs, batch_kernel_device_us(dev))
        print(json.dumps({"kernels": recs}))
        print(card)
        return 0
    paths = {"default window": phase_solve(dev)}
    phase_full_solve(dev)
    for phase in (phase_f64_solve, phase_f64_bench, phase_f64_entry_points):
        paths.update(phase(dev))
        torch.cuda.empty_cache()
    paths.update(phase_flagship_window(dev))
    phase_flagship_full(dev)
    torch.cuda.empty_cache()
    paths["per-op bench (hopper)"] = phase_bench_ops(dev)
    paths["f64 per-op bench (hopper)"] = phase_f64_bench_ops(dev)
    torch.cuda.empty_cache()
    paths["mps files (cli)"] = phase_mps_cli(dev)
    paths.update(phase_general(dev))
    torch.cuda.empty_cache()
    paths.update(phase_pricing_rules(dev))
    paths.update(phase_warm_restart(dev))
    paths.update(phase_general_warm(dev))
    torch.cuda.empty_cache()
    paths.update(phase_trace(dev))
    paths.update(phase_checkpoint(dev))
    torch.cuda.empty_cache()
    paths.update(phase_cli_more(dev))
    paths.update(phase_sparse(dev))
    torch.cuda.empty_cache()
    paths.update(phase_solve_batched(dev))
    torch.cuda.empty_cache()
    paths.update(phase_reoptimize_batched(dev))
    torch.cuda.empty_cache()
    paths.update(phase_batch_rules(dev))
    torch.cuda.empty_cache()
    paths.update(phase_reopt_rules(dev))
    torch.cuda.empty_cache()
    paths.update(phase_pdhg(dev))
    torch.cuda.empty_cache()
    paths.update(phase_bench(dev))
    torch.cuda.empty_cache()
    paths.update(phase_sharded(dev))
    torch.cuda.empty_cache()
    paths.update(phase_sharded_pdhg(dev))
    torch.cuda.empty_cache()
    paths.update(phase_sharded_2d(dev))
    torch.cuda.empty_cache()
    for phase in (phase_f64_batched, phase_f64_sharded):
        paths.update(phase(dev))
        torch.cuda.empty_cache()
    # last: a profiler run leaves every later launch of the process dearer
    phase_device_ops(dev)
    add_f64_profile(recs, f64_device_ops(dev), phase_ratio_device_time(dev, torch.float64))
    phase_sparse_profile(dev)
    ratio_us = phase_ratio_device_time(dev)
    bprof = phase_batch_profile(dev)
    for name, us in bprof["kernel_device_us"].items():
        recs[name]["device_us_per_batch_step"] = us
    for name, us in bprof["rules"]["dantzig f64"]["kernel_device_us"].items():
        recs[f"{name}_f64"]["device_us_per_batch_step"] = us
    add_call_device_us(recs, bprof["kernel_calls_device_us"])
    phase_warm_and_pdhg_profile(dev)
    recs["ratio_argmin"]["device_us"] = ratio_us["ratio_argmin"]
    recs["ratio_eta"]["ratio_only_device_us"] = ratio_us["ratio_eta, harris, tail off"]
    recs["ratio_eta"]["ratio_only_classic_device_us"] = ratio_us["ratio_eta, classic, tail off"]
    for tag, counts in paths.items():
        print(f"launches on path '{tag}': {counts}")
    print(f"all phases: {time.perf_counter() - t_start:.1f} s")

    # a float64 path's launches count for the float64 instantiations
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES[F64_KERNELS.get(name, name)],
            "replaces": REPLACES[F64_KERNELS.get(name, name)],
            "launches": sum(counts[F64_KERNELS.get(name, name)] for tag, counts in paths.items()
                            if tag.startswith("f64 ") == (name in F64_KERNELS)),
            **recs[name],
        }
        for name in [*SOURCES, *F64_KERNELS]
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
