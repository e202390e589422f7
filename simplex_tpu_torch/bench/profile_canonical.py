"""Wall and device time of the canonical pivot loop on the card, per pivot.

For each option set -- the default, ``bench.py``'s flagship with multiple
pricing on (64) and off, devex, and steepest edge with eager and deferred
(16) updates -- the solver's own pivot loop
(``core.solver._pivot_loop``) runs on ``random_dense_lp(m, n, seed=0)`` from
the slack basis in three stretches of one solve: a warm-up of ``--warm``
pivots (the kernels' build, first launches), ``--window`` pivots timed on the
host clock between two synchronizes, and ``--window`` more under
``torch.profiler`` (CUDA activity). Set-up (the upload of A, the shadow's
cast) and the closing polish are outside all three. What is counted:

  wall_ms_per_pivot    host clock over the timed stretch
  device_us_per_pivot  the self device time of every CUDA activity record
                       (kernels, memsets, copies) over the traced stretch
  device_ops_per_pivot the number of those records, per pivot
  device_busy          device_us_per_pivot over wall_ms_per_pivot
  steps_per_pivot      pivot steps over pivots in the traced stretch (above 1
                       when multiple pricing rejects a candidate)
  launches_per_pivot   the hand-written kernels' launch counts over the
                       traced stretch, per pivot
  host_reads_per_pivot device-to-host reads (``step.host_reads``: control and
                       branch) over the traced stretch, per pivot
  top_us_per_pivot     the eight largest items by name (90 characters)

``--dual`` adds a stretch of the dual simplex's loop (``core.dual``), the
same three stretches and the same record: the instance is solved to OPTIMAL
with the default options first, every b_i is then moved by up to ``--dual-
scale`` of its value (far outside the ranging band), and the dual loop
starts from the old basis. The stretches are shorter (``--window`` / 4):
the loop ends when the basis is primal-feasible again.

    python -m simplex_tpu_torch.bench.profile_canonical [--m 8192 --n 16384]
        [--warm 64 --window 256] [--only NAME] [--dual] [--device cuda]
        [--out profile.json]

``--device cpu`` rehearses the control flow at a tiny size (CPU activity, no
device numbers).
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

import numpy as np

from simplex_tpu_torch import SimplexOptions, solve
from simplex_tpu_torch.bench.profile_general import card_line, device_summary
from simplex_tpu_torch.core import dual, solver, step
from simplex_tpu_torch.core.state import (
    initial_state,
    initial_state_slack,
    problem_from_numpy,
    with_pricing_shadow,
)
from simplex_tpu_torch.core.step import read_control
from simplex_tpu_torch.kernels import hopper
from simplex_tpu_torch.kernels.dispatch import get_backend
from simplex_tpu_torch.oracle.generator import random_dense_lp

# bench.py's option set (its argparse defaults)
FLAGSHIP = dict(pricing_dtype="bfloat16", partial_pricing=8, update_defer=16, multi_price=64)


def option_sets(small: bool) -> dict:
    extra = {"partial_min_segment": 4} if small else {}
    return {
        "default": SimplexOptions(),
        "flagship, multi-price 64": SimplexOptions(**{**FLAGSHIP, "multi_price": 8 if small else 64}, **extra),
        "flagship, multi-price off": SimplexOptions(**{**FLAGSHIP, "multi_price": 0}, **extra),
        "devex": SimplexOptions(pricing="devex"),
        "steepest": SimplexOptions(pricing="steepest"),
        "steepest, defer 16": SimplexOptions(pricing="steepest", update_defer=4 if small else 16),
    }


def _record(prof, cuda, wall, timed, traced, steps) -> dict:
    dev_us, n_ops, _ = device_summary(prof, cuda)
    total = sum(dev_us.values())
    wall_ms = 1e3 * wall / max(1, timed)
    return {
        "pivots_timed": timed,
        "pivots_traced": traced,
        "wall_ms_per_pivot": wall_ms,
        "device_us_per_pivot": total / traced,
        "device_busy": total / traced / 1e3 / wall_ms,
        "device_ops_per_pivot": n_ops / traced,
        "steps_per_pivot": steps / traced,
        "launches_per_pivot": {k: v / traced for k, v in hopper.launches.items()},
        "host_reads_per_pivot": {k: v / traced for k, v in step.host_reads.items()},
        "top_us_per_pivot": {k: round(v / traced, 2) for k, v in dev_us.most_common(8)},
    }


def profile_loop(A, b, c, opts: SimplexOptions, device, warm: int, window: int) -> dict:
    """One solve's pivot loop in three stretches (warm-up, timed, traced);
    the record described in the module docstring."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    prob = problem_from_numpy(A, b, c, dev, opts.dtype)
    prob = with_pricing_shadow(prob, opts.pricing_dtype, opts.pricing)
    s = initial_state_slack(
        prob, opts.dtype, perturb=opts.perturb_after > 0,
        update_defer=opts.resolve_defer(), multi_price=opts.multi_price,
        pricing=opts.pricing,
    )
    backend = get_backend(opts.backend)
    steps = [0]
    inner = solver.pivot_step

    def counted(*a, **k):
        steps[0] += 1
        return inner(*a, **k)

    def run(s, upto):
        return solver._pivot_loop(
            prob, s, read_control(s, opts, prob, backend), opts, upto, backend
        )

    solver.pivot_step = counted
    try:
        s, ctl = run(s, warm)
        sync()
        t0 = time.perf_counter()
        s, ctl = run(s, warm + window)
        sync()
        wall = time.perf_counter() - t0
        timed = ctl.iters - warm
        steps[0] = 0
        hopper.reset_launches()
        step.reset_host_reads()
        with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
            s, ctl = run(s, warm + 2 * window)
            sync()
    finally:
        solver.pivot_step = inner
    traced = max(1, ctl.iters - warm - timed)
    return {"status": ctl.status, **_record(prof, cuda, wall, timed, traced, steps[0])}


def profile_dual(A, b, c, prev, opts: SimplexOptions, device, warm: int, window: int,
                 scale: float = 0.05, seed: int = 0) -> dict:
    """The dual loop from ``prev``'s basis after every b_i moved by up to
    ``scale`` of its value, in three stretches; the record of
    :func:`profile_loop` plus ``dual_pivots_to_feasible`` when the loop
    reached primal feasibility inside them."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rng = np.random.default_rng(seed)
    b2 = (np.asarray(b, np.float64) * (1 + scale * rng.uniform(-1, 1, np.shape(b)))).astype(np.float32)
    prob = problem_from_numpy(A, b2, c, dev, opts.dtype)
    s = initial_state(prob, prev.basis, opts.dtype)
    backend = get_backend(opts.backend)

    def run(s, upto):
        return dual._dual_loop(prob, s, dual.dual_control(prob, s, opts, backend), opts, upto, backend)

    s, ctl = run(s, warm)
    sync()
    t0 = time.perf_counter()
    s, ctl = run(s, warm + window)
    sync()
    wall = time.perf_counter() - t0
    timed = ctl.iters - warm
    hopper.reset_launches()
    step.reset_host_reads()
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        s, ctl = run(s, warm + 2 * window)
        sync()
    traced = max(1, ctl.iters - warm - timed)
    rec = {"status": ctl.status, "b_scale": scale, **_record(prof, cuda, wall, timed, traced, traced)}
    if ctl.status != 0:
        rec["dual_pivots_to_feasible"] = ctl.iters
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=None, help="rows (8192; 48 on the CPU)")
    ap.add_argument("--n", type=int, default=None, help="columns (16384; 160 on the CPU)")
    ap.add_argument("--warm", type=int, default=None, help="warm-up pivots (64; 4 on the CPU)")
    ap.add_argument("--window", type=int, default=None, help="pivots per stretch (256; 6 on the CPU)")
    ap.add_argument("--only", default=None, help="run the option sets whose name contains this")
    ap.add_argument("--dual", action="store_true", help="add the dual loop's stretch")
    ap.add_argument("--dual-scale", type=float, default=0.05, help="relative move of every b_i")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the records to this JSON file")
    args = ap.parse_args(argv)
    small = torch.device(args.device).type == "cpu"
    m, n = args.m or (48 if small else 8192), args.n or (160 if small else 16384)
    warm, window = args.warm or (4 if small else 64), args.window or (6 if small else 256)
    torch.backends.cuda.matmul.allow_tf32 = False
    A, b, c = random_dense_lp(m, n, seed=0)
    out = {}
    for tag, opts in option_sets(small).items():
        if args.only is not None and args.only not in tag:
            continue
        rec = profile_loop(A, b, c, opts, args.device, warm, window)
        out[tag] = rec
        print(tag, json.dumps(rec), flush=True)
        if not small:
            torch.cuda.empty_cache()
    if args.dual:
        prev = solve(A, b, c, device=args.device)
        rec = profile_dual(
            A, b, c, prev, SimplexOptions(), args.device, max(1, warm // 4),
            max(1, window // 4), args.dual_scale,
        )
        rec["cold_pivots"] = prev.iters
        out["dual"] = rec
        print("dual", json.dumps(rec), flush=True)
    if not small:
        print(card_line())
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
