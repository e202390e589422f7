"""Device-time profile of the general route's phase 1 on the card.

For each instance and option set, ``solve_general`` runs with ``max_iter``
set to a window of W pivots, which stops phase 1 there; only phase 1's
solver call is timed and traced (standardize, the driveout and the host work
around the call are not). One unprofiled run gives the wall time, one under
``torch.profiler`` (CUDA activity) the device time by item. What is counted:

  device_us_per_pivot  the self device time of every CUDA activity record
                       (kernels, memsets, device-to-device and device-to-host
                       copies) over the traced call, per pivot; the
                       host-to-device upload of A_std ("Memcpy HtoD") is
                       set-up, reported apart as ``upload_HtoD_ms``
  device_ops_per_pivot the number of those records, per pivot
  device_busy          device time over the unprofiled call's wall time; the
                       wall time holds the call's set-up and closing polish,
                       so it is a lower bound on the pivot loop's share
  top_us_per_pivot     the eight largest items by name (90 characters)

The instances are those of ``chip_smoke.py``'s general phase: A =
``multiperiod_production_lp(64, 16)``, B = the same at (256, 16), C =
``transportation_lp(64, 1024, balanced=False)``; A and B under the default
options and ``bench.py --mode general``'s, C under the default options.

    python -m simplex_tpu_torch.bench.profile_general [--window 768]
        [--device cuda] [--out profile.json]

``--device cpu`` rehearses the control flow at tiny sizes (CPU activity, no
device numbers).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from simplex_tpu_torch import SimplexOptions, solve_general
from simplex_tpu_torch.core import twophase
from simplex_tpu_torch.oracle.generator import multiperiod_production_lp, transportation_lp

# bench.py --mode general's options (its argparse defaults)
GENERAL_BENCH = dict(pricing_dtype="bfloat16", partial_pricing=8, update_defer=16, refactor_every=1024)


def cases(small: bool):
    A_, B_, C_ = ((8, 4), (16, 4), (4, 16)) if small else ((64, 16), (256, 16), (64, 1024))
    bench = SimplexOptions(**GENERAL_BENCH, **({"partial_min_segment": 4} if small else {}))
    return [
        ("A default", lambda: multiperiod_production_lp(*A_, seed=0), SimplexOptions()),
        ("A bench-general", lambda: multiperiod_production_lp(*A_, seed=0), bench),
        ("B default", lambda: multiperiod_production_lp(*B_, seed=0), SimplexOptions()),
        ("B bench-general", lambda: multiperiod_production_lp(*B_, seed=0), bench),
        ("C default", lambda: transportation_lp(*C_, seed=0, balanced=False), SimplexOptions()),
    ]


def through_phase1(lp, opts, device, body):
    """Run ``solve_general`` with ``body`` wrapped around its phase-1 solver
    call (the one call that does not start from a bounds state,
    ``at_upper0``); returns what ``body`` returned."""
    inner = twophase.solve
    out = []

    def solve(*a, **k):
        if "at_upper0" in k:
            return inner(*a, **k)
        out.append(body(lambda: inner(*a, **k)))
        return out[-1][0]

    twophase.solve = solve
    try:
        solve_general(lp, options=opts, device=device)
    finally:
        twophase.solve = inner
    if len(out) != 1:
        raise RuntimeError(f"expected one phase-1 solver call, saw {len(out)}")
    return out[0]


def device_summary(prof, cuda: bool):
    """``(self device time by item name in us, number of device activity
    records, upload us)`` of a finished ``torch.profiler`` trace: every CUDA
    activity record (kernels, memsets, copies) but the host-to-device
    uploads, which are reported apart. On the CPU (a rehearsal) the records
    are the CPU ops."""
    dev_us = collections.Counter()
    n_ops, upload_us = 0, 0.0
    for evt in prof.key_averages():
        if cuda and evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = evt.self_cuda_time_total
        if evt.key.startswith("Memcpy HtoD"):
            upload_us += t
            continue
        dev_us[evt.key[:90]] += t
        n_ops += evt.count
    return dev_us, n_ops, upload_us


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()


def profile_case(lp, opts, device) -> dict:
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def timed(run):
        sync()
        t0 = time.perf_counter()
        r = run()
        sync()
        return r, time.perf_counter() - t0

    def traced(run):
        with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
            r = run()
            sync()
        return r, prof

    res, wall = through_phase1(lp, opts, device, timed)
    res2, prof = through_phase1(lp, opts, device, traced)
    dev_us, n_ops, upload_us = device_summary(prof, cuda)
    total = sum(dev_us.values())
    piv = max(1, res2.iters)
    return {
        "status": res.status.name,
        "pivots": res.iters,
        "pivots_profiled": res2.iters,
        "phase1_wall_s": wall,
        "wall_ms_per_pivot": 1e3 * wall / max(1, res.iters),
        "device_us_per_pivot": total / piv,
        "device_busy": total / 1e6 / wall,
        "upload_HtoD_ms": upload_us / 1e3,
        "device_ops_per_pivot": n_ops / piv,
        "top_us_per_pivot": {k: round(v / piv, 2) for k, v in dev_us.most_common(8)},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--window", type=int, default=None, help="phase-1 pivots (768; 20 on the CPU)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the records to this JSON file")
    args = ap.parse_args(argv)
    small = torch.device(args.device).type == "cpu"
    window = args.window or (20 if small else 768)
    if not small:
        torch.backends.cuda.matmul.allow_tf32 = False
    runs = cases(small)
    # warm-up: the kernels' build and the first launches
    solve_general(runs[0][1](), options=SimplexOptions(max_iter=50), device=args.device)
    out = {}
    for tag, make, opts in runs:
        rec = profile_case(make(), dataclasses.replace(opts, max_iter=window), args.device)
        out[tag] = rec
        print(tag, json.dumps(rec), flush=True)
        if not small:
            torch.cuda.empty_cache()
    if not small:
        print(card_line())
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
