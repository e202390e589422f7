"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout, on a machine with the cards the cell asks
for. Set-up (imports, CUDA and NCCL init, the kernels' load or nvcc build,
the inputs made on the device from the seed, a warm-up of every shape the
window runs) is timed from the start of the process to the first timed
pivot. The window then runs the cell's traffic for ``--seconds`` seconds,
between two device synchronizes, and the check (``benchmark/check.py``)
judges what it produced once it has closed and the peak memory has been
read. ``--trace 1`` adds a short stretch of the same work under
``torch.profiler`` after the window and reports the per-layer metrics in
place of the end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (answers judged), ``failed`` (answers over a limit),
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit; the same numbers are the
last lines of standard error. Without CUDA or without the cards the cell
asks for, or when JAX or the JAX package was loaded, it prints no result
and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FOREIGN = ("jax", "jaxlib", "flax", "simplex_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def foreign_modules() -> list:
    """The top-level names of loaded modules that this benchmark must never
    load, compared whole (``simplex_tpu_torch`` is not ``simplex_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FOREIGN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def prepare_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    from simplex_tpu_torch.kernels import _build

    _build.BUILD_DIR = root / "build" / "kernels"


def load_kernels() -> None:
    """Build (on a checkout's first run) and load the kernels."""
    from simplex_tpu_torch.kernels import _build

    _build.load_library()


def run_cell(cell, seed: int, seconds: float, trace_on: bool, device, clock,
             overrides=None, faults=None, also_control: bool = False) -> dict:
    """Run ``cell`` once on ``device`` and return the result object (the
    look for cards and for foreign modules is the caller's). ``overrides``
    changes options of the cell's traffic, ``faults`` plants a fault in the
    timed path (tests), ``also_control`` adds ``"control"``: the control's
    readings at the same answers (``benchmark/control.py``)."""
    import torch

    from benchmark import cells as cells_mod
    from benchmark import check, drive

    generator = cell.traffic["generator"]
    if cell.chips > 1:
        from benchmark import sharded

        run = sharded.run(cell, seed, seconds, trace_on, device, clock, overrides, faults)
    else:
        run = drive.GENERATORS[generator](cell, seed, seconds, trace_on, device, clock, overrides, faults)
    opts = drive.options(cell, overrides)
    judge = functools.partial(check.judge, run.records, run.inputs, opts.pricing, opts.pivot_tol,
                              opts.feas_tol, source=run.source)
    t0 = time.perf_counter()
    items = judge()
    check_s = time.perf_counter() - t0
    worst = check.worst(items)
    rows = check.compare(worst, cell.limits)
    failed = check.failed(items, cell.limits) + int(run.stalled is not None)
    correct = run.stalled is None and all(ok for _, _, _, ok in rows) and failed == 0

    metrics = {}
    if trace_on:
        ctx = {"cell": cell, "run": run, "trace": run.traced}
        for m in cell.per_layer:
            if not cell.reports(m):
                continue
            v = cells_mod.metric_reader(m["name"], cell.root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {
            "pivots_per_s": run.pivots / run.wall_s if run.wall_s > 0 and run.pivots else None,
            "solve_s": run.wall_s / run.solves if run.solves else None,
            "setup_s": run.setup_s,
        }
        for m in cell.end_to_end:
            if cell.reports(m) and e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    cuda = torch.device(device).type == "cuda"
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(torch.device(device)) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": run.memory_peak_bytes,
        "card": power_limit() if cuda else "",
    }
    out = {"correct": bool(correct), "attempted": len(items), "failed": failed, "metrics": metrics,
           "device": dev}
    if trace_on and run.traced is not None:
        dev["busy_s"] = run.traced["busy_s"]
        dev["window_s"] = run.traced["window_s"]
        out["breakdown"] = run.traced["breakdown"]
    if run.stalled:
        log(f"stalled: {run.stalled}")
    log("set-up: " + ", ".join(f"{label} {sec:.3f} s" for label, sec in run.setup_parts))
    log(f"window: {run.wall_s:.3f} s, {run.pivots} pivots, {run.solves} solves, set-up {run.setup_s:.3f} s, "
        f"check {check_s:.3f} s")
    if run.unit_s:
        per = sorted(1e3 * sec / max(1, piv) for piv, sec in run.unit_s)
        log(f"ms a pivot by chunk or solve: min {per[0]:.4f} median {per[len(per) // 2]:.4f} max {per[-1]:.4f} "
            f"over {len(per)}")
    for item in items:
        if "feas_err" in item:
            log(f"solve feas_err {item['feas_err']!r} (f64, the program's own reading)")
    checks = {}
    for name, v, limit, ok in rows:
        checks[name] = {"value": v, "limit": limit}
        shown = "not compared" if limit is None else f"limit {limit!r} {'ok' if ok else 'FAILED'}"
        log(f"check {name} {v!r} {shown}")
    if also_control:
        out["control"] = check.worst(judge(control=True))
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import cells, drive

    clock = drive.Clock(T_START)
    cell = cells.load(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {have}")
        return 2
    prepare_caches(ROOT)
    clock.stamp("imports")
    torch.empty(1, device="cuda")
    clock.stamp("CUDA init")
    load_kernels()
    clock.stamp("kernels loaded (nvcc build on a checkout's first run)")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", clock)
    bad = foreign_modules()
    if bad:
        log(f"loaded modules this benchmark must not load: {', '.join(bad)}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
