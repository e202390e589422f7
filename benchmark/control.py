"""The readings a cell's limits are set from, on the card.

    python3 -m benchmark.control --workload NAME --seeds 1,2,... \
        [--control-seeds 3] [--seconds S] [--set key=value ...] [--out FILE]

In one process (the kernels built once), each seed runs the cell's window
as the benchmark does (``benchmark.run.run_cell``, at the cell's own size
and load) and judges the program's answers; on the first
``--control-seeds`` seeds it also judges the control (the reference put in
the program's place in bfloat16, ``reference/lowprec.py``) at the same
answers. ``--set`` changes an option of the program's run, such as
``pricing_dtype=bfloat16``: the program's own lower-precision path as the
control. Prints one JSON line a seed, then the lower reading (the largest
over the program's seeds) and the upper reading (the smallest over the
control's) of every number; ``--out`` writes them to a file as well.
Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def _value(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def readings(rows: list) -> dict:
    """lower: each number's largest program reading; upper: its smallest
    control reading."""
    out = {}
    for r in rows:
        for k, v in r["program"].items():
            out.setdefault(k, {"lower": -math.inf, "upper": math.inf})
            out[k]["lower"] = max(out[k]["lower"], v)
        for k, v in r.get("control", {}).items():
            out.setdefault(k, {"lower": -math.inf, "upper": math.inf})
            out[k]["upper"] = min(out[k]["upper"], v)
    return out


def main(argv=None) -> int:
    from benchmark import cells, drive, run

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated run seeds")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=None, help="window (default: BENCHMARK.json's)")
    ap.add_argument("--set", action="append", default=[], help="an option of the program's run, key=value")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cell = cells.load(args.workload, run.ROOT)
    seconds = args.seconds or json.loads((run.ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    overrides = dict(kv.split("=", 1) for kv in args.set)
    overrides = {k: _value(v) for k, v in overrides.items()}
    run.prepare_caches(run.ROOT)
    run.load_kernels()
    rows = []
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        out = run.run_cell(cell, seed, seconds, False, "cuda", drive.Clock(), overrides or None,
                           also_control=k < args.control_seeds)
        row = {"seed": seed, "correct": out["correct"], "metrics": out["metrics"],
               "program": {n: c["value"] for n, c in out["checks"].items()}}
        if "control" in out:
            row["control"] = out["control"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "overrides": overrides, "seconds": seconds,
               "card": run.power_limit(), "readings": readings(rows)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, **summary}, f, indent=1)
    bad = run.foreign_modules()
    if bad:
        print(f"loaded modules this benchmark must not load: {', '.join(bad)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
