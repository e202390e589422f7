"""Times the batched kernels' wrappers on the card, at the shapes their paths
run them, one call at a time:

  pricing fp32 4096x64x160      choose_entering_batched, per-instance A
                                (bench.py --mode batch's batch step)
  pricing bf16 4096x64x160      the same over the bf16 shadow
  pricing shared 256x2048x4096  one A and c for every instance (bench.py
                                --mode reopt's primal clean-up step)
  tail 4096x64                  pivot_tail_batched, Harris, every instance
  tail 256x2048                 active (the batch step; the clean-up's)
  window 64x512x4096 S=8        choose_entering_batched with a window of
  window bf16 64x512x4096 S=8   512 columns an instance (segmented pricing,
  window shared 256x2048x4096   partial_pricing = 8), per instance fp32 and
    S=8                         bf16, and on a shared A; starts that differ
                                between instances

``--dtype float64`` times the float64 cases instead, every float operand
in double:

  pricing f64 4096x64x160       per-instance A
  pricing shared f64            the shared product (FP64 tensor cores)
    256x2048x4096
  window f64 64x512x4096 S=8    the windows, per instance and on a shared A
  window shared f64             (the grouped window, FP64 tensor cores)
    256x2048x4096 S=8
  rank1 f64 4096x64             rank1_update_batched, every instance taking
  dgemm f64 256x2048x4096       library calls beside them, which the port
  dgemm window f64 256x2048x512 never makes: y @ A, y @ A[:, :w] (one
  baddbmm f64 4096x64           window's GEMM), B.baddbmm_(eta, row)

For each: ``events_ms``, the mean of 200 back-to-back calls between CUDA
events, and ``device_us``, the device time of every kernel one call
launches, from a ``torch.profiler`` trace of 20 calls. Inputs are random,
from a fixed seed, made on the device. One JSON line, with the card's name
and power limit.

Only the wrappers' signatures are used, so the file also times another
checkout of the port (the parent of a change, say) when that checkout's
package comes first on the path (a checkout whose wrapper takes no window
skips the window cases); run the two in turns in one call:

    python -m simplex_tpu_torch.bench.batch_kernels --tag change
    PYTHONPATH=path/to/parent python3 simplex_tpu_torch/bench/batch_kernels.py --tag parent

(``--dtype float64`` likewise: a checkout whose wrappers take float64.)
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys

import torch

CALLS_EVENTS, CALLS_TRACE = 200, 20
TAIL_OPTS = dict(eps=1e-5, pivot_tol=1e-7, feas_tol=1e-6, degen_tol=1e-9, bland_after=64,
                 harris=True)


def events_ms(fn, calls: int = CALLS_EVENTS) -> float:
    for _ in range(5):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls


def device_us(fn, calls: int = CALLS_TRACE) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / calls


def cases(dev: torch.device, f64: bool = False) -> dict:
    """name -> a call of one wrapper (or ``f64``: a float64 wrapper or
    library call) on fixed random inputs."""
    from simplex_tpu_torch.kernels import hopper

    g = torch.Generator(device=dev).manual_seed(11)

    def pricing(Bn, m, n, shared, dtype=torch.float32, S=0, vt=torch.float32):
        y = torch.randn(Bn, m, generator=g, device=dev, dtype=vt) / m ** 0.5
        lead = () if shared else (Bn,)
        A = torch.randn(*lead, m, n, generator=g, device=dev, dtype=vt).to(dtype)
        c = torch.randn(*lead, n, generator=g, device=dev, dtype=vt)
        basis = torch.rand(Bn, n, generator=g, device=dev).argsort(1)[:, :m]
        basis = basis.to(torch.int32).contiguous()
        no = torch.zeros(Bn, dtype=torch.bool, device=dev)
        if S:
            win = (n // S, S, torch.randint(0, 1000, (Bn,), generator=g, device=dev).to(torch.int32))
            return lambda: hopper.choose_entering_batched(y, A, c, 1e-5, no, basis, None, win)
        return lambda: hopper.choose_entering_batched(y, A, c, 1e-5, no, basis)

    def tail(Bn, m):
        def r(*shape):
            return torch.randn(*shape, generator=g, device=dev)

        basis = torch.rand(Bn, m + 50, generator=g, device=dev).argsort(1)[:, :m].to(torch.int32)
        zeros = torch.zeros(Bn, dtype=torch.int32, device=dev)
        args = (torch.rand(Bn, m, generator=g, device=dev) * 2, r(Bn, m), basis.contiguous(),
                r(Bn, m), r(Bn, m), r(Bn, m, m), -r(Bn).abs(), -r(Bn).abs(), r(Bn),
                torch.randint(0, m, (Bn,), generator=g, device=dev).to(torch.int32), zeros,
                zeros.clone(), zeros.clone(), torch.ones(Bn, dtype=torch.bool, device=dev))
        return lambda: hopper.pivot_tail_batched(*args, **TAIL_OPTS)

    if f64:
        d = torch.float64

        def rank1(lib):
            f = dict(generator=g, device=dev, dtype=d)
            B, row = torch.randn(4096, 64, 64, **f), torch.randn(4096, 64, **f)
            eta = torch.randn(4096, 64, **f) * 1e-6
            take = torch.ones(4096, dtype=torch.bool, device=dev)
            if lib:
                return lambda: B.baddbmm_(eta[:, :, None], row[:, None, :])
            return lambda: hopper.rank1_update_batched(B, eta, row, take)

        y = torch.randn(256, 2048, generator=g, device=dev, dtype=d)
        A = torch.randn(2048, 4096, generator=g, device=dev, dtype=d)
        return {
            "pricing f64 4096x64x160": pricing(4096, 64, 160, False, d, vt=d),
            "pricing shared f64 256x2048x4096": pricing(256, 2048, 4096, True, d, vt=d),
            "window f64 64x512x4096 S=8": pricing(64, 512, 4096, False, d, S=8, vt=d),
            "window shared f64 256x2048x4096 S=8": pricing(256, 2048, 4096, True, d, S=8, vt=d),
            "rank1 f64 4096x64": rank1(False),
            "dgemm f64 256x2048x4096": lambda: y @ A,
            "dgemm window f64 256x2048x512": lambda: y @ A[:, :512],
            "baddbmm f64 4096x64": rank1(True),
        }
    out = {
        "pricing fp32 4096x64x160": pricing(4096, 64, 160, False),
        "pricing bf16 4096x64x160": pricing(4096, 64, 160, False, torch.bfloat16),
        "pricing shared 256x2048x4096": pricing(256, 2048, 4096, True),
        "tail 4096x64": tail(4096, 64),
        "tail 256x2048": tail(256, 2048),
    }
    if "window" in inspect.signature(hopper.choose_entering_batched).parameters:
        out.update({
            "window 64x512x4096 S=8": pricing(64, 512, 4096, False, S=8),
            "window bf16 64x512x4096 S=8": pricing(64, 512, 4096, False, torch.bfloat16, S=8),
            "window shared 256x2048x4096 S=8": pricing(256, 2048, 4096, True, S=8),
        })
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m simplex_tpu_torch.bench.batch_kernels")
    ap.add_argument("--tag", default="", help="a name for the line (which checkout ran)")
    ap.add_argument("--dtype", choices=["float32", "float64"], default="float32",
                    help="float64: the float64 cases and their library calls")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("batch_kernels: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    calls = cases(dev, args.dtype == "float64")
    out = {name: {"events_ms": events_ms(fn)} for name, fn in calls.items()}
    for name, fn in calls.items():  # the traces last: a profiler run slows later launches
        out[name]["device_us"] = device_us(fn)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "dtype": args.dtype, "card": card, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
