"""Reading a ``torch.profiler`` trace of a stretch of the window.

The arithmetic of ``simplex_tpu_torch/bench/profile_canonical.py`` and
``dist/card_check.py`` (device operations and time by name; the NCCL
kernels' time a pivot step), copied here so that the program cannot move
it, plus the device's busy time as the union of its operations' intervals
and the idle gaps between them. Only device records are traced (CUDA
activity), so the host pays the least for the trace.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch


@contextlib.contextmanager
def profiled(device):
    """Profile a block on ``device``; yields a dict that gets ``prof`` and
    ``wall_s`` (the block's host time between two synchronizes)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    out = {}
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield out
        _sync(device)
        out["wall_s"] = time.perf_counter() - t0
    out["prof"] = prof


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_records(prof, cuda: bool):
    """(name, start_us, end_us) of every device operation (kernels,
    memsets, copies; on the CPU, a rehearsal, the CPU ops), in start
    order. The profiler's ``nccl:`` ranges, which span NCCL kernels, are
    not operations of their own."""
    want = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    out = []
    for e in prof.events():
        if e.device_type != want or e.name.startswith("nccl:"):
            continue
        if not cuda and e.cpu_parent is not None:
            continue  # a rehearsal counts the top-level CPU ops only
        out.append((e.name, float(e.time_range.start), float(e.time_range.end)))
    out.sort(key=lambda r: r[1])
    return out


def summarize(recs, wall_s: float, top: int = 10) -> dict:
    """Busy time (the union of the records' intervals), the time and count
    of each operation by name, and the idle gaps grouped by the operation
    that ended them."""
    by_name = collections.defaultdict(lambda: [0, 0.0])
    gaps = collections.Counter()
    busy, cur_s, cur_e = 0.0, None, None
    for name, s, e in recs:
        by_name[name][0] += 1
        by_name[name][1] += (e - s) * 1e-6
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps[f"before {name[:80]}"] += (s - cur_e) * 1e-6
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    ops = sorted(((k, v[1]) for k, v in by_name.items()), key=lambda kv: -kv[1])
    return {
        "n_ops": len(recs),
        "busy_s": busy * 1e-6,
        "window_s": wall_s,
        "ops": {k: {"count": v[0], "s": v[1]} for k, v in by_name.items()},
        "breakdown": {
            "device_ops": [[k[:120], s] for k, s in ops[:top]],
            "idle_gaps": [[k, s] for k, s in gaps.most_common(top)],
        },
    }


def kernel_seconds(summary: dict, match) -> float:
    """Total device seconds of the operations whose name ``match`` accepts."""
    return sum(v["s"] for k, v in summary["ops"].items() if match(k))


def rank_summaries(traced) -> list:
    """The traced stretch's summary of each rank (one on one card)."""
    if traced is None:
        return []
    return traced.get("ranks", [traced])


def roofline_share(ctx, launched: str, match, nbytes, flops) -> "float | None":
    """A kernel's share of its roofline in %, the mean over the ranks: the
    least time its frozen bytes and operations allow (``roofline/``) over
    its device time a call (the traced time of the records ``match``
    accepts, over the calls ``hopper.launches[launched]`` counted). None
    when the stretch called it not at all."""
    from benchmark import roofline

    cfg = ctx["cell"].config
    peaks = roofline.peaks()
    peak = peaks["fp64_flops_s"] if cfg["dtype"] == "float64" else peaks["fp32_flops_s"]
    shares = []
    for s in rank_summaries(ctx["trace"]):
        calls, secs = s["launches"].get(launched, 0), kernel_seconds(s, match)
        if calls <= 0 or secs <= 0:
            continue
        shares.append(100.0 * roofline.bound_s(nbytes(s), flops(s), peak) / (secs / calls))
    return sum(shares) / len(shares) if shares else None


def idle_share(ctx) -> "float | None":
    """1 - busy / window in %, the mean over the ranks."""
    got = [100.0 * (1.0 - s["busy_s"] / s["window_s"]) for s in rank_summaries(ctx["trace"]) if s["window_s"] > 0]
    return sum(got) / len(got) if got else None
