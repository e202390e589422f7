"""Phase timing: ``simplex_tpu.bench.timing`` for PyTorch on a CUDA device.

PyTorch returns before the card finishes, so a host clock read without a
synchronize measures the enqueue. Here:

  * host-visible phases (set-up / solve / polish) are timed with
    ``PhaseTimer``, which synchronizes the device before each stop;
  * a callable's device time (the per-op bench) is read with CUDA events by
    :func:`elapsed_ms`;
  * :func:`trace` wraps a block in ``torch.profiler`` for a timeline.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulating named-phase wall-clock timer with device fencing."""

    def __init__(self, device=None) -> None:
        self.device = device
        self.durations: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a phase; the device is synchronized before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(self.device)
            self.durations[name] = self.durations.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.durations.values())
        lines = [f"{'Total':>16s}: {total:8.3f} s"]
        lines += [f"{k:>16s}: {v:8.3f} s" for k, v in self.durations.items()]
        return "\n".join(lines)


def elapsed_ms(fn: Callable[[], object], device) -> float:
    """Milliseconds one call of ``fn`` takes: CUDA events around it on a
    CUDA device, the host clock on the CPU (where there is no device time)."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` around a block (CPU and CUDA activity), written as
    a Chrome trace under ``log_dir``; a no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(f"{log_dir}/trace.json")
