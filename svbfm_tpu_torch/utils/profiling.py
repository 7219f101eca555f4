"""Profiling and timing hooks.

Counterpart of ``svbfm_tpu/utils/profiling.py``.  The reference brackets
each iteration with rusage/clock timers (``src/util/util.h:66-89``) and
logs ``time_learn``/``time_pred`` to RLog; its ``getRSS.c`` memory probe is
dead code.  Here: wall-clock step timers that wait on a tensor's stream,
``torch.profiler`` traces of the CPU and the CUDA activities written as a
Chrome trace (``chrome://tracing`` or Perfetto read it; no TensorBoard
package is needed), and the caching allocator's device-memory statistics
in place of the MemoryLog byte counter.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

TRACE_FILE = "trace.json"  # the Chrome trace ``trace`` writes in log_dir


def _wait(t: torch.Tensor) -> None:
    """Wait until the work queued on ``t``'s stream so far has finished."""
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


class StepTimer:
    """Accumulates per-phase wall times; RLog-friendly."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[torch.Tensor] = None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _wait(sync)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def mean(self, name: str) -> float:
        return self.totals.get(name, 0.0) / max(self.counts.get(name, 0), 1)

    def report(self) -> str:
        return "  ".join(f"{k}={self.mean(k)*1000:.1f}ms"
                         for k in sorted(self.totals))


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the block (no-op when log_dir is falsy):
    the CPU activities and, where CUDA is available, the CUDA kernels and
    copies, written as a Chrome trace to ``<log_dir>/trace.json``.  Yields
    the profiler (None when off)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def device_memory_stats() -> dict:
    """Per-device memory statistics (bytes and counts) of the CUDA caching
    allocator, ``torch.cuda.memory_stats`` (the MemoryLog replacement,
    ``src/util/memory.h:31-54``); empty without CUDA."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        if s:
            out[f"cuda:{i}"] = {k: int(v) for k, v in s.items()
                                if isinstance(v, (int, float))}
    return out
