"""Profiling hooks: a ``torch.profiler`` trace of a block and a rolling
step timer.

Port of the JAX package's ``utils/profiling.py``: ``trace`` (and its
halves ``start_trace`` / ``stop_trace``, which the trainer's profiling
window calls across steps) captures the CPU and, where there is one, the
card's activity and writes a Chrome trace into ``log_dir``; ``StepTimer``
is copied.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import torch


def start_trace() -> torch.profiler.profile:
    """A running ``torch.profiler`` trace of the CPU and, where there is
    one, the card."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, log_dir, name: str = "trace") -> str:
    """Stop ``prof`` once the card's queue has run, and write it to
    ``log_dir/<name>.pt.trace.json`` (Chrome trace format, readable by
    Perfetto and TensorBoard's profile plugin); returns the path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{name}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str | None, name: str = "trace"):
    """Trace the block into ``log_dir`` (no-op for None)."""
    if log_dir is None:
        yield None
        return
    prof = start_trace()
    try:
        yield prof
    finally:
        stop_trace(prof, log_dir, name)


class StepTimer:
    """Rolling wall-clock step timer."""

    def __init__(self, window: int = 50):
        self.times = deque(maxlen=window)
        self._last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)
