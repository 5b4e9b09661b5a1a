"""Profiling hooks (``dualip_tpu/utils/profiling.py``).

``trace`` records a ``torch.profiler`` trace of the host and the card into a
directory, ``PhaseTimer`` adds up wall-clock phases, and ``annotate`` names a
span that shows in the trace (and as an NVTX range inside
``torch.autograd.profiler.emit_nvtx``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Record a ``torch.profiler`` trace (CPU activities, and CUDA where a
    card is present) of the block and write it to ``log_dir`` as a Chrome
    trace (``trace_<pid>_<ns>.json``, viewable in Perfetto or
    ``chrome://tracing``); nothing when not ``enabled``.

    >>> with trace("traces/solve"):
    ...     solver.maximize(objective, lam0)
    """
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the card's work of the block ends inside the window
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class PhaseTimer:
    """Wall-clock phase accumulation: ``with timer.phase("build"): ...``."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self, prefix: str = "") -> str:
        return " | ".join(f"{prefix}{k}={v:.2f}s" for k, v in self.phases.items())


def annotate(name: str):
    """A named span in profiler traces (``torch.profiler.record_function``;
    an NVTX range too inside ``torch.autograd.profiler.emit_nvtx``)."""
    import torch

    return torch.profiler.record_function(name)
