"""What the metrics that read the program's own store share: the spans,
counters and per-iteration device marks of ``dualip_tpu_torch/utils/profiling.py``.

The program records a ``maximize`` call's spans, and the mean intervals of
its iterations between the device marks, while a ``torch.profiler`` runs: in
the traced window.  Its set-up spans (``dualip.build.*``) it records always.
A program without the store gives nothing to read, and every reader then
returns None."""

from __future__ import annotations

from typing import Optional


def store():
    """The program's store, or None where the program has none."""
    try:
        from dualip_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "STORE", None)


def _aggregate(name: str):
    s = store()
    agg = s.aggregates.get(name) if s is not None else None
    return agg if agg is not None and agg.count else None


def total_s(name: str) -> Optional[float]:
    """Seconds of all records of ``name``."""
    agg = _aggregate(name)
    return agg.total_ns * 1e-9 if agg is not None else None


def mean_ms(name: str) -> Optional[float]:
    """Milliseconds of one record of ``name``, on average."""
    agg = _aggregate(name)
    return agg.total_ns * 1e-6 / agg.count if agg is not None else None


def call_host_ms(waits=("dualip.agd.drain", "dualip.agd.replay")) -> Optional[float]:
    """Milliseconds of a ``dualip.agd.maximize`` record, on average, less
    its child records named in ``waits``: the host's own time in a call."""
    s = store()
    if s is None:
        return None
    calls = {e.id: e.end_ns - e.start_ns for e in s.events if e.name == "dualip.agd.maximize"}
    for e in s.events:
        if e.parent in calls and e.name in waits:
            calls[e.parent] -= e.end_ns - e.start_ns
    return sum(calls.values()) * 1e-6 / len(calls) if calls else None
