"""The traced window: ``torch.profiler`` over a fixed number of calls.

On the H100 machines a profiler window may lose the records of its first
kernels on the card, in some runs in every window.  So the window opens with
spin kernels, each waited for, whose records may go (``LEAD_KERNELS``, more
at each attempt); a window whose first launches after them lost records runs
again, up to ``len(LEAD_KERNELS)`` times.  The window proper is a
``record_function`` span, ``gpubench.window``, on the profiler's own
timeline; the device's busy time is the union of its records inside it,
leaving out the spin kernels.
"""

from __future__ import annotations

import time
from collections import defaultdict
from types import SimpleNamespace
from typing import List, Tuple

import numpy as np
import torch

LEAD_KERNELS = (32, 128, 512, 2048, 8192)  # by attempt
WINDOW = "gpubench.window"


def lead(attempt: int) -> int:
    """Spin kernels, each waited for; the host's clock (ns) after them."""
    for _ in range(LEAD_KERNELS[attempt - 1]):
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    return time.time_ns()


def is_lead(name: str) -> bool:
    return "spin_kernel" in name


def lost_records(prof, since_ns: int) -> int:
    """Records of the card lost from the window's first launches after
    ``since_ns``, up to the first launch kept whole: a kernel launch with no
    record under its correlation id, or a graph launch with fewer records
    than the window's fullest."""
    records, host = defaultdict(int), []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            records[e.correlation_id()] += 1
        elif e.start_ns() >= since_ns:
            host.append((e.start_ns(), e.correlation_id(), e.name()))
    most = max((records[c] for _, c, name in host if "GraphLaunch" in name), default=0)
    lost = 0
    for _, c, name in sorted(host):
        want = 1 if "LaunchKernel" in name else max(most, 1) if "GraphLaunch" in name else 0
        if want and records[c] >= want:
            break
        lost += want - min(records[c], want)
    return lost


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce(device: List[Tuple[str, float, float]], host: List[Tuple[str, float, float]],
           window: Tuple[float, float], top: int = 10, attributed: int = 2000) -> SimpleNamespace:
    """Device records (name, start, end in microseconds) clipped to
    ``window``, their busy time, and the breakdown: the device operations that
    took most time, and the idle time by what the host was doing (the
    innermost host operation over the middle of each of the ``attributed``
    longest idle gaps; the shorter gaps together under one name)."""
    w0, w1 = window
    records = [(n, max(s, w0), min(e, w1)) for n, s, e in device if min(e, w1) > max(s, w0)]
    busy = union([(s, e) for _, s, e in records])
    by_op = defaultdict(float)
    for n, s, e in records:
        by_op[n] += (e - s) * 1e-6
    edges = [w0] + [x for span in busy for x in span] + [w1]
    gaps = sorted(((e - s, (s + e) / 2) for s, e in zip(edges[0::2], edges[1::2]) if e > s), reverse=True)
    host = [h for h in host if h[0] != WINDOW]
    starts = np.array([h[1] for h in host], dtype=np.float64)
    ends = np.array([h[2] for h in host], dtype=np.float64)
    by_host = defaultdict(float)
    for length, mid in gaps[:attributed]:
        over = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = host[over[np.argmin(ends[over] - starts[over])]][0] if over.size else "(no host operation recorded)"
        by_host[name] += length * 1e-6
    if len(gaps) > attributed:
        by_host[f"(the {len(gaps) - attributed} shorter gaps)"] += sum(g for g, _ in gaps[attributed:]) * 1e-6

    def largest(d):
        return [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return SimpleNamespace(records=records, busy_s=sum(e - s for s, e in busy) * 1e-6, window_s=(w1 - w0) * 1e-6,
                           breakdown={"device_ops": largest(by_op), "idle_gaps": largest(by_host)},
                           attempts=1, lost_records=0)


def traced_window(run, device, again=None):
    """``run()`` (the window's calls) under the profiler; returns what it
    returned and the reduced trace.  ``again(bool)``, when given, hears
    after each attempt whether another follows (the other ranks of a
    multi-card run make the same calls)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    if torch.device(device).type != "cuda":
        raise RuntimeError("the traced window reads the card's records; there is no card")
    for attempt in range(1, len(LEAD_KERNELS) + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            since = lead(attempt)
            with record_function(WINDOW):
                out = run()
                torch.cuda.synchronize()
        lost = lost_records(prof, since)
        repeat = bool(lost) and attempt < len(LEAD_KERNELS)
        if again is not None:
            again(repeat)
        if not repeat:
            break
    cuda = torch.autograd.DeviceType.CUDA
    device_records, host_records, window = [], [], None
    for e in prof.events():
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == cuda:
            if not is_lead(e.name) and e.name != WINDOW and e.time_range.end > e.time_range.start:
                device_records.append(span)
        else:
            host_records.append(span)
            if e.name == WINDOW:
                window = (e.time_range.start, e.time_range.end)
    traced = reduce(device_records, host_records, window)
    traced.attempts, traced.lost_records = attempt, lost
    return out, traced
