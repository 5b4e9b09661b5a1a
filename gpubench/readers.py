"""What the metrics' readers (``metrics/<name>.py``) share: kernel time from
the traced window's device records, matched by name, and roofline shares
against the card's peaks (``peaks.json``, by ``torch.cuda.get_device_name``)."""

from __future__ import annotations

import re
from typing import Iterable, Optional


def matches(name: str, patterns: Iterable[str]) -> bool:
    return any(re.search(p, name) for p in patterns)


def device_seconds(ctx, patterns: Iterable[str], exclude: bool = False) -> Optional[float]:
    """Seconds of the traced window's device records whose names match one of
    ``patterns`` (with ``exclude``: match none of them); None without a trace
    or when no record qualifies."""
    if ctx.trace is None:
        return None
    patterns = tuple(patterns)
    spans = [e - s for name, s, e in ctx.trace.records if matches(name, patterns) != exclude]
    return sum(spans) * 1e-6 if spans else None


def ms_per_iteration(ctx, patterns: Iterable[str], exclude: bool = False) -> Optional[float]:
    seconds = device_seconds(ctx, patterns, exclude)
    return None if seconds is None else seconds * 1e3 / ctx.iterations


def roofline_pct(ctx, patterns: Iterable[str], bytes_per_iteration: float) -> Optional[float]:
    """The least time the card's memory bandwidth allows for
    ``bytes_per_iteration``, as a share of the matching kernels' time an
    iteration; None when the card's peak is not in ``peaks.json``."""
    peak = ctx.peaks.get(ctx.device_kind)
    seconds = device_seconds(ctx, patterns)
    if peak is None or seconds is None:
        return None
    return 100.0 * (bytes_per_iteration / peak["hbm_bytes_per_s"]) / (seconds / ctx.iterations)
