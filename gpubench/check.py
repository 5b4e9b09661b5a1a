"""The comparison that decides ``correct``.

Each checked call is a ``maximize`` call of the program: a start and what it
returned (the dual objective at each iteration, the last dual, the last
gradient).  The reference runs the same call from the same start in float64.
Three numbers are compared, each the worst over the checked calls:

* ``obj_gap``: the largest ``|f - f_ref| / |f_ref|`` over the call's
  iterations;
* ``dual_gap``: ``|y - y_ref| / |y_ref|`` of the returned dual (the
  warm-up call starts from zero, so there a call that returns its start
  reads 1);
* ``grad_gap``: ``|g - g_ref| / |g_ref|`` of the last gradient.

Norms are Euclidean.  A number that is not finite fails.  A cell compares
the numbers its ``limits`` name, each set between the program's readings and
the least reading of a control (``traffic/<traffic>.json``) that departs from
the program on that number.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

def _ratio(num: float, den: float) -> float:
    if den > 0:
        return num / den
    return 0.0 if num == 0 else float("inf")


def gaps(program, reference) -> Dict[str, float]:
    """The compared numbers of one call; both arguments carry ``start``,
    ``objectives``, ``dual`` and ``gradient`` as float64 arrays."""
    f, f_ref = np.asarray(program.objectives, np.float64), np.asarray(reference.objectives, np.float64)
    if f.shape != f_ref.shape or not np.all(np.isfinite(f)):
        obj = float("inf")
    else:
        obj = float(np.max(np.abs(f - f_ref) / np.maximum(np.abs(f_ref), np.finfo(np.float64).tiny)))
    y, y_ref = np.asarray(program.dual, np.float64), np.asarray(reference.dual, np.float64)
    g, g_ref = np.asarray(program.gradient, np.float64), np.asarray(reference.gradient, np.float64)
    out = {"obj_gap": obj,
           "dual_gap": _ratio(float(np.linalg.norm(y - y_ref)), float(np.linalg.norm(y_ref))),
           "grad_gap": _ratio(float(np.linalg.norm(g - g_ref)), float(np.linalg.norm(g_ref)))}
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in out.items()}


def _json_number(v: float):
    return v if np.isfinite(v) else "inf"


def compare(readings: List[Dict[str, float]], limits: Dict[str, float]) -> dict:
    """``correct``, the number of calls that failed, and the worst reading of
    each number the cell has a limit for, beside that limit."""
    failed = sum(any(not r[k] <= limits[k] for k in limits) for r in readings)
    compared = {k: {"value": _json_number(max(r[k] for r in readings)), "limit": limits[k]} for k in limits}
    return {"correct": failed == 0 and bool(readings), "failed": failed, "compared": compared}
