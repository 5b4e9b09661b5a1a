"""The port's spans, counters and per-iteration device marks, in one store
(``dualip_tpu/utils/profiling.py`` has the traces; the store is the port's).

* ``span(name, **attrs)``: a context manager that records its name, start and
  end (``time.time_ns``, the host clock that ``torch.profiler`` puts its host
  events on), the span it opened inside, the ``maximize`` call it belongs to
  and ``attrs``.  Per name the store keeps ``Aggregate``: count, total ns
  and self ns (total less the spans opened directly inside it), and the last
  record; a bounded list of records (``events``) that ``trace`` writes out
  beside its Chrome trace.  While a ``torch.profiler`` runs, a span also
  opens a profiler range of its name on the host (a record function of the
  category ``cpu_op``: unlike ``record_function``'s user annotations the
  profiler draws no copy of it on the card's timeline), so the profiler's
  host timeline, the clock it aligns the card's records to, shows the
  program's layers.
* ``count(name, n=1)``: a counter, always on (the kernels' wrappers count
  what they enqueue on the card: ``dualip.ops.<wrapper>.enqueued``;
  ``duchi_project`` counts the rows it leaves to torch's ops off the CPU,
  where its kernel does not engage: ``dualip.projections.duchi.torch_rows``).
* ``IterationMarks``: four device marks of each AGD iteration on the card
  (``start``, ``columns``, ``rows``, ``end``), each a one-thread kernel that
  stores the card's timer into a table (a kernel node of the CUDA graph);
  in a traced call's drain ``read`` adds the mean intervals ``columns``,
  ``rows`` and ``step`` of its iterations to the store as
  ``dualip.iter.<interval>``.  An objective sharded over a mesh has a fifth
  mark, ``reduced``, after its ``all_reduce``: the intervals are then
  ``columns``, ``rows``, ``reduce`` (``rows`` to ``reduced``) and ``step``
  (``reduced`` to ``end``).  The objective calls ``mark(point)``; on the
  CPU there are no marks and it does nothing.

Tracing is on after ``enable()``, with ``DUALIP_TRACE=1`` at import, or while
a ``torch.profiler`` runs.  Off, a per-call span is one test and records
nothing; spans opened with ``always=True`` (set-up: ``dualip.build.*``,
``dualip.tile_cache.*``, ``dualip.ops.build``, ``dualip.agd.capture``, and
whatever a caller asked to be timed) record either way.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

MAX_EVENTS = 100_000


@dataclass
class Aggregate:
    """Per name: how many records, their total and self ns, the last one."""

    count: int = 0
    total_ns: int = 0
    self_ns: int = 0
    last: Optional["Span"] = None


@dataclass
class Span:
    """One record.  ``parent`` is the id of the span it opened inside (0 at
    the top); ``call`` the id of the ``maximize`` call it belongs to (0
    outside one); a device interval has ``device=True`` and no parent."""

    name: str
    id: int
    parent: int
    call: int
    start_ns: int
    end_ns: int = 0
    attrs: dict = field(default_factory=dict)
    child_ns: int = 0
    device: bool = False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def as_dict(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent, "call": self.call,
                "start_ns": self.start_ns, "end_ns": self.end_ns, "attrs": dict(self.attrs), "device": self.device}


class Store:
    """The process's spans, counters and device intervals."""

    def __init__(self):
        self.on = os.environ.get("DUALIP_TRACE") == "1"
        self.aggregates: Dict[str, Aggregate] = {}
        self.counters: Dict[str, int] = {}
        self.events: deque = deque(maxlen=MAX_EVENTS)
        self.stack: List[Span] = []
        self.ids = 0
        self.calls = 0
        self.marks: Optional["IterationMarks"] = None  # those of the iteration being built or run

    def _add(self, rec: Span) -> None:
        agg = self.aggregates.get(rec.name)
        if agg is None:
            agg = self.aggregates[rec.name] = Aggregate()
        total = rec.end_ns - rec.start_ns
        agg.count += 1
        agg.total_ns += total
        agg.self_ns += total - rec.child_ns
        agg.last = rec
        self.events.append(rec)

    def open(self, name: str, attrs: dict, new_call: bool) -> Span:
        self.ids += 1
        parent = self.stack[-1] if self.stack else None
        if new_call:
            self.calls += 1
        call = self.calls if new_call else (parent.call if parent is not None else 0)
        rec = Span(name, self.ids, parent.id if parent is not None else 0, call, time.time_ns(), attrs=attrs)
        self.stack.append(rec)
        return rec

    def close(self, rec: Span) -> None:
        rec.end_ns = time.time_ns()
        self.stack.pop()  # spans are context managers: the innermost closes first
        if self.stack:
            self.stack[-1].child_ns += rec.end_ns - rec.start_ns
        self._add(rec)


STORE = Store()


_RANGE = torch._C._profiler._RecordFunctionFast  # a profiler range of category cpu_op


class _Open:
    """An open span: the store's record, and the profiler's range while a
    profiler runs."""

    __slots__ = ("name", "attrs", "new_call", "rec", "rf")

    def __init__(self, name: str, attrs: dict, new_call: bool):
        self.name, self.attrs, self.new_call, self.rf = name, attrs, new_call, None

    def __enter__(self) -> Span:
        self.rec = STORE.open(self.name, self.attrs, self.new_call)
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _RANGE(self.name)
            self.rf.__enter__()
        return self.rec

    def __exit__(self, *exc) -> None:
        if self.rf is not None:
            self.rf.__exit__(*exc)
        STORE.close(self.rec)


_OFF = contextlib.nullcontext()


def is_on() -> bool:
    return STORE.on or _autograd_profiler._is_profiler_enabled


def enable() -> None:
    STORE.on = True


def span(name: str, always: bool = False, new_call: bool = False, **attrs):
    """A span of ``name`` (module docstring); ``with span(...) as rec`` gives
    its ``Span`` (None when it records nothing).  ``always`` records it with
    tracing off; ``new_call`` starts a ``maximize`` call's id."""
    if not (always or STORE.on or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Open(name, attrs, new_call)


def add_span(name: str, start_ns: int, **attrs) -> Span:
    """Record a span of ``name`` that began at ``start_ns`` and ends now,
    inside the span that is open (set-up: always recorded)."""
    rec = STORE.open(name, attrs, False)
    rec.start_ns = start_ns
    STORE.close(rec)
    return rec


def count(name: str, n: int = 1) -> None:
    STORE.counters[name] = STORE.counters.get(name, 0) + n


def counter(name: str) -> int:
    return STORE.counters.get(name, 0)


def aggregate(name: str) -> Optional[Aggregate]:
    return STORE.aggregates.get(name)


def last(name: str) -> Optional[Span]:
    agg = STORE.aggregates.get(name)
    return agg.last if agg is not None else None


def records(name: str) -> List[Span]:
    """The kept records of ``name``, oldest first."""
    return [e for e in STORE.events if e.name == name]


def timed(name: str):
    """Decorator: the function's calls as spans of ``name``, always
    recorded (set-up)."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name, always=True):
                return fn(*args, **kwargs)

        return inner

    return wrap


class IterationMarks:
    """Device marks at four points of each AGD iteration on a CUDA device:
    the start of the step (``start``), after the column layer (the dual's
    scaling and gather or carry-in, the projection and a*x: ``columns``),
    after the row layer (the row sums: ``rows``) and after the iteration's
    last copy (``end``); with ``reduced`` (an objective sharded over a mesh)
    a fifth, ``reduced``, after the evaluation's ``all_reduce``.  Each mark
    is the one-thread kernel of ``ops/marks.py``, which stores the card's
    nanosecond timer into row ``slot`` of a ``(rows, 4)`` table; ``end``
    advances the slot.  A fifth point is stamped into a second such table,
    the lower half of one ``(2 * rows, 4)`` allocation.  A CUDA graph
    captures each mark as one kernel node, so every replay stamps the row of
    its own iteration.  ``reset`` (a traced call's start) zeroes the slot;
    ``read``, in the call's drain, adds the mean intervals of its iterations
    to the store."""

    POINTS = ("start", "columns", "rows", "end")
    INTERVALS = ("columns", "rows", "step")  # between consecutive points
    MESH_POINTS = ("start", "columns", "rows", "reduced", "end")
    MESH_INTERVALS = ("columns", "rows", "reduce", "step")

    def __init__(self, device, rows: int, reduced: bool = False):
        self.points = self.MESH_POINTS if reduced else self.POINTS
        self.intervals = self.MESH_INTERVALS if reduced else self.INTERVALS
        self.rows = max(1, rows)
        tables = -(-len(self.points) // 4)  # the kernel stamps rows of four points
        self.table = torch.zeros((tables * self.rows, 4), dtype=torch.int64, device=device)
        self.slot = torch.zeros((), dtype=torch.int64, device=device)
        self.seen = set()

    @classmethod
    def for_device(cls, device, rows: int, reduced: bool = False) -> Optional["IterationMarks"]:
        """Marks for ``rows`` iterations on ``device``; None (no marks) off
        CUDA."""
        return cls(device, rows, reduced) if torch.device(device).type == "cuda" else None

    def record(self, point: str) -> None:
        from dualip_tpu_torch.ops.marks import stamp

        table, column = divmod(self.points.index(point), 4)
        stamp(self.table[table * self.rows:(table + 1) * self.rows], self.slot, column, point == "end")
        self.seen.add(point)

    def reset(self) -> None:
        self.slot.zero_()

    def read(self, iterations: int) -> Optional[Dict[str, float]]:
        """The mean ms of each interval over the call's ``iterations`` (the
        table's rows up to its size), each added to the store as one record
        of ``dualip.iter.<interval>``; None when a point was never recorded
        (an objective without the column and row marks).  The copy of the
        table waits for the call's work."""
        if not self.seen.issuperset(self.points) or iterations < 1:
            return None
        t = self.table.cpu().numpy()  # one copy: the read costs the traced call little
        t = np.concatenate(np.split(t, len(t) // self.rows), axis=1)[:iterations]  # a row of every point
        out = {}
        for k, name in enumerate(self.intervals):
            ns = int(np.mean(t[:, k + 1] - t[:, k]))
            out[name] = ns * 1e-6
            STORE._add(Span("dualip.iter." + name, 0, 0, STORE.calls, 0, ns, device=True))
        return out


def begin_iteration(marks: Optional[IterationMarks]) -> None:
    """The step starts: ``marks`` (None off CUDA) become the current ones and
    record ``start``."""
    STORE.marks = marks
    if marks is not None:
        marks.record("start")


def mark(point: str) -> None:
    """Record ``point`` on the current iteration's marks, if any."""
    marks = STORE.marks
    if marks is not None:
        marks.record(point)


def end_iteration() -> None:
    """The iteration's last copy is enqueued: record ``end`` and clear."""
    marks, STORE.marks = STORE.marks, None
    if marks is not None:
        marks.record("end")


def _store_dump() -> dict:
    return {"events": [e.as_dict() for e in STORE.events],
            "aggregates": {k: {"count": a.count, "total_ns": a.total_ns, "self_ns": a.self_ns}
                           for k, a in STORE.aggregates.items()},
            "counters": dict(STORE.counters)}


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Record a ``torch.profiler`` trace (CPU activities, and CUDA where a
    card is present) of the block and write it to ``log_dir`` as a Chrome
    trace (``trace_<pid>_<ns>.json``, viewable in Perfetto or
    ``chrome://tracing``), with the store's records, aggregates and counters
    beside it (``spans_<pid>_<ns>.json``); nothing when not ``enabled``.  The
    program's spans show in the trace under their names.

    >>> with trace("traces/solve"):
    ...     solver.maximize(objective, lam0)
    """
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the card's work of the block ends inside the window
    stamp = f"{os.getpid()}_{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stamp}.json"))
    with open(os.path.join(log_dir, f"spans_{stamp}.json"), "w") as f:
        json.dump(_store_dump(), f)
