"""The port's store of spans, counters and device marks
(``dualip_tpu_torch/utils/profiling.py``) and the benchmark's readers of it
(``gpubench/metrics/``), on the CPU; one test on the card (marked ``card``)
holds a CUDA graph with the marks to the eager loop bit for bit."""

import importlib.util
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from dualip_tpu_torch import ComputeArgs, ObjectiveArgs, SolverArgs, build_objective
from dualip_tpu_torch.objectives.matching import MatchingInputArgs, MatchingSolverDualObjectiveFunction
from dualip_tpu_torch.ops import _build
from dualip_tpu_torch.ops import marks as marks_mod
from dualip_tpu_torch.optimizers import agd as agd_mod
from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent
from dualip_tpu_torch.parallel import EntityMesh
from dualip_tpu_torch.projections import create_projection_map
from dualip_tpu_torch.sparse import csc_from_dense
from dualip_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
AGD_SPANS = ["dualip.agd.start", "dualip.agd.replay", "dualip.agd.drain", "dualip.agd.result"]


@pytest.fixture
def store(monkeypatch):
    """A fresh store, tracing off, for the test's length."""
    fresh = profiling.Store()
    fresh.on = False
    monkeypatch.setattr(profiling, "STORE", fresh)
    return fresh


def _problem(m=6, n=300, seed=0):
    rng = np.random.default_rng(seed)
    a = ((rng.random((m, n)) < 0.3) * rng.random((m, n))).astype(np.float32)
    return MatchingInputArgs(A=csc_from_dense(a), c=csc_from_dense(-a),
                             projection_map=create_projection_map("simplex", {"z": 1}, n),
                             b_vec=np.full(m, 3.0, np.float32))


def _objective(layout, device="cpu", **kw):
    solver_args = SolverArgs(max_iter=5, gamma=1e-3)
    return build_objective(_problem(), solver_args, ComputeArgs(host_device=device),
                           ObjectiveArgs(objective_type="matching", objective_kwargs={"layout": layout, **kw}))


def _solver(max_iter=9, **kw):
    return AcceleratedGradientDescent(max_iter=max_iter, gamma=1e-3, initial_step_size=1e-3, max_step_size=1e-1, **kw)


def test_spans_nest_and_keep_self_time(store):
    profiling.enable()
    with profiling.span("outer", k=1) as outer:
        time.sleep(0.002)
        with profiling.span("inner") as inner:
            time.sleep(0.002)
        with profiling.span("inner"):
            pass
    assert inner.parent == outer.id and outer.parent == 0 and outer.attrs == {"k": 1}
    agg_o, agg_i = profiling.aggregate("outer"), profiling.aggregate("inner")
    assert (agg_o.count, agg_i.count) == (1, 2)
    assert agg_o.total_ns == outer.end_ns - outer.start_ns >= 4_000_000
    assert agg_o.self_ns == agg_o.total_ns - agg_i.total_ns >= 2_000_000
    assert agg_i.self_ns == agg_i.total_ns
    assert [e.name for e in profiling.STORE.events] == ["inner", "inner", "outer"]
    assert profiling.last("inner") is profiling.STORE.events[1]


def test_counters(store):
    profiling.count("a.x")
    profiling.count("a.x", 4)
    profiling.count("b")
    assert (profiling.counter("a.x"), profiling.counter("b"), profiling.counter("never")) == (5, 1, 0)
    assert not profiling.STORE.events  # a counter keeps no record


def test_off_records_nothing_but_set_up(store):
    assert not profiling.is_on()
    with profiling.span("per.call") as rec:
        assert rec is None
    profiling.count("still.counts")
    with profiling.span("set.up", always=True) as rec:
        assert rec is not None
    assert [e.name for e in profiling.STORE.events] == ["set.up"]
    assert profiling.aggregate("per.call") is None and profiling.counter("still.counts") == 1
    _solver().maximize(_objective("csc"), torch.zeros(6))
    assert not any(e.name.startswith("dualip.agd.") for e in profiling.STORE.events)
    assert {"dualip.build", "dualip.build.tiles", "dualip.build.rows"} <= set(profiling.STORE.aggregates)


def test_trace_env_switches_it_on_at_import():
    code = "from dualip_tpu_torch.utils import profiling; print(profiling.is_on())"
    env = dict(os.environ, DUALIP_TRACE="1", PYTHONPATH=str(ROOT))
    done = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert done.stdout.strip().splitlines()[-1] == "True", done.stderr[-2000:]


def test_span_shares_the_profiler_clock(store):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.is_on()
        for i in range(3):  # the first record_function of a process is slower to open
            with profiling.span(f"dualip.test.clock{i}") as rec:
                torch.ones(4).sum()
    assert not profiling.is_on()
    starts = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()}
    assert abs(starts["dualip.test.clock2"] - rec.start_ns) < 1_000_000


@pytest.mark.parametrize("launch_chunk", [0, 4])
def test_maximize_emits_its_spans(store, launch_chunk):
    """A traced call: start, one replay a chunk (the sizes ``chunk_walls``
    has), drain and result inside its ``maximize``, all under one call id."""
    obj = _objective("csc")
    solver = _solver(launch_chunk=launch_chunk)
    solver.collect_chunk_walls = True
    profiling.enable()
    solver.maximize(obj, torch.zeros(6))
    (call,) = profiling.records("dualip.agd.maximize")
    inside = [e for e in profiling.STORE.events if e.parent == call.id]
    names = [e.name for e in inside]
    assert names[0] == AGD_SPANS[0] and names[-2:] == AGD_SPANS[2:] and set(names[1:-2]) == {AGD_SPANS[1]}
    sizes = [e.attrs["size"] for e in inside if e.name == "dualip.agd.replay"]
    assert sizes == [s for s, _ in solver.chunk_walls] == ([4, 4, 1] if launch_chunk else [9])
    assert [w for _, w in solver.chunk_walls] == [e.seconds for e in inside if e.name == "dualip.agd.replay"]
    assert {e.call for e in inside} == {call.call} and call.call == profiling.STORE.calls
    assert profiling.counter("dualip.agd.eager_iterations") == 9


def test_collect_stats_and_chunk_walls_record_with_tracing_off(store):
    solver = _solver(launch_chunk=3)
    solver.collect_stats = solver.collect_chunk_walls = True
    solver.maximize(_objective("csc"), torch.zeros(6))
    (call,), (drain,) = profiling.records("dualip.agd.maximize"), profiling.records("dualip.agd.drain")
    assert solver.last_run_stats == {"total_s": (drain.end_ns - call.start_ns) * 1e-9, "iters": 9,
                                     "drain_s": drain.seconds}
    assert len(profiling.records("dualip.agd.replay")) == 3 and not profiling.records("dualip.agd.start")


@pytest.mark.parametrize("layout,kw,rows_inside", [
    ("csc", {}, []), ("csc", {"use_pallas": True, "pallas_block_k": 128}, []),
    ("butterfly", {}, ["dualip.build.route"]),
])
def test_build_spans_fire(store, layout, kw, rows_inside):
    _objective(layout, **kw)
    (build,) = profiling.records("dualip.build")
    children = {e.name for e in profiling.STORE.events if e.parent == build.id}
    assert {"dualip.build.tiles", "dualip.build.rows", "dualip.build.upload"} <= children
    (rows,) = profiling.records("dualip.build.rows")
    assert [e.name for e in profiling.STORE.events if e.parent == rows.id] == rows_inside
    tiles = profiling.records("dualip.build.tiles")
    assert len(tiles) == (2 if kw.get("use_pallas") else 1)  # the transpose is tile work too


def test_ops_build_span(store):
    _build.build([])
    assert profiling.aggregate("dualip.ops.build").count == 1
    assert profiling.counter("dualip.ops.compiled") == 0


def test_marks_are_no_ops_on_the_cpu(store):
    assert profiling.IterationMarks.for_device("cpu", 8) is None
    profiling.begin_iteration(None)
    profiling.mark("columns")
    profiling.end_iteration()
    profiling.enable()
    for layout in ("csc", "butterfly"):
        _solver().maximize(_objective(layout), torch.zeros(6))
    assert not [k for k in profiling.STORE.aggregates if k.startswith("dualip.iter.")]
    assert profiling.STORE.marks is None


def _fake_stamp(table, slot, point, advance):
    """The mark kernel's stand-in on CPU tensors: the host clock's ns."""
    table[int(slot) % table.shape[0], point] = time.perf_counter_ns()
    if advance:
        slot += 1


def _emulated_capture(self):
    self.graph = types.SimpleNamespace(replay=self._advance)


@pytest.mark.parametrize("layout", ["csc", "butterfly"])
def test_marks_order_and_graph_counters(store, monkeypatch, layout):
    """The marks' four points in order in every iteration, the eager loop
    and the graph's (its capture emulated on the CPU), each iteration's row
    of the table stamped, three mean intervals read per traced call; the
    counters of a capture and a reuse."""
    monkeypatch.setattr(marks_mod, "stamp", _fake_stamp)
    monkeypatch.setattr(profiling.IterationMarks, "for_device", classmethod(lambda cls, dev, rows: cls(dev, rows)))
    monkeypatch.setattr(agd_mod._Graph, "_capture", _emulated_capture)
    seen = []
    real = profiling.IterationMarks.record
    monkeypatch.setattr(profiling.IterationMarks, "record", lambda self, p: (seen.append(p), real(self, p)))
    obj, solver = _objective(layout), _solver(max_iter=4)
    eager = solver._maximize(obj, torch.zeros(6), 0, None, graph=False)
    assert seen == list(profiling.IterationMarks.POINTS) * 4
    assert profiling.aggregate("dualip.iter.columns") is None  # tracing off: never read
    profiling.enable()
    seen.clear()
    first = solver._maximize(obj, torch.zeros(6), 0, None, graph=True)
    again = solver._maximize(obj, torch.zeros(6), 0, None, graph=True)
    assert seen == list(profiling.IterationMarks.POINTS) * 8
    assert first.dual_objective_log == again.dual_objective_log == eager.dual_objective_log
    assert {k: profiling.counter(f"dualip.agd.{k}") for k in ("captures", "graph_reuse", "replays")} == \
        {"captures": 1, "graph_reuse": 1, "replays": 7}
    assert profiling.counter("dualip.agd.eager_iterations") == 4 + 1
    assert len(profiling.records("dualip.agd.capture")) == 1
    for name in ("columns", "rows", "step"):
        agg = profiling.aggregate("dualip.iter." + name)
        assert agg.count == 2 and agg.total_ns >= 0
    table = solver._jit_cache[next(iter(solver._jit_cache))].marks.table
    assert bool((table[:, 1:] >= table[:, :-1]).all()) and int(table.min()) > 0  # every row, in order


def _mesh_of_one(monkeypatch) -> EntityMesh:
    """A mesh of one rank on the CPU with no process group: its all_reduce
    the identity, its backend NCCL's name (so a capture names it)."""
    monkeypatch.setattr(EntityMesh, "all_reduce_", lambda self, t: t)
    monkeypatch.setattr(EntityMesh, "backend", lambda self: "nccl")
    return EntityMesh(group=None, rank=0, world_size=1, device=torch.device("cpu"))


@pytest.mark.parametrize("sharded", [False, True], ids=["one device", "mesh"])
def test_a_mesh_adds_the_reduced_mark(store, monkeypatch, sharded):
    """On a mesh each iteration stamps five points, ``reduced`` after the
    evaluation's all_reduce, the fifth into a second table of four, and a
    traced call reads four intervals (``reduce`` between ``rows`` and
    ``reduced``); without one, four points into one table and three
    intervals, as before the mesh had a mark."""
    monkeypatch.setattr(marks_mod, "stamp", _fake_stamp)
    monkeypatch.setattr(profiling.IterationMarks, "for_device",
                        classmethod(lambda cls, dev, rows, reduced=False: cls(dev, rows, reduced)))
    monkeypatch.setattr(agd_mod._Graph, "_capture", _emulated_capture)
    seen = []
    real = profiling.IterationMarks.record
    monkeypatch.setattr(profiling.IterationMarks, "record", lambda self, p: (seen.append(p), real(self, p)))
    where = {"mesh": _mesh_of_one(monkeypatch)} if sharded else {"device": "cpu"}
    obj = MatchingSolverDualObjectiveFunction(_problem(), gamma=1e-3, use_pallas=True, pallas_block_k=8, **where)
    profiling.enable()
    solver = _solver(max_iter=4)
    for graph in (False, True):
        solver._maximize(obj, torch.zeros(6), 0, None, graph=graph)
    points = profiling.IterationMarks.MESH_POINTS if sharded else profiling.IterationMarks.POINTS
    assert len(points) == (5 if sharded else 4) and seen == list(points) * 8
    intervals = ["columns", "rows", "reduce", "step"] if sharded else ["columns", "rows", "step"]
    assert sorted(k for k in profiling.STORE.aggregates if k.startswith("dualip.iter.")) == \
        sorted("dualip.iter." + k for k in intervals)
    for k in intervals:
        assert profiling.aggregate("dualip.iter." + k).count == 2
    table = solver._jit_cache[next(iter(solver._jit_cache))].marks.table
    assert tuple(table.shape) == ((8, 4) if sharded else (4, 4))
    stamped = np.concatenate(np.split(table.numpy(), len(table) // 4, axis=0), axis=1)[:, :len(points)]
    assert (stamped[:, 1:] >= stamped[:, :-1]).all() and stamped.min() > 0


def test_marks_read_each_point_from_its_table(store, monkeypatch):
    """The mean intervals between consecutive points, the fifth point read
    from the second table: the stamps of three iterations by hand."""
    clock = [0]

    def stamp(table, slot, point, advance):
        table[int(slot) % table.shape[0], point] = clock[0]
        if advance:
            slot += 1

    monkeypatch.setattr(marks_mod, "stamp", stamp)
    marks = profiling.IterationMarks("cpu", 3, reduced=True)
    steps = {"start": 1000, "columns": 4000, "rows": 2000, "reduced": 30, "end": 100}
    for it in range(3):
        for point in marks.points:
            clock[0] += steps[point] * (it + 1)
            marks.record(point)
    got = marks.read(3)
    assert got == pytest.approx({"columns": 8e-3, "rows": 4e-3, "reduce": 6e-5, "step": 2e-4})
    assert profiling.aggregate("dualip.iter.reduce").total_ns == 60
    assert profiling.IterationMarks("cpu", 3).read(3) is None  # no point recorded


def test_layer_reduce_ms_reads_the_mean_reduce_interval(store):
    for ms in (0.02, 0.04):
        _fill(profiling.STORE, "dualip.iter.reduce", 0, ms)
    assert _reader("layer_reduce_ms")(None) == pytest.approx(0.03)


def _reader(name):
    path = ROOT / "gpubench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"test_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    spec.loader.exec_module(mod)
    return mod.read


def _fill(s, name, start_ms, end_ms, parent=0):
    s.ids += 1
    rec = profiling.Span(name, s.ids, parent, 0, int(start_ms * 1e6), int(end_ms * 1e6))
    s._add(rec)
    return rec


def test_readers_from_a_hand_filled_store(store):
    s = profiling.STORE
    for t0, host in ((0.0, 3.0), (20.0, 1.0)):  # two calls of 10 ms, 7 and 9 of them waits
        call = _fill(s, "dualip.agd.maximize", t0, t0 + 10)
        _fill(s, "dualip.agd.start", t0, t0 + 1, call.id)
        _fill(s, "dualip.agd.replay", t0 + 1, t0 + 2, call.id)
        _fill(s, "dualip.agd.replay", t0 + 2, t0 + 3, call.id)
        _fill(s, "dualip.agd.drain", t0 + 3, t0 + 10 - host + 1, call.id)
        _fill(s, "dualip.agd.result", t0 + 10 - host + 1, t0 + 10, call.id)
    _fill(s, "dualip.agd.drain", 50, 60)  # outside a call: not subtracted
    for name, ms in (("columns", (3.0, 4.0)), ("rows", (2.0, 2.5)), ("step", (0.1, 0.2))):
        for v in ms:
            _fill(s, "dualip.iter." + name, 0, v)
    _fill(s, "dualip.build.tiles", 0, 1500)
    _fill(s, "dualip.build.tiles", 0, 500)
    _fill(s, "dualip.build.rows", 0, 2500)
    got = {n: _reader(n)(None) for n in ("call_host_ms", "layer_columns_ms", "layer_rows_ms", "layer_step_ms",
                                         "build_tiles_s", "build_rows_s")}
    assert got == pytest.approx({"call_host_ms": 2.0, "layer_columns_ms": 3.5, "layer_rows_ms": 2.25,
                                 "layer_step_ms": 0.15, "build_tiles_s": 2.0, "build_rows_s": 2.5})


@pytest.mark.parametrize("name", ["call_host_ms", "layer_columns_ms", "build_rows_s", "layer_reduce_ms"])
def test_readers_find_nothing_in_an_empty_store(store, monkeypatch, name):
    assert _reader(name)(None) is None
    monkeypatch.delattr(profiling, "STORE")  # a program without the store
    assert _reader(name)(None) is None


@pytest.mark.card
@pytest.mark.parametrize("layout,kw", [("csc", {"use_pallas": True}), ("butterfly", {}), ("csc", {})])
def test_graph_with_marks_replays_the_eager_loop_bit_for_bit(store, layout, kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    obj = _objective(layout, device="cuda", **kw)
    x0 = torch.zeros(6, device="cuda")
    solver = _solver(max_iter=12)
    eager = solver._maximize_eager(obj, x0)
    profiling.enable()
    graph = [solver.maximize(obj, x0) for _ in range(2)]
    assert profiling.counter("dualip.agd.captures") == 1 and profiling.counter("dualip.agd.graph_reuse") == 1
    for g in graph:
        assert g.dual_objective_log == eager.dual_objective_log
        assert torch.equal(g.dual_val, eager.dual_val)
    for name in ("columns", "rows", "step"):
        agg = profiling.aggregate("dualip.iter." + name)
        assert agg.count == 2 and agg.total_ns > 0  # one sample a traced call
