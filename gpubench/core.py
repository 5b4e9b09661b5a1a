"""One run of one cell of the benchmark.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix; everything else is found by name in files:

* ``configs/<config>.json`` (the file the configuration's entry names): the
  deployment's sizes, solver settings, projection and the generator module
  ``generators/<generator>.py`` that makes its data on the device from a seed;
* ``traffic/<traffic>.json``: the path through the program (the objective's
  keyword arguments), the CUDA sources that path loads, and the controls that
  the check must reject;
* ``cells/<workload>.json``: iterations per ``maximize`` call, the calls of
  the traced window, and the limit of each compared number;
* ``metrics/<metric>.py``: one reader per metric of ``BENCHMARK.json``.

A run: the inputs are generated on the device and handed to the program as
host CSC arrays, the form ``run_solver`` takes; the objective is built by
``build_objective``; one warm-up ``maximize`` (iteration 1 eagerly, the CUDA
graph's capture, replays) ends set-up; the window then calls ``maximize``
again and again, each call continuing from the last call's dual, until
``--seconds`` have passed (with ``--trace 1``: a fixed number of calls under
``torch.profiler``).  Afterwards the program's state is freed and the plain
reference (``reference/matching.py``) follows the checked calls (the warm-up
call, one window call drawn from the seed, the last) from their starts in
float64.

A cell of ``chips`` N > 1 runs the same steps on N ranks, one process a card
(``ranks.py``), through the program's sharded entry: each rank generates its
part of the problem (``generate_part``, else rank 0 the whole), the parts are
joined once into host arrays in shared memory, and every rank hands the whole
problem to ``build_objective`` with ``compute_device_num=N``.  The window is a
number of calls fixed before it (from one timed call, or ``trace_calls``) and
made by every rank; rank 0 keeps the clock, the trace and the result line.
The reference is sharded the same way: each rank follows the checked calls
over its own range of columns, one float64 sum over the ranks an evaluation.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import random
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, List, Optional

import numpy as np
import torch

from gpubench import check, faults, ranks
from gpubench.reference.matching import MatchingReference

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dualip_tpu")  # top-level module names, compared whole
RANK_TIMEOUT_S = 1100.0  # a rank of a multi-card run still running this long after its start has hung


class Refused(Exception):
    """The run cannot be measured here: no card, or fewer than the cell asks for."""


def log(**fields) -> None:
    """One progress line on standard error (the result's checks end it)."""
    print("[gpubench] " + " ".join(f"{k}={v}" for k, v in fields.items()), file=sys.stderr, flush=True)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def process_age_s() -> Optional[float]:
    """Seconds since this process started, from ``/proc`` (None elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


class Cell:
    """Everything one run of workload ``name`` reads, found by name."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root, self.bench = Path(root), Path(root) / "gpubench"
        spec = load_json(self.root / "BENCHMARK.json")
        entries = {w["name"]: w for w in spec["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(entries)})")
        self.name, entry = name, entries[name]
        self.chips = int(entry["chips"])
        config_entry = {c["name"]: c for c in spec["configs"]}[entry["config"]]
        self.config = load_json(self.root / config_entry["file"])
        self.traffic = load_json(self.bench / "traffic" / f"{entry['traffic']}.json")
        self.params = load_json(self.bench / "cells" / f"{name}.json")

        def mine(metrics):
            return [m for m in metrics if name in m.get("workloads", [name])]

        self.end_to_end, self.per_layer = mine(spec["end_to_end"]), mine(spec["per_layer"])

    def generator(self):
        return load_module(self.bench / "generators" / f"{self.config['generator']}.py",
                           f"gpubench_generator_{self.config['generator']}")

    def reader(self, metric: str):
        return load_module(self.bench / "metrics" / f"{metric}.py", f"gpubench_metric_{metric}")

    @property
    def iterations_per_call(self) -> int:
        return int(self.params["iterations_per_call"])


class Inputs(SimpleNamespace):
    """The generated problem as host arrays, read-only: the program and the
    reference both read these."""

    @property
    def problem(self) -> dict:
        return {"m": self.m, "n": self.n, "nnz": self.nnz}


def make_inputs(cell: Cell, seed: int, device) -> Inputs:
    arrays = cell.generator().generate(cell.config["data"], seed, device)
    host = {}
    for key, t in arrays.items():
        host[key] = t.cpu().numpy()
        host[key].flags.writeable = False
    del arrays
    return Inputs(**host, m=int(host["b"].shape[0]), n=int(host["indptr"].shape[0]) - 1,
                  nnz=int(host["rows"].shape[0]))


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def solver_args(cell: Cell):
    from dualip_tpu_torch import SolverArgs

    s = cell.config["solver"]
    return SolverArgs(max_iter=cell.iterations_per_call, gamma=float(s["gamma"]),
                      initial_step_size=float(s["initial_step_size"]), max_step_size=float(s["max_step_size"]))


def make_solver(cell: Cell):
    """The maximizer, configured as ``run_solver`` configures it."""
    from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent

    sa = solver_args(cell)
    return AcceleratedGradientDescent(
        initial_step_size=sa.initial_step_size, max_iter=sa.max_iter, max_step_size=sa.max_step_size,
        gamma=sa.gamma, gamma_decay_type=sa.gamma_decay_type, gamma_decay_params=sa.gamma_decay_params,
        save_primal=sa.save_primal, restart=sa.restart, restart_min_spacing=sa.restart_min_spacing,
        launch_chunk=sa.launch_chunk)


def build_program(cell: Cell, inputs: Inputs, device, objective_kwargs: dict, world: int = 1):
    """(objective, solver, build_s): the objective through ``build_objective``
    and the maximizer of ``make_solver``; with ``world`` > 1 this rank's part
    of the sharded objective (``run_solver``'s contract: every rank passes
    the whole problem)."""
    from dualip_tpu_torch import ComputeArgs, ObjectiveArgs, build_objective
    from dualip_tpu_torch.objectives.matching import MatchingInputArgs
    from dualip_tpu_torch.projections import create_projection_map
    from dualip_tpu_torch.sparse import csc_from_arrays

    proj = cell.config["projection"]
    shape = (inputs.m, inputs.n)
    args = MatchingInputArgs(
        A=csc_from_arrays(inputs.indptr, inputs.rows, inputs.a, shape),
        c=csc_from_arrays(inputs.indptr, inputs.rows, inputs.c, shape),
        projection_map=create_projection_map(proj["kind"], {"z": float(proj["radius"])}, inputs.n,
                                             indices=np.arange(inputs.n)),
        b_vec=inputs.b, equality_mask=None)
    t0 = time.perf_counter()
    compute = (ComputeArgs(host_device=str(device)) if world == 1
               else ComputeArgs(host_device=torch.device(device).type, compute_device_num=world))
    objective = build_objective(args, solver_args(cell), compute,
                                ObjectiveArgs(objective_type="matching", objective_kwargs=dict(objective_kwargs)))
    synchronize(device)
    return objective, make_solver(cell), time.perf_counter() - t0


class Call(SimpleNamespace):
    """One ``maximize`` call: its start and what it returned."""


class ProgramRunner:
    """The program's timed path: ``maximize`` from a start."""

    def __init__(self, objective, solver):
        self.objective, self.solver = objective, solver

    def __call__(self, start) -> Call:
        res = self.solver.maximize(self.objective, start)
        return Call(start=start, objectives=res.dual_objective_log, dual=res.dual_val,
                    gradient=res.objective_result.dual_gradient)


class ReferenceRunner:
    """The reference as a runner: the check's float64 reference, or the
    bfloat16 control in the program's place."""

    def __init__(self, reference: MatchingReference, cell: Cell):
        self.reference, self.cell = reference, cell

    def __call__(self, start) -> Call:
        s = self.cell.config["solver"]
        r = self.reference.agd_call(start, self.cell.iterations_per_call, float(s["initial_step_size"]),
                                    float(s["max_step_size"]))
        return Call(start=start, objectives=r.objectives, dual=r.dual, gradient=r.gradient)


class Window(SimpleNamespace):
    """A window's calls: how many, one drawn from the seed among all but the
    last (``picked``, None for a window of one call), and the last."""


def run_calls(runner: Callable, start, seed: int, seconds: Optional[float] = None, calls: Optional[int] = None,
              device="cuda") -> Window:
    """Calls chained from ``start`` until ``seconds`` have passed or ``calls``
    were made.  Only the drawn call and the last are kept (a reservoir of one
    over the calls before the last), so the window holds no growing set of
    the program's results; ``seconds`` runs from the first call's start to
    the device's end of the last."""
    draw = random.Random(seed)
    count, picked, last = 0, None, None
    t0 = time.perf_counter()
    while True:
        call = runner(start)
        if last is not None and draw.randrange(count) == 0:
            picked = last
        count, last, start = count + 1, call, call.dual
        if (calls is not None and count >= calls) or (seconds is not None and time.perf_counter() - t0 >= seconds):
            break
    synchronize(device)
    return Window(count=count, picked=picked, last=last, seconds=time.perf_counter() - t0)


def to_host(call: Call) -> Call:
    def host(t):
        return np.asarray(t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else t, dtype=np.float64)

    return Call(start=host(call.start), objectives=np.asarray(call.objectives, dtype=np.float64),
                dual=host(call.dual), gradient=host(call.gradient))


def checked_calls(warmup: Call, window: Window) -> List[tuple]:
    """(label, call): the start (the warm-up call, from zero), the window's
    call drawn from the seed, and its last call."""
    out = [("warm-up", warmup)]
    if window.picked is not None:
        out.append(("drawn", window.picked))
    return out + [("last", window.last)]


def free_device(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def reference_for(cell: Cell, inputs: Inputs, device, dtype=torch.float64, shard=None) -> MatchingReference:
    """The plain reference of the whole problem, or with ``shard`` (a
    ``ranks.Rank``) of the rank's columns, its sums over the ranks."""
    proj = cell.config["projection"]
    if proj["kind"] != "simplex":
        raise ValueError(f"the reference projects onto simplex sets, not {proj['kind']!r}")
    csc, reduce = (inputs.indptr, inputs.rows, inputs.a, inputs.c), None
    if shard is not None:
        lo, hi = shard.rank * inputs.n // shard.world, (shard.rank + 1) * inputs.n // shard.world
        indptr = inputs.indptr[lo:hi + 1]
        first, last = int(indptr[0]), int(indptr[-1])
        csc = (indptr - first, inputs.rows[first:last], inputs.a[first:last], inputs.c[first:last])
        reduce = shard.sum_float64
    return MatchingReference(*csc, inputs.b, gamma=float(cell.config["solver"]["gamma"]),
                             radius=float(proj["radius"]), tol=float(proj["tol"]), dtype=dtype, device=device,
                             reduce=reduce)


def control_runner(cell: Cell, inputs: Inputs, device, spec: dict, shard=None):
    """(runner, build_s): the control ``spec`` (a traffic's ``controls``
    entry, or ``{"kind": "reference", "dtype": ...}``) in the program's place;
    with ``shard``, this rank's part of it."""
    t0 = time.perf_counter()
    if spec["kind"] == "program":
        objective, solver, build_s = build_program(cell, inputs, device, spec["objective_kwargs"],
                                                   world=shard.world if shard is not None else 1)
        return ProgramRunner(objective, solver), build_s
    if spec["kind"] == "reference":
        reference = reference_for(cell, inputs, device, dtype=getattr(torch, spec["dtype"]), shard=shard)
        return ReferenceRunner(reference, cell), time.perf_counter() - t0
    raise ValueError(f"unknown control kind {spec['kind']!r}")


def worst_objective(program: Call, reference: Call) -> dict:
    """Where ``obj_gap`` is read: the iteration, and both sides' objective
    there (a relative gap swells where the objective nears zero)."""
    f, f_ref = program.objectives, reference.objectives
    if f.shape != f_ref.shape or not f.size:
        return {"obj_worst_at": "none"}
    i = int(np.argmax(np.abs(f - f_ref) / np.maximum(np.abs(f_ref), np.finfo(np.float64).tiny)))
    return {"obj_worst_at": i, "obj_there": repr(float(f[i])), "obj_ref_there": repr(float(f_ref[i]))}


def judge(cell: Cell, inputs: Inputs, calls: List[tuple], device, shard=None) -> dict:
    """The reference follows each checked call from its start; returns the
    comparison (``check.compare``) against the cell's limits.  With
    ``shard`` every rank follows the calls over its columns."""
    reference = reference_for(cell, inputs, device, shard=shard)
    runner = ReferenceRunner(reference, cell)
    readings = []
    for label, c in calls:
        ref = to_host(runner(torch.as_tensor(c.start)))
        readings.append(check.gaps(c, ref))
        if shard is None or shard.rank == 0:
            log(phase="checked", call=label, start_sum=repr(float(c.start.sum())),
                dual_sum=repr(float(c.dual.sum())), **{k: "%.3e" % v for k, v in readings[-1].items()},
                **worst_objective(c, ref))
    del reference, runner
    free_device(device)
    return check.compare(readings, cell.params["limits"])


def device_info(device, chips: int, peak_bytes: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": peak_bytes}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": peak_bytes}
    try:
        out = subprocess.run(["nvidia-smi", "-i", ",".join(map(str, range(chips))), "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        info["power_limit"] = " / ".join(out.stdout.split("\n")).strip(" /") or "not read"
    except (OSError, subprocess.TimeoutExpired):
        info["power_limit"] = "not read"
    return info


def read_metrics(cell: Cell, metrics: List[dict], ctx) -> dict:
    out = {}
    for m in metrics:
        value = cell.reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def prepare_device(cell: Cell, dev) -> None:
    """Refuses a host with fewer cards than the cell asks for; builds the
    CUDA sources its path loads (before any rank starts, so ranks never race
    on the build directory)."""
    if dev.type != "cuda":
        return
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        raise Refused(f"{cell.name} needs {cell.chips} CUDA device(s); found "
                      f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    from dualip_tpu_torch.ops import _build

    t = time.perf_counter()
    _build.build(cell.traffic["kernel_sources"])
    log(phase="kernels", seconds=round(time.perf_counter() - t, 3), sources=",".join(cell.traffic["kernel_sources"]))


def run(name: str, seed: int, seconds: float, trace: bool, device="cuda", root: Path = ROOT,
        from_process_start: bool = False, calls: Optional[int] = None, iterations: Optional[int] = None,
        control: Optional[dict] = None, fault: Optional[str] = None, rank_timeout_s: float = RANK_TIMEOUT_S,
        keep_checked: bool = False) -> dict:
    """One run; returns the result line's object.  ``setup_s`` counts from
    the process's start with ``from_process_start`` (the command), else from
    this call.  ``control`` (a control's spec, ``control_runner``) puts
    something else in the program's place; ``fault`` plants a fault of
    ``faults.py`` (in every rank); ``calls`` makes an untraced window of that
    many calls instead of ``seconds``; ``iterations`` sets the calls' length
    in place of the cell's (probes of ``control.py``, never a benchmark run).
    A cell of more than one chip runs on that many ranks (``run_ranks``),
    each bounded by ``rank_timeout_s``.  ``keep_checked`` adds ``checked``,
    the checked calls' duals by label (the tests')."""
    t0 = time.perf_counter()
    cell = Cell(name, root)
    if cell.chips > 1:
        return run_ranks(cell, seed, seconds, trace, device, from_process_start, calls, iterations, control, fault,
                         rank_timeout_s, keep_checked, t0)
    if fault is not None:
        with faults.planted(fault):
            return run(name, seed, seconds, trace, device, root, from_process_start, calls, iterations, control,
                       keep_checked=keep_checked)
    if iterations is not None:
        cell.params = dict(cell.params, iterations_per_call=int(iterations))
    dev = torch.device(device)
    prepare_device(cell, dev)
    t = time.perf_counter()
    inputs = make_inputs(cell, seed, dev)
    log(phase="inputs", seconds=round(time.perf_counter() - t, 3), m=inputs.m, n=inputs.n, nnz=inputs.nnz,
        b_sum=repr(float(inputs.b.astype(np.float64).sum())))
    free_device(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    if control is None:
        objective, solver, build_s = build_program(cell, inputs, dev, cell.traffic["objective_kwargs"])
        runner = ProgramRunner(objective, solver)
        del objective, solver
    else:
        runner, build_s = control_runner(cell, inputs, dev, control)
    log(phase="build", seconds=round(build_s, 3))
    zero = torch.zeros(inputs.m, dtype=torch.float32, device=dev)
    warmup = run_calls(runner, zero, seed, calls=1, device=dev)
    log(phase="warm-up", seconds=round(warmup.seconds, 3))
    warmup = warmup.last
    age = process_age_s() if from_process_start else None
    setup_s = age if age is not None else time.perf_counter() - t0

    traced = None
    if trace:
        from gpubench import tracing

        window, traced = tracing.traced_window(
            lambda: run_calls(runner, warmup.dual, seed, calls=int(cell.params["trace_calls"]), device=dev), dev)
        window_s = traced.window_s
        log(phase="trace", attempts=traced.attempts, lost_records=traced.lost_records, records=len(traced.records),
            busy_s=traced.busy_s, window_s=traced.window_s)
    else:
        window = run_calls(runner, warmup.dual, seed, seconds=None if calls else seconds, calls=calls, device=dev)
        window_s = window.seconds
    peak = int(torch.cuda.max_memory_allocated()) if dev.type == "cuda" else 0
    iterations = window.count * cell.iterations_per_call

    log(phase="window", seconds=round(window_s, 3), calls=window.count, iterations=iterations, peak_bytes=peak,
        setup_s=round(setup_s, 3))
    picked = [(label, to_host(c)) for label, c in checked_calls(warmup, window)]
    attempted = window.count
    del runner, window, warmup, zero
    free_device(dev)
    t = time.perf_counter()
    verdict = judge(cell, inputs, picked, dev)
    log(phase="reference", seconds=round(time.perf_counter() - t, 3), checked=len(picked))

    ctx = SimpleNamespace(cell=cell, problem=inputs.problem, setup_s=setup_s, build_s=build_s, window_s=window_s,
                          iterations=iterations, calls=attempted, peak_bytes=peak, trace=traced,
                          device_kind=torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                          peaks=load_json(cell.bench / "peaks.json"))
    result = {"correct": verdict["correct"], "attempted": attempted, "failed": verdict["failed"],
              "metrics": read_metrics(cell, cell.per_layer if trace else cell.end_to_end, ctx),
              "device": device_info(dev, cell.chips, peak)}
    if traced is not None:
        result["device"].update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = traced.breakdown
    if keep_checked:
        result["checked"] = {label: c.dual for label, c in picked}
    result["compared"] = verdict["compared"]
    return result


def run_ranks(cell: Cell, seed: int, seconds: float, trace: bool, device, from_process_start: bool,
              calls: Optional[int], iterations: Optional[int], control: Optional[dict], fault: Optional[str],
              timeout_s: float, keep_checked: bool, t0: float) -> dict:
    """A multi-card run: the kernels built here, then ``cell.chips`` ranks of
    ``rank_run``; rank 0's result."""
    dev = torch.device(device)
    prepare_device(cell, dev)
    if fault is not None and fault not in faults.ALL:
        raise ValueError(f"no fault {fault!r} (has {sorted(faults.ALL)})")
    age = process_age_s() if from_process_start else None
    spec = {"name": cell.name, "root": str(cell.root), "seed": int(seed), "seconds": float(seconds),
            "trace": bool(trace), "calls": calls, "iterations": iterations, "control": control, "fault": fault,
            "keep_checked": keep_checked,
            "start_wall": time.time() - (age if age is not None else time.perf_counter() - t0)}
    return ranks.launch("gpubench.core:rank_run", spec, cell.chips, dev.type, timeout_s)


def shared_inputs(cell: Cell, seed: int, rank) -> Inputs:
    """The generated problem as read-only host arrays in the ranks' shared
    memory, written once: each rank writes its part where the generator has
    ``generate_part`` (rank r the r-th range of columns, on its own card;
    the parts' fixed-point loads summed exactly, then ``budget``), else rank
    0 writes what ``generate`` made on its card."""
    gen, params, dev = cell.generator(), cell.config["data"], rank.device
    if hasattr(gen, "generate_part"):
        part = gen.generate_part(params, seed, dev, rank.rank, rank.world)
        load = rank.sum_(part.pop("load").cpu())
        if rank.rank == 0:
            part["b"] = gen.budget(params, load, dev)
    else:
        part = gen.generate(params, seed, dev) if rank.rank == 0 else {}
    shapes = rank.gather({k: (int(t.shape[0]), str(t.dtype).split(".")[-1]) for k, t in part.items()})
    cols = [s["indptr"][0] - 1 if s else 0 for s in shapes]
    nnzs = [s["rows"][0] if s else 0 for s in shapes]
    n, nnz, m = sum(cols), sum(nnzs), shapes[0]["b"][0]
    count = {"indptr": n + 1, "rows": nnz, "a": nnz, "c": nnz, "b": m}
    dtype = {k: np.dtype(shapes[0][k][1]) for k in count}
    offset, total = {}, 0
    for k in count:
        offset[k] = total
        total += -(-count[k] * dtype[k].itemsize // 64) * 64
    memory = rank.shared(total)
    arrays = {k: np.frombuffer(memory, dtype[k], count[k], offset[k]) for k in count}

    def write(view, t):
        torch.from_numpy(view).copy_(t)

    if part:
        c0, z0 = sum(cols[:rank.rank]), sum(nnzs[:rank.rank])
        write(arrays["indptr"][c0:c0 + cols[rank.rank]], part["indptr"][:-1] + z0)
        for k in ("rows", "a", "c"):
            write(arrays[k][z0:z0 + nnzs[rank.rank]], part[k])
        if "b" in part:
            write(arrays["b"], part["b"])
    if rank.rank == 0:
        arrays["indptr"][n] = nnz
    del part
    rank.barrier()
    for a in arrays.values():
        a.flags.writeable = False
    return Inputs(**arrays, m=int(m), n=int(n), nnz=int(nnz))


def timed_calls(runner: Callable, start, seed: int, count: int, rank) -> Window:
    """``count`` calls on every rank, timed by rank 0's clock from a barrier
    before the first call to a synchronise and a barrier after the last."""
    synchronize(rank.device)
    rank.barrier()
    t0 = time.perf_counter()
    window = run_calls(runner, start, seed, calls=count, device=rank.device)
    rank.barrier()
    window.seconds = time.perf_counter() - t0
    return window


def traced_calls(runner: Callable, start, seed: int, count: int, rank):
    """(window, trace): ``count`` calls on every rank, under the profiler on
    rank 0 (trace None elsewhere); rank 0 tells the others whether the
    profiler's window runs again."""
    def calls():
        return run_calls(runner, start, seed, calls=count, device=rank.device)

    synchronize(rank.device)
    rank.barrier()
    if rank.rank == 0:
        from gpubench import tracing

        return tracing.traced_window(calls, rank.device, again=rank.broadcast)
    window = calls()
    while rank.broadcast(None):
        window = calls()
    return window, None


def rank_run(rank, spec: dict) -> Optional[dict]:
    """One rank of a multi-card run (``run_ranks``); rank 0 returns the
    result line's object.  Every rank makes the same calls; rank 0 keeps the
    clock and the trace, and the peak is the fullest card's."""
    cell = Cell(spec["name"], Path(spec["root"]))
    if spec["iterations"] is not None:
        cell.params = dict(cell.params, iterations_per_call=int(spec["iterations"]))
    dev, seed, lead = rank.device, int(spec["seed"]), rank.rank == 0
    say = log if lead else (lambda **_: None)
    t = time.perf_counter()
    inputs = shared_inputs(cell, seed, rank)
    say(phase="inputs", seconds=round(time.perf_counter() - t, 3), m=inputs.m, n=inputs.n, nnz=inputs.nnz,
        b_sum=repr(float(inputs.b.astype(np.float64).sum())), ranks=rank.world)
    free_device(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    with faults.planted(spec["fault"]) if spec["fault"] else contextlib.nullcontext():
        if spec["control"] is None:
            objective, solver, build_s = build_program(cell, inputs, dev, cell.traffic["objective_kwargs"],
                                                       world=rank.world)
            runner = ProgramRunner(objective, solver)
            del objective, solver
        else:
            runner, build_s = control_runner(cell, inputs, dev, spec["control"], shard=rank)
        say(phase="build", seconds=round(build_s, 3))
        zero = torch.zeros(inputs.m, dtype=torch.float32, device=dev)
        warmup = run_calls(runner, zero, seed, calls=1, device=dev)
        say(phase="warm-up", seconds=round(warmup.seconds, 3))
        warmup = warmup.last
        start = warmup.dual
        if spec["trace"]:
            count = int(cell.params["trace_calls"])
        elif spec["calls"]:
            count = int(spec["calls"])
        else:  # the calls that fill --seconds, from one timed call, the same on every rank
            probe = timed_calls(runner, start, seed, 1, rank)
            start = probe.last.dual
            count = rank.broadcast(max(1, math.ceil(float(spec["seconds"]) / probe.seconds)))
            say(phase="probe", seconds=round(probe.seconds, 4), calls=count)
            del probe
        setup_s = time.time() - float(spec["start_wall"])
        if spec["trace"]:
            window, traced = traced_calls(runner, start, seed, count, rank)
        else:
            window, traced = timed_calls(runner, start, seed, count, rank), None
        window_s = traced.window_s if traced is not None else window.seconds
        if traced is not None:
            say(phase="trace", attempts=traced.attempts, lost_records=traced.lost_records,
                records=len(traced.records), busy_s=traced.busy_s, window_s=traced.window_s)
        peaks = rank.gather(int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0)
        peak, iterations = max(peaks), window.count * cell.iterations_per_call
        say(phase="window", seconds=round(window_s, 3), calls=window.count, iterations=iterations, peak_bytes=peak,
            rank_peaks=",".join(map(str, peaks)), setup_s=round(setup_s, 3))
        picked = [(label, to_host(c)) for label, c in checked_calls(warmup, window)]
        attempted = window.count
        del runner, window, warmup, zero, start
        free_device(dev)
        t = time.perf_counter()
        verdict = judge(cell, inputs, picked, dev, shard=rank)
        say(phase="reference", seconds=round(time.perf_counter() - t, 3), checked=len(picked))
    loaded = forbidden_modules()
    if loaded:
        raise RuntimeError(f"rank {rank.rank}: modules of JAX or the JAX package are loaded: {', '.join(loaded)}")
    if not lead:
        return None
    # the rooflines' work: a rank's kernels see about 1/N of the columns and nonzeros, and every row
    ctx = SimpleNamespace(cell=cell, problem={"m": inputs.m, "n": inputs.n / rank.world,
                                              "nnz": inputs.nnz / rank.world},
                          setup_s=setup_s, build_s=build_s, window_s=window_s, iterations=iterations,
                          calls=attempted, peak_bytes=peak, trace=traced,
                          device_kind=torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                          peaks=load_json(cell.bench / "peaks.json"))
    result = {"correct": verdict["correct"], "attempted": attempted, "failed": verdict["failed"],
              "metrics": read_metrics(cell, cell.per_layer if spec["trace"] else cell.end_to_end, ctx),
              "device": device_info(dev, cell.chips, peak)}
    if traced is not None:
        result["device"].update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = traced.breakdown
    if spec["keep_checked"]:
        result["checked"] = {label: c.dual for label, c in picked}
    result["compared"] = verdict["compared"]
    return result
