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
"""

from __future__ import annotations

import gc
import importlib.util
import json
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

from gpubench import check
from gpubench.reference.matching import MatchingReference

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dualip_tpu")  # top-level module names, compared whole


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


def build_program(cell: Cell, inputs: Inputs, device, objective_kwargs: dict):
    """(objective, solver, build_s): the objective through ``build_objective``
    and the maximizer of ``make_solver``."""
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
    objective = build_objective(args, solver_args(cell), ComputeArgs(host_device=str(device)),
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


def reference_for(cell: Cell, inputs: Inputs, device, dtype=torch.float64) -> MatchingReference:
    proj = cell.config["projection"]
    if proj["kind"] != "simplex":
        raise ValueError(f"the reference projects onto simplex sets, not {proj['kind']!r}")
    return MatchingReference(inputs.indptr, inputs.rows, inputs.a, inputs.c, inputs.b,
                             gamma=float(cell.config["solver"]["gamma"]), radius=float(proj["radius"]),
                             tol=float(proj["tol"]), dtype=dtype, device=device)


def worst_objective(program: Call, reference: Call) -> dict:
    """Where ``obj_gap`` is read: the iteration, and both sides' objective
    there (a relative gap swells where the objective nears zero)."""
    f, f_ref = program.objectives, reference.objectives
    if f.shape != f_ref.shape or not f.size:
        return {"obj_worst_at": "none"}
    i = int(np.argmax(np.abs(f - f_ref) / np.maximum(np.abs(f_ref), np.finfo(np.float64).tiny)))
    return {"obj_worst_at": i, "obj_there": repr(float(f[i])), "obj_ref_there": repr(float(f_ref[i]))}


def judge(cell: Cell, inputs: Inputs, calls: List[tuple], device) -> dict:
    """The reference follows each checked call from its start; returns the
    comparison (``check.compare``) against the cell's limits."""
    reference = reference_for(cell, inputs, device)
    runner = ReferenceRunner(reference, cell)
    readings = []
    for label, c in calls:
        ref = to_host(runner(torch.as_tensor(c.start)))
        readings.append(check.gaps(c, ref))
        log(phase="checked", call=label, start_sum=repr(float(c.start.sum())), dual_sum=repr(float(c.dual.sum())),
            **{k: "%.3e" % v for k, v in readings[-1].items()}, **worst_objective(c, ref))
    del reference, runner
    free_device(device)
    return check.compare(readings, cell.params["limits"])


def device_info(device, chips: int, peak_bytes: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak_bytes}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": peak_bytes}
    try:
        out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit"] = out.stdout.strip() or "not read"
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


def run(name: str, seed: int, seconds: float, trace: bool, device="cuda", root: Path = ROOT,
        runner_factory=None, from_process_start: bool = False, calls: Optional[int] = None,
        iterations: Optional[int] = None) -> dict:
    """One run; returns the result line's object.  ``setup_s`` counts from
    the process's start with ``from_process_start`` (the command), else from
    this call.  ``runner_factory(cell, inputs, device) -> (runner, build_s)``
    puts something else in the program's place (a control); ``calls`` makes
    an untraced window of that many calls instead of ``seconds``;
    ``iterations`` sets the calls' length in place of the cell's (probes of
    ``control.py``, never a benchmark run)."""
    t0 = time.perf_counter()
    cell = Cell(name, root)
    if iterations is not None:
        cell.params = dict(cell.params, iterations_per_call=int(iterations))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise Refused(f"{name} needs {cell.chips} CUDA device(s); found "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        from dualip_tpu_torch.ops import _build

        t = time.perf_counter()
        _build.build(cell.traffic["kernel_sources"])
        log(phase="kernels", seconds=round(time.perf_counter() - t, 3), sources=",".join(cell.traffic["kernel_sources"]))
    t = time.perf_counter()
    inputs = make_inputs(cell, seed, dev)
    log(phase="inputs", seconds=round(time.perf_counter() - t, 3), m=inputs.m, n=inputs.n, nnz=inputs.nnz,
        b_sum=repr(float(inputs.b.astype(np.float64).sum())))
    free_device(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    if runner_factory is None:
        objective, solver, build_s = build_program(cell, inputs, dev, cell.traffic["objective_kwargs"])
        runner = ProgramRunner(objective, solver)
        del objective, solver
    else:
        runner, build_s = runner_factory(cell, inputs, dev)
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
    result["compared"] = verdict["compared"]
    return result
