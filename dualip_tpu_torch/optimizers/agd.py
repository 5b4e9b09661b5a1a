"""Nesterov accelerated gradient ascent (``dualip_tpu/optimizers/agd.py``).

FISTA beta sequence, the Lipschitz-window step size, projection of the duals
onto the nonnegative cone with equality rows left free, gamma step decay,
optional adaptive restart, and per-iteration dual-objective and step-size
logs.

One iteration is ``_make_step``'s ``step`` on a ``_Carry`` of device tensors,
as in the JAX package: the window's count, gamma, the restart index, the
iteration counter and the metrics row all stay on the device, so an
iteration never waits for the host.  Where the JAX package compiles the
iterations into one ``lax.scan`` program, how they run here depends on where
the dual lives:

* a CUDA dual and an objective without a mesh or on an NCCL mesh
  (``uses_graph``): iteration 1 runs eagerly (the objective fills its lazy
  state, the kernels load and set their attributes, NCCL creates its
  communicator), then one iteration is captured in a CUDA graph on static
  carry buffers and every later iteration is one ``replay()``: the same
  kernels in the same order as the eager loop, so the same bits.  On a mesh
  the capture holds the evaluation's one ``all_reduce``, and every rank
  captures at iteration 2 and replays the same collectives in the same order.
  A capture that fails raises; it never falls back to the eager loop.
* the CPU, or a gloo mesh: the same step in an eager Python loop that queues
  each iteration's kernels and never waits for them.  gloo's ``all_reduce``
  goes through host memory and cannot be captured.

Iterations run in chunks, as the JAX package launches its scan: a chunk is
``callback_chunk`` iterations with an observer, else ``launch_chunk`` (0: the
whole solve), at most ``stop_check_every`` with a ``stop_condition``; a
chunk's replays are queued back to back with no host round trip.  The
per-iteration metrics go into a ``(max_iter, 8)`` device tensor fetched once
at the end, or after each chunk with an observer.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import os
import warnings
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from dualip_tpu_torch.optimizers.agd_utils import (
    DEFAULT_HISTORY_LENGTH,
    StepSizeState,
    calculate_step_size,
    init_step_size_state,
)
from dualip_tpu_torch.parallel.mesh import is_rank_zero
from dualip_tpu_torch.types import ObjectiveResult, SolverResult, resolve_device
from dualip_tpu_torch.utils import profiling
from dualip_tpu_torch.utils.mlflow_utils import _mlflow_state, log_metrics, log_objective_result


def project_on_nn_cone(y: torch.Tensor, equality_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Project duals onto the nonnegative cone; equality rows stay free."""
    projected = torch.clamp_min(y, 0.0)
    if equality_mask is not None:
        return torch.where(equality_mask, y, projected)
    return projected


def compute_beta_seq(max_iter: int) -> np.ndarray:
    """FISTA momentum ``beta_i = (1 - t_{i+1}) / t_{i+2}`` with
    ``t_{i+1} = (1 + sqrt(1 + 4 t_i^2)) / 2``, stored in float32 with a
    float64 sqrt, as the golden traces need."""
    t = np.zeros(max_iter + 2, dtype=np.float32)
    for i in range(1, max_iter + 2):
        t[i] = np.float32((1.0 + math.sqrt(1.0 + 4.0 * float(np.float32(t[i - 1]) ** 2))) / 2.0)
    beta = np.zeros(max_iter, dtype=np.float32)
    for i in range(max_iter):
        beta[i] = (np.float32(1.0) - t[i + 1]) / t[i + 2]
    return beta


def format_objective_result_summary(iteration: int, objective_result: ObjectiveResult) -> str:
    """One-line per-iteration summary."""

    def _fmt(name, val):
        if val is None:
            return None
        arr = np.asarray(val.detach().cpu() if isinstance(val, torch.Tensor) else val)
        if np.issubdtype(arr.dtype, np.floating) and arr.size == 1 and np.isnan(arr):
            return None
        if arr.size == 1:
            return f"{name}={arr.item()}"
        return f"{name}.shape={tuple(arr.shape)}"

    grad_norm_str = None
    if objective_result.dual_gradient is not None:
        grad_norm = float(torch.linalg.vector_norm(torch.as_tensor(objective_result.dual_gradient)))
        grad_norm_str = f"dual_grad_norm={grad_norm}"

    parts = [
        f"iter={iteration}",
        _fmt("dual_objective", objective_result.dual_objective),
        grad_norm_str,
        _fmt("reg_penalty", objective_result.reg_penalty),
        _fmt("primal_objective", objective_result.primal_objective),
        _fmt("primal_var", objective_result.primal_var),
        _fmt("dual_val_times_grad", objective_result.dual_val_times_grad),
        _fmt("max_pos_slack", objective_result.max_pos_slack),
        _fmt("sum_pos_slack", objective_result.sum_pos_slack),
    ]
    return " | ".join(p for p in parts if p is not None)


class _Metrics(NamedTuple):
    """Per-iteration scalars, one row of the metrics tensor each iteration."""

    dual_objective: torch.Tensor
    step_size: torch.Tensor
    grad_norm: torch.Tensor
    gamma: torch.Tensor
    reg_penalty: torch.Tensor
    dual_val_times_grad: torch.Tensor
    max_pos_slack: torch.Tensor
    sum_pos_slack: torch.Tensor


METRICS = _Metrics._fields  # the metrics tensor's columns


class _Carry(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    ss_state: StepSizeState
    gamma: torch.Tensor
    max_step_size: torch.Tensor
    last_grad: torch.Tensor  # gradient evaluated at this iteration's x (pre-update)
    last_x: torch.Tensor  # the x the last objective evaluation used (for save_primal)
    beta_idx: torch.Tensor  # iterations since the last adaptive restart (int64)
    prev_obj: torch.Tensor  # previous dual objective (function-restart test)


def _flat(tree) -> List[torch.Tensor]:
    """The tensors of a carry (nested tuples of tensors), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for part in tree for leaf in _flat(part)]


def _clone(tree):
    """A carry with every tensor copied."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(_clone(t) for t in tree))


def _tensor_leaves(tree) -> List[torch.Tensor]:
    """The tensors of an objective's ``params``, in order, through tuples
    (NamedTuples too), lists, dicts and dataclasses; a container met twice is
    walked once."""
    out, seen = [], set()

    def walk(v):
        if isinstance(v, torch.Tensor):
            out.append(v)
            return
        is_dc = dataclasses.is_dataclass(v) and not isinstance(v, type)
        if not (is_dc or isinstance(v, (tuple, list, dict))) or id(v) in seen:
            return
        seen.add(id(v))
        if is_dc:
            v = [getattr(v, fld.name) for fld in dataclasses.fields(v)]
        for x in (v.values() if isinstance(v, dict) else v):
            walk(x)

    walk(tree)
    return out


def uses_graph(device, mesh) -> bool:
    """The path rule: ``maximize`` replays a CUDA graph on a CUDA dual whose
    objective has no mesh, or a mesh whose group runs NCCL (a graph captures
    NCCL's ``all_reduce``); a gloo mesh (its ``all_reduce`` goes through host
    memory and cannot be captured) and the CPU run the eager loop.  A choice
    of path by backend, not a fallback: a capture that fails raises."""
    return torch.device(device).type == "cuda" and (mesh is None or mesh.backend() == "nccl")


def _iteration_marks(f, device, rows: int) -> Optional[profiling.IterationMarks]:
    """The device marks of ``f``'s iterations (None off CUDA): with the point
    ``reduced`` after the evaluation's ``all_reduce`` where ``f`` is sharded
    over a mesh."""
    if getattr(f, "mesh", None) is None:
        return profiling.IterationMarks.for_device(device, rows)
    return profiling.IterationMarks.for_device(device, rows, reduced=True)


def _calc(f, params, dual_val: torch.Tensor, gamma: Optional[torch.Tensor]) -> ObjectiveResult:
    """The objective at ``dual_val``; ``gamma`` is None when the solver has
    none configured, and is then not passed."""
    if hasattr(f, "calculate_traceable"):
        return f.calculate_traceable(params, dual_val, gamma)
    kwargs = {"gamma": gamma} if gamma is not None else {}
    return f.calculate(dual_val=dual_val, **kwargs)


def _scalar(v, dtype, device) -> torch.Tensor:
    """A 0-d tensor of ``dtype``; a host number is filled on the device, not
    copied there (a copy from pageable memory cannot be captured)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype).reshape(())
    return torch.full((), float(v), dtype=dtype, device=device)


class _EagerLoop:
    """The iterations launched from Python one after another (the CPU, a gloo
    mesh, or ``_maximize_eager``)."""

    def __init__(self, body, carry, counter, metrics, marks):
        self.body, self.carry, self.counter, self.metrics, self.marks = body, carry, counter, metrics, marks

    def run(self, size: int) -> None:
        for _ in range(size):
            self.carry, self.counter = self.body(self.carry, self.counter)
            profiling.end_iteration()
        profiling.count("dualip.agd.eager_iterations", size)

    def owned(self, t: torch.Tensor) -> torch.Tensor:
        return t  # nothing overwrites the loop's outputs


class _Graph:
    """One iteration captured in a CUDA graph on static buffers: the carry,
    the iteration counter and the metrics tensor, with the beta sequence, the
    equality mask and the objective's params it reads.  The first ``run`` of
    a fresh graph runs iteration 1 eagerly on the buffers, captures the next
    and replays it; a later ``maximize`` on the same objective, with the same
    params tensors and step settings (``reads``), ``load``s its start into the
    buffers and only replays.  The kernels' wrappers count what they enqueue
    (``dualip.ops.<wrapper>.enqueued``): the capture calls each wrapper once
    (recording its launch, running nothing) and a replay calls none.  The
    iteration's ``marks`` are captured with it."""

    def __init__(self, body, carry, counter, metrics, fields_present, what: str, leaves, settings, marks):
        self.body = body  # kept: the graph reads the tensors it closes over (beta, mask, params)
        self.marks = marks
        self.carry = _clone(carry)
        self.counter, self.metrics, self.fields_present, self.what = counter, metrics, fields_present, what
        # held, so that no id in them is reused while the graph reads their memory
        self.leaves, self.settings = leaves, settings
        self.graph = None

    def fits(self, carry) -> bool:
        return all(s.shape == n.shape and s.dtype == n.dtype for s, n in zip(_flat(self.carry), _flat(carry)))

    def reads(self, leaves, settings) -> bool:
        """Whether the captured iteration reads these params tensors (the
        same objects) with these step settings."""
        return (settings == self.settings and len(leaves) == len(self.leaves)
                and all(a is b for a, b in zip(leaves, self.leaves)))

    def load(self, carry) -> None:
        for s, n in zip(_flat(self.carry), _flat(carry)):
            s.copy_(n)
        self.counter.zero_()

    def _advance(self) -> None:
        """One iteration in place on the static buffers: the step's outputs
        copied over its inputs (an output that is another input, like
        ``last_x = x``, is copied out first)."""
        new, counter = self.body(self.carry, self.counter)
        static, fresh = _flat((self.carry, self.counter)), _flat((new, counter))
        fresh = [n if n is s or not any(n is t for t in static) else n.clone() for s, n in zip(static, fresh)]
        for s, n in zip(static, fresh):
            if n is not s:
                s.copy_(n)
        profiling.end_iteration()

    def _capture(self) -> None:
        # torch.cuda.graph synchronizes the device on entry: iteration 1's
        # kernels and collective have finished when the capture begins
        g = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.device(self.counter.device), torch.cuda.graph(g):
                self._advance()
        except Exception as e:  # name the objective; the chained traceback names the op
            raise RuntimeError(f"capturing one AGD iteration of {self.what} in a CUDA graph failed: {e}") from e
        self.graph = g

    def run(self, size: int) -> None:
        if self.graph is None:
            with profiling.span("dualip.agd.capture", always=True, what=self.what):
                self._advance()
                self._capture()
            profiling.count("dualip.agd.captures")
            profiling.count("dualip.agd.eager_iterations")
            size -= 1
        for _ in range(size):
            self.graph.replay()
        profiling.count("dualip.agd.replays", size)

    def owned(self, t: torch.Tensor) -> torch.Tensor:
        return t.clone()  # the next replay overwrites the static buffers


class AcceleratedGradientDescent:
    """Maximizes a dual objective with Nesterov-accelerated ascent.

    Same constructor as ``dualip_tpu``'s:

    * ``callback_chunk``: with an iteration callback or MLflow logging, the
      iterations run in chunks of this size and the metrics are fetched after
      each chunk; the callback (and the logging) then runs once per
      iteration with exact values, ``callback_chunk`` iterations late.
    * ``launch_chunk``: iterations per chunk without an observer (0: the
      whole solve is one chunk).  A chunk's iterations are queued back to
      back, so it changes only where ``collect_chunk_walls`` and
      ``DUALIP_TIMING`` cut the solve.  1 is clamped to 2, as in the JAX
      package, so one configuration gives the same chunks in both.
    * ``collect_stats = True`` records the next ``maximize``'s wall clock in
      ``last_run_stats``: ``total_s`` (the whole call up to the metrics
      fetch), ``iters`` (``max_iter``) and ``drain_s`` (the fetch, which
      waits for the device to finish the queued iterations), read from its
      spans ``dualip.agd.maximize`` and ``dualip.agd.drain``.
    * ``collect_chunk_walls = True`` ends each chunk with a fetch of gamma
      (the chunk has then run on the device) and appends ``(size, seconds)``
      to ``chunk_walls``, emptied by each ``maximize``: the chunk's span
      ``dualip.agd.replay``.  ``DUALIP_TIMING=1`` prints each chunk's and the
      final fetch's wall time, from the same spans.

    Each call records its spans in the port's store
    (``utils/profiling.py``) while tracing is on: ``dualip.agd.maximize``
    around ``dualip.agd.start`` (the carry, the graph's lookup and ``load``),
    one ``dualip.agd.replay`` a chunk (attribute ``size``; a capture inside
    it as ``dualip.agd.capture``, recorded always), ``dualip.agd.drain`` (the
    metrics fetch, the wait for the card; traced, the marks' table fetched
    beside it) and ``dualip.agd.result``; the
    counters ``dualip.agd.captures``, ``.graph_reuse``, ``.replays`` and
    ``.eager_iterations`` count always.  On a CUDA device each iteration
    records ``profiling.IterationMarks`` (captured into the graph), which a
    traced call reads in its drain.

    On a mesh (a sharded objective) every rank runs the same path (the graph
    on NCCL, the eager loop on gloo) on the same bits and only rank 0 logs to
    MLflow.

    The CUDA graph (module docstring) is cached in ``_jit_cache`` under the
    JAX package's key (the objective, whether it has an equality mask, the
    dtype), so a repeated ``maximize`` on the same objective replays it
    without capturing again, while the objective's ``params`` are the same
    tensors and the solver's settings the same; otherwise that ``maximize``
    captures a new graph in its place.  The cache holds the objective, the graph's
    private memory pool (one iteration's temporaries, about what the eager
    loop allocates in an iteration) and the static buffers (x, y, the last
    x and gradient, the ``(H, m)`` window pair, the ``(max_iter, 8)``
    metrics) until the solver is dropped or ``_jit_cache`` is cleared.
    """

    def __init__(
        self,
        max_iter: int,
        gamma: Optional[float],
        initial_step_size: float = 1e-5,
        max_step_size: float = 0.1,
        gamma_decay_type: Optional[str] = None,
        gamma_decay_params: Optional[dict] = None,
        save_primal: bool = False,
        iteration_callback: Optional[Callable[[int, ObjectiveResult], None]] = None,
        history_length: int = DEFAULT_HISTORY_LENGTH,
        callback_chunk: int = 1,
        verbose: bool = False,
        stop_condition: Optional[Callable[[int, torch.Tensor], bool]] = None,
        stop_check_every: int = 0,
        restart: Optional[str] = None,
        restart_min_spacing: int = 50,
        launch_chunk: int = 0,
    ):
        if gamma_decay_type not in (None, "step"):
            raise ValueError(f"Unsupported gamma decay type: {gamma_decay_type}")
        if restart not in (None, "gradient", "function"):
            raise ValueError(f"Unsupported restart scheme: {restart!r}")
        self.max_iter = max_iter  # also sets beta_seq
        self.gamma = gamma
        self.initial_step_size = float(initial_step_size)
        self.max_step_size = float(max_step_size)
        self.gamma_decay_type = gamma_decay_type
        self.gamma_decay_params = gamma_decay_params or {}
        self.save_primal = save_primal
        self.history_length = history_length
        self.callback_chunk = max(1, int(callback_chunk))
        self.iteration_callback = iteration_callback
        if iteration_callback is None and verbose:
            self.iteration_callback = self._default_iteration_callback
        self.stop_condition = stop_condition
        self.stop_check_every = int(stop_check_every)
        if stop_condition is not None and self.stop_check_every <= 0:
            self.stop_check_every = 100
        self.launch_chunk = max(0, int(launch_chunk))
        if self.launch_chunk == 1:
            warnings.warn(
                "launch_chunk=1 is clamped to 2, the smallest chunk the JAX package keeps bit-identical to its "
                "one-launch solve, so that one configuration runs the same chunks in both packages.",
                stacklevel=2,
            )
            self.launch_chunk = 2
        self.restart = restart
        self.restart_min_spacing = int(restart_min_spacing)
        self._jit_cache = {}
        self.collect_stats = False
        self.last_run_stats = None
        self.collect_chunk_walls = False
        self.chunk_walls: List[tuple] = []

    @property
    def max_iter(self) -> int:
        """Iterations of a solve.  Setting it computes its beta sequence; a
        cached graph, whose metrics table it sized, is then captured again."""
        return self._max_iter

    @max_iter.setter
    def max_iter(self, n: int) -> None:
        self._max_iter = int(n)
        self.beta_seq = compute_beta_seq(self._max_iter)

    def _step_settings(self) -> tuple:
        """What a captured iteration reads from the solver's settings: the
        iteration count (the beta sequence and the metrics table) and the
        step's constants (``_make_step``)."""
        return (self.max_iter, self.initial_step_size, self.gamma is not None, self.gamma_decay_type,
                sorted(self.gamma_decay_params.items()), self.restart, self.restart_min_spacing)

    @staticmethod
    def _default_iteration_callback(iteration: int, objective_result: ObjectiveResult) -> None:
        print(format_objective_result_summary(iteration, objective_result))

    def _make_step(self, f, equality_mask, dtype, fields_present: dict):
        """``step(params, carry, it_num, beta) -> (carry, _Metrics)``: one
        iteration on device tensors (``it_num`` the 1-based iteration, a 0-d
        integer tensor; ``beta`` its momentum).  A hook for subclass
        maximizers, with ``_init_carry``; it records which optional fields
        the objective gives in ``fields_present``.  The step refers to no
        solver attribute, only to values read here, so a graph cached on the
        solver does not keep the solver alive through it."""
        decay = self.gamma_decay_type == "step"
        if decay:
            decay_steps = int(self.gamma_decay_params["decay_steps"])
            decay_factor = float(self.gamma_decay_params["decay_factor"])
        restart, spacing = self.restart, self.restart_min_spacing
        has_gamma, initial_step_size = self.gamma is not None, self.initial_step_size
        # restart mode indexes the beta sequence by iterations since the last
        # restart (carried); placed on the dual's device at the first call,
        # which is eager (a copy from the host cannot be captured)
        beta_seq, beta_full = self.beta_seq, []

        def step(params, carry: _Carry, it_num: torch.Tensor, beta: torch.Tensor):
            dev = carry.x.device

            def opt(val, name):
                fields_present[name] = val is not None
                return _scalar(val, dtype, dev) if val is not None else torch.full((), math.nan, dtype=dtype,
                                                                                     device=dev)

            res = _calc(f, params, carry.x, carry.gamma if has_gamma else None)
            grad = res.dual_gradient
            obj = _scalar(res.dual_objective, dtype, dev)
            step_size, ss_state = calculate_step_size(
                grad, carry.y, carry.ss_state, initial_step_size, carry.max_step_size
            )
            y_new = project_on_nn_cone(carry.x + grad * step_size, equality_mask)
            beta_idx, prev_obj = carry.beta_idx, carry.prev_obj
            if restart is not None:
                if restart == "gradient":
                    # momentum against the gradient direction: drop it this update
                    bad = torch.dot(grad, y_new - carry.y) < 0
                else:  # "function": the dual objective went down
                    bad = obj < prev_obj
                bad = bad & (beta_idx >= spacing)
                if not beta_full:
                    beta_full.append(torch.as_tensor(beta_seq, device=dev))
                beta = torch.where(bad, torch.zeros((), dtype=beta_full[0].dtype, device=dev),
                                   beta_full[0].index_select(0, beta_idx.reshape(1)).reshape(()))
                beta_idx = torch.where(bad, torch.ones_like(beta_idx), beta_idx + 1)
                prev_obj = obj
            x_new = y_new * (1.0 - beta) + carry.y * beta
            gamma, max_step = carry.gamma, carry.max_step_size
            if decay:
                do = torch.remainder(it_num, decay_steps) == 0
                gamma = torch.where(do, gamma * decay_factor, gamma)
                max_step = torch.where(do, step_size * decay_factor, max_step)
                if restart == "function":  # the decay, not oscillation, lowers g_gamma
                    prev_obj = torch.where(do, torch.full((), -math.inf, dtype=dtype, device=dev), prev_obj)
            metrics = _Metrics(
                dual_objective=obj,
                step_size=step_size.to(dtype),
                grad_norm=torch.linalg.vector_norm(grad).to(dtype),
                gamma=gamma.to(dtype),
                reg_penalty=opt(res.reg_penalty, "reg_penalty"),
                dual_val_times_grad=opt(res.dual_val_times_grad, "dual_val_times_grad"),
                max_pos_slack=opt(res.max_pos_slack, "max_pos_slack"),
                sum_pos_slack=opt(res.sum_pos_slack, "sum_pos_slack"),
            )
            new_carry = _Carry(
                x=x_new,
                y=y_new,
                ss_state=ss_state,
                gamma=gamma,
                max_step_size=max_step,
                last_grad=grad,
                last_x=carry.x,
                beta_idx=beta_idx,
                prev_obj=prev_obj,
            )
            return new_carry, metrics

        return step

    def _init_carry(self, x0: torch.Tensor, gamma0: torch.Tensor, ss0: StepSizeState) -> _Carry:
        """The carry at the start.  A hook for subclass maximizers: override
        it together with ``_make_step``; ``maximize`` only relies on the carry
        exposing ``x``, ``y``, ``gamma``, ``last_grad`` and ``last_x``."""
        dev, dtype = x0.device, x0.dtype
        return _Carry(
            x=x0,
            y=x0,
            ss_state=ss0,
            gamma=gamma0,
            max_step_size=torch.full((), self.max_step_size, dtype=torch.float32, device=dev),
            last_grad=torch.zeros(x0.shape[0], dtype=dtype, device=dev),
            last_x=x0,
            beta_idx=torch.zeros((), dtype=torch.long, device=dev),
            prev_obj=torch.full((), -math.inf, dtype=dtype, device=dev),
        )

    def maximize(
        self,
        f,
        initial_value,
        rank: int = 0,
        initial_step_size_state: Optional[StepSizeState] = None,
    ) -> SolverResult:
        """Run ``max_iter`` ascent iterations (fewer if ``stop_condition``
        fires).  ``f`` exposes ``equality_mask``, ``params`` and
        ``calculate_traceable(params, dual_val, gamma)``, or just
        ``calculate(dual_val, ...)``.  ``initial_value`` and the step-size
        window may be tensors or numpy arrays; numpy ones go to ``f.device``
        (``cuda`` when ``f`` names none), a float64 one as float32.

        On a CUDA dual with an objective that has no mesh, or an NCCL mesh,
        the iterations after the first are replays of a CUDA graph of one
        iteration; on the CPU or a gloo mesh they run in the eager loop
        (``uses_graph``, module docstring).  Both give the
        same bits.  ``initial_step_size_state`` (e.g. from
        ``checkpoint.load_dual``) resumes the Lipschitz window.
        """
        return self._maximize(f, initial_value, rank, initial_step_size_state, graph=None)

    def _maximize_eager(self, f, initial_value, rank: int = 0,
                        initial_step_size_state: Optional[StepSizeState] = None) -> SolverResult:
        """``maximize`` in the eager loop on any device: the graph's
        reference in the card's checks."""
        return self._maximize(f, initial_value, rank, initial_step_size_state, graph=False)

    def _maximize(self, f, initial_value, rank, initial_step_size_state, graph) -> SolverResult:
        with profiling.span("dualip.agd.maximize", always=self.collect_stats, new_call=True,
                            max_iter=self.max_iter) as call:
            return self._solve(call, f, initial_value, rank, initial_step_size_state, graph)

    def _solve(self, call, f, initial_value, rank, initial_step_size_state, graph) -> SolverResult:
        """The body of ``maximize`` inside its span ``call``: the spans
        ``dualip.agd.start``, ``.replay`` (one per chunk), ``.drain`` and
        ``.result``."""
        timing = os.environ.get("DUALIP_TIMING") == "1"
        walls = self.collect_chunk_walls or timing  # the chunks are timed whether tracing is on or not
        with profiling.span("dualip.agd.start"):
            if isinstance(initial_value, torch.Tensor):
                x0 = initial_value
            else:  # numpy float64 solves in float32, as in the JAX package (x64 off)
                x0 = np.asarray(initial_value)
                x0 = torch.as_tensor(x0.astype(np.float32) if x0.dtype == np.float64 else x0,
                                     device=resolve_device(getattr(f, "device", None)))
            dev = x0.device
            dtype, m = x0.dtype, x0.shape[0]
            equality_mask = getattr(f, "equality_mask", None)
            if equality_mask is not None:
                equality_mask = torch.as_tensor(equality_mask, dtype=torch.bool, device=dev)
            params = getattr(f, "params", ())

            if initial_step_size_state is None:
                ss0 = init_step_size_state(m, self.history_length, dtype, dev)
            else:
                s = initial_step_size_state  # tensors, numpy arrays, or another framework's arrays

                def put(v, dt):
                    return torch.as_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v), dtype=dt, device=dev)

                ss0 = StepSizeState(grad_hist=put(s.grad_hist, dtype), dual_hist=put(s.dual_hist, dtype),
                                    count=put(s.count, torch.int32).reshape(()))
            gamma0 = torch.full((), self.gamma if self.gamma is not None else math.nan, dtype=torch.float32,
                                device=dev)
            carry = self._init_carry(x0, gamma0, ss0)

            if graph is None:
                graph = uses_graph(dev, getattr(f, "mesh", None))
            if graph:
                runner = self._graph(f, params, equality_mask, dtype, carry)
                fields_present = runner.fields_present
            else:
                fields_present = {}
                marks = _iteration_marks(f, dev, self.max_iter)
                body, metrics = self._body(f, params, equality_mask, dtype, carry, fields_present, marks)
                runner = _EagerLoop(body, carry, torch.zeros((), dtype=torch.long, device=dev), metrics, marks)
            metrics = runner.metrics
            if runner.marks is not None and profiling.is_on():
                runner.marks.reset()

            logging = _mlflow_state.is_enabled() and is_rank_zero()
            observing = self.iteration_callback is not None or logging
            chunk = self.callback_chunk if observing else (self.launch_chunk or self.max_iter)
            if self.stop_condition is not None:
                chunk = min(chunk, self.stop_check_every)

        self.chunk_walls = []
        pos = 0
        while pos < self.max_iter:
            size = min(chunk, self.max_iter - pos)
            with profiling.span("dualip.agd.replay", always=walls, size=size) as rec:
                runner.run(size)
                if self.collect_chunk_walls:
                    runner.carry.gamma.item()  # fetch-terminated: the chunk has run on the device
                if timing and dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            if self.collect_chunk_walls:
                self.chunk_walls.append((size, rec.seconds))
            if timing:
                print(f"[timing] chunk pos={pos} size={size}: {rec.seconds:.3f}s")
            if observing:
                rows = metrics[pos:pos + size].cpu().numpy()
                for k, r in enumerate(rows):
                    per_iter = self._row_to_result(r, fields_present)
                    if self.iteration_callback is not None:
                        self.iteration_callback(pos + k + 1, per_iter)
                    if logging:
                        self._log_row(pos + k + 1, r, per_iter)
            pos += size
            if self.stop_condition is not None and self.stop_condition(pos, runner.owned(runner.carry.y)):
                break

        with profiling.span("dualip.agd.drain", always=timing or self.collect_stats) as drain:
            host = metrics[:pos].cpu().numpy()  # the one fetch of the solve's metrics
            final = runner.carry
            gamma_end = float(final.gamma)
            if runner.marks is not None and profiling.is_on():
                runner.marks.read(pos)  # the marks' table beside the metrics: the layers' mean, one sample a call
        if timing:
            print(f"[timing] drain: {drain.seconds:.3f}s")
        if self.collect_stats:
            self.last_run_stats = {"total_s": (drain.end_ns - call.start_ns) * 1e-9, "iters": self.max_iter,
                                   "drain_s": drain.seconds}

        with profiling.span("dualip.agd.result"):
            dual_obj_log: List[float] = host[:, 0].tolist()
            step_size_log: List[float] = host[:, 1].tolist()
            dual_obj = dual_obj_log[-1]
            last = self._row_to_result(host[-1], fields_present)
            final_res = ObjectiveResult(
                dual_gradient=runner.owned(final.last_grad),
                dual_objective=np.float32(dual_obj),
                reg_penalty=last.reg_penalty,
                dual_val_times_grad=last.dual_val_times_grad,
                max_pos_slack=last.max_pos_slack,
                sum_pos_slack=last.sum_pos_slack,
            )
            if self.save_primal:
                # One more evaluation, eager, at the last iteration's x, with only
                # the kwargs a (possibly duck-typed) objective accepts.
                kwargs = {}
                if self.gamma is not None:
                    kwargs["gamma"] = final.gamma
                try:
                    accepted = inspect.signature(f.calculate).parameters
                    if "save_primal" in accepted:
                        kwargs["save_primal"] = True
                    if "rank" in accepted:
                        kwargs["rank"] = rank
                except (TypeError, ValueError):
                    kwargs.update(save_primal=True, rank=rank)
                final_res = f.calculate(dual_val=runner.owned(final.last_x), **kwargs)

            if logging:
                log_objective_result(final_res, step=self.max_iter)
            if self.gamma is not None:
                self.gamma = gamma_end

            return SolverResult(
                dual_val=runner.owned(final.y),
                dual_objective=float(dual_obj),
                objective_result=final_res,
                dual_objective_log=dual_obj_log,
                step_size_log=step_size_log,
            )

    def _body(self, f, params, equality_mask, dtype, carry, fields_present, marks):
        """The scan body of the JAX package's ``run_chunk``: ``body(carry,
        counter) -> (carry, counter + 1)`` runs iteration ``counter + 1`` and
        writes its metrics row; returns it with the ``(max_iter, 8)`` metrics
        tensor it writes.  The iteration's ``marks`` (None off CUDA) record its
        start here; the runner records its end."""
        dev = carry.x.device
        step = self._make_step(f, equality_mask, dtype, fields_present)
        beta_all = torch.as_tensor(self.beta_seq, device=dev)
        metrics = torch.full((self.max_iter, len(METRICS)), math.nan, dtype=dtype, device=dev)

        def body(carry, counter):
            profiling.begin_iteration(marks)
            nxt = counter + 1
            beta = beta_all.index_select(0, counter.reshape(1)).reshape(())
            new, row = step(params, carry, nxt, beta)
            metrics.index_copy_(0, counter.reshape(1), torch.stack(list(row))[None])
            return new, nxt

        return body, metrics

    def _graph(self, f, params, equality_mask, dtype, carry) -> _Graph:
        """The objective's cached graph with ``carry`` loaded, or a new one
        (captured by its first ``run``).  The cached graph serves a call whose
        params are the same tensors (``_tensor_leaves``), whose step settings
        are the same and whose carry has its shapes; otherwise it is dropped,
        freeing its memory pool, before the new one is built: one graph per
        key.  The JAX package passes the params to its compiled program on
        every call, so a solve always reads the objective's current ones."""
        key = (f, equality_mask is not None, str(dtype))
        leaves, settings = _tensor_leaves(params), self._step_settings()
        g = self._jit_cache.pop(key, None)
        if g is not None and g.graph is not None and g.fits(carry) and g.reads(leaves, settings):
            self._jit_cache[key] = g
            g.load(carry)
            profiling.count("dualip.agd.graph_reuse")
            return g
        del g
        fields_present: dict = {}
        marks = _iteration_marks(f, carry.x.device, self.max_iter)
        body, metrics = self._body(f, params, equality_mask, dtype, carry, fields_present, marks)
        counter = torch.zeros((), dtype=torch.long, device=carry.x.device)
        mesh = getattr(f, "mesh", None)
        what = type(f).__name__ + ("" if mesh is None else f" on a {mesh.backend()} mesh")
        g = _Graph(body, carry, counter, metrics, fields_present, what, leaves, settings, marks)
        self._jit_cache[key] = g
        return g

    def _log_row(self, it: int, row: np.ndarray, per_iter: ObjectiveResult) -> None:
        """The per-iteration MLflow metrics of one fetched metrics row."""
        metrics = {"step_size": float(row[1]), "dual_objective": float(row[0])}
        if self.gamma is not None:
            metrics["gamma"] = float(row[3])
        log_metrics(metrics, step=it)
        log_objective_result(per_iter, step=it)

    @staticmethod
    def _row_to_result(row: np.ndarray, fields_present: dict) -> ObjectiveResult:
        def get(name):
            return np.float32(row[METRICS.index(name)]) if fields_present.get(name) else None

        return ObjectiveResult(
            dual_gradient=None,
            dual_objective=np.float32(row[0]),
            reg_penalty=get("reg_penalty"),
            dual_val_times_grad=get("dual_val_times_grad"),
            max_pos_slack=get("max_pos_slack"),
            sum_pos_slack=get("sum_pos_slack"),
        )
