"""The port's AGD execution model against the JAX package's maximizer on the
CPU: chunked solves (``launch_chunk``), ``collect_chunk_walls``, gamma decay,
adaptive restart, the step-size window's first iterations, warm starts from
either package's checkpoint, ``DUALIP_TIMING`` and the ``launch_chunk=1``
clamp.  The same numpy inputs go to both packages.

Tolerance against the JAX package: 1e-5, the golden traces'.  Across chunk
sizes, and between the CUDA graph's static buffers (emulated here by running
the captured iteration again for each replay) and the eager loop: bit for
bit.
"""

import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualip_tpu.checkpoint import load_dual as jax_load_dual, save_dual as jax_save_dual
from dualip_tpu.objectives.matching import (
    MatchingInputArgs as JaxArgs,
    MatchingSolverDualObjectiveFunction as JaxObjective,
)
from dualip_tpu.optimizers.agd import AcceleratedGradientDescent as JaxAGD
from dualip_tpu.optimizers.agd_utils import calculate_step_size as jax_step, init_step_size_state as jax_init
from dualip_tpu.projections import create_projection_map as jax_pm
from dualip_tpu.sparse import csc_from_dense as jax_csc
from dualip_tpu.types import ObjectiveResult as JaxResult
from dualip_tpu_torch.checkpoint import load_dual, save_dual
from dualip_tpu_torch.objectives.matching import MatchingInputArgs, MatchingSolverDualObjectiveFunction
from dualip_tpu_torch.optimizers import agd as agd_mod
from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent
from dualip_tpu_torch.optimizers.agd_utils import StepSizeState, init_step_size_state
from dualip_tpu_torch.projections import create_projection_map
from dualip_tpu_torch.sparse import csc_from_dense
from dualip_tpu_torch.types import ObjectiveResult
from tests.objectives.test_dualip_matching_simplex import A_COMPACT

torch.set_num_threads(1)

TOL = 1e-5  # the golden traces' tolerance


class JaxQuadratic:
    """f(x, y) = -(x-3)^2 - (y+5)^2 (tests/test_agd.py)."""

    equality_mask = None

    def calculate(self, dual_val, save_primal=False, **kwargs):
        x, y = dual_val[0], dual_val[1]
        return JaxResult(dual_gradient=jnp.stack([-2.0 * (x - 3.0), -2.0 * (y + 5.0)]),
                         dual_objective=-((x - 3.0) ** 2) - (y + 5.0) ** 2)


class PortQuadratic:
    equality_mask = None

    def calculate(self, dual_val, save_primal=False, **kwargs):
        x, y = dual_val[0], dual_val[1]
        return ObjectiveResult(dual_gradient=torch.stack([-2.0 * (x - 3.0), -2.0 * (y + 5.0)]),
                               dual_objective=-((x - 3.0) ** 2) - (y + 5.0) ** 2)


def _matching(gamma=1e-3, A=A_COMPACT.T, b=0.7):
    """The 5x5 golden problem in both packages (or another A or b)."""
    b = np.full(5, b, dtype=np.float32)
    jax_obj = JaxObjective(JaxArgs(A=jax_csc(A), c=jax_csc(-A), projection_map=jax_pm("simplex", {"z": 1}, 5),
                                   b_vec=b), gamma=gamma)
    port_obj = MatchingSolverDualObjectiveFunction(
        MatchingInputArgs(A=csc_from_dense(A), c=csc_from_dense(-A),
                          projection_map=create_projection_map("simplex", {"z": 1}, 5), b_vec=b),
        gamma=gamma, device="cpu")
    return jax_obj, port_obj


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))) <= tol


@pytest.mark.parametrize("chunk", [0, 1, 2, 7, 30, 64])
def test_launch_chunk_is_bit_identical_and_matches_jax(chunk):
    """tests/test_agd.py's chunked solve: the port's log and dual the same
    bits at every chunk size, within 1e-5 of the JAX package's."""
    kw = dict(max_iter=30, gamma=None, initial_step_size=1e-3)
    whole = AcceleratedGradientDescent(**kw).maximize(PortQuadratic(), torch.zeros(2))
    if chunk == 1:
        with pytest.warns(UserWarning, match="clamped to 2"):
            solver = AcceleratedGradientDescent(launch_chunk=chunk, **kw)
    else:
        solver = AcceleratedGradientDescent(launch_chunk=chunk, **kw)
    assert solver.launch_chunk == (2 if chunk == 1 else chunk)
    got = solver.maximize(PortQuadratic(), torch.zeros(2))
    assert got.dual_objective_log == whole.dual_objective_log
    assert torch.equal(got.dual_val, whole.dual_val)
    ref = JaxAGD(launch_chunk=max(chunk, 2) if chunk else 0, **kw).maximize(JaxQuadratic(), jnp.zeros(2, jnp.float32))
    _close(got.dual_objective_log, ref.dual_objective_log)
    _close(got.dual_val.numpy(), np.asarray(ref.dual_val))


@pytest.mark.parametrize("max_iter,launch_chunk,callback_chunk,stop_check_every", [
    (30, 0, None, 0), (30, 7, None, 0), (30, 2, None, 0), (30, 0, 4, 0), (30, 0, None, 8), (31, 5, 3, 10),
])
def test_chunk_walls_have_the_jax_chunks(max_iter, launch_chunk, callback_chunk, stop_check_every):
    """``collect_chunk_walls``: one (size, seconds) per chunk, the sizes the
    JAX package's for the same launch_chunk, callback_chunk and
    stop_check_every; the callback sees every iteration once."""
    walls, seen = {}, {}
    for name, cls, obj, x0 in (("port", AcceleratedGradientDescent, PortQuadratic(), torch.zeros(2)),
                               ("jax", JaxAGD, JaxQuadratic(), jnp.zeros(2, jnp.float32))):
        seen[name] = []
        kw = dict(max_iter=max_iter, gamma=None, initial_step_size=1e-3, launch_chunk=launch_chunk)
        if callback_chunk:
            kw.update(callback_chunk=callback_chunk, iteration_callback=lambda i, r, s=seen[name]: s.append(i))
        if stop_check_every:
            kw.update(stop_condition=lambda i, y: False, stop_check_every=stop_check_every)
        solver = cls(**kw)
        solver.collect_chunk_walls = True
        solver.chunk_walls = [(0, 0.0)]  # emptied by maximize
        solver.maximize(obj, x0)
        walls[name] = solver.chunk_walls
    assert [s for s, _ in walls["port"]] == [s for s, _ in walls["jax"]]
    assert sum(s for s, _ in walls["port"]) == max_iter and all(w >= 0 for _, w in walls["port"])
    assert seen["port"] == seen["jax"] == (list(range(1, max_iter + 1)) if callback_chunk else [])


class JaxValley:
    """gamma * (-(x-3)^2 - 25 (y-5)^2): curvatures 2 and 50, where Nesterov's
    momentum overshoots and the restart tests fire; gamma scales it, so its
    decay shows in the log."""

    equality_mask = None

    def calculate(self, dual_val, gamma=None, **kwargs):
        x, y = dual_val[0], dual_val[1]
        return JaxResult(dual_gradient=jnp.stack([-2.0 * (x - 3.0), -50.0 * (y - 5.0)]) * gamma,
                         dual_objective=(-((x - 3.0) ** 2) - 25.0 * (y - 5.0) ** 2) * gamma)


class PortValley:
    equality_mask = None

    def calculate(self, dual_val, gamma=None, **kwargs):
        x, y = dual_val[0], dual_val[1]
        return ObjectiveResult(dual_gradient=torch.stack([-2.0 * (x - 3.0), -50.0 * (y - 5.0)]) * gamma,
                               dual_objective=(-((x - 3.0) ** 2) - 25.0 * (y - 5.0) ** 2) * gamma)


VALLEY = dict(max_iter=60, gamma=1.0, initial_step_size=1e-2, max_step_size=1.0, gamma_decay_type="step",
              gamma_decay_params={"decay_steps": 15, "decay_factor": 0.5}, restart_min_spacing=5)


@pytest.mark.parametrize("restart", [None, "gradient", "function"])
def test_decay_and_restart_match_jax(restart):
    """Gamma step decay across three ``decay_steps`` boundaries with either
    restart scheme (or none): the logs, the step sizes, the final dual and
    the decayed gamma against the JAX package's; each scheme restarts (its
    log leaves the plain one)."""
    kw = dict(VALLEY, restart=restart)
    ref_solver, port_solver = JaxAGD(**kw), AcceleratedGradientDescent(**kw)
    ref = ref_solver.maximize(JaxValley(), jnp.zeros(2, jnp.float32))
    got = port_solver.maximize(PortValley(), torch.zeros(2))
    _close(got.dual_objective_log, ref.dual_objective_log)
    _close(got.step_size_log, ref.step_size_log)
    _close(got.dual_val.numpy(), np.asarray(ref.dual_val))
    assert port_solver.gamma == ref_solver.gamma == pytest.approx(0.5 ** 4, rel=1e-6)
    if restart is not None:
        plain = AcceleratedGradientDescent(**VALLEY).maximize(PortValley(), torch.zeros(2))
        assert plain.dual_objective_log[:30] == got.dual_objective_log[:30]
        assert plain.dual_objective_log[-1] != got.dual_objective_log[-1]


def test_first_iterations_of_the_window_match_jax():
    """The first 15 iterations: the initial step until the window of 15
    pairs is full (the count on the device), then the secant step, as in the
    JAX package."""
    jax_obj, port_obj = _matching()
    kw = dict(max_iter=15, gamma=1e-3, initial_step_size=1e-3)
    ref = JaxAGD(**kw).maximize(jax_obj, jnp.full(5, 0.1, jnp.float32))
    got = AcceleratedGradientDescent(**kw).maximize(port_obj, torch.full((5,), 0.1))
    _close(got.dual_objective_log, ref.dual_objective_log)
    assert got.step_size_log[:14] == [np.float32(1e-3)] * 14
    _close(got.step_size_log, ref.step_size_log)
    state = init_step_size_state(5)
    assert state.count.dtype == torch.int32 and state.count.dim() == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_warm_start_from_either_packages_checkpoint(writer, tmp_path):
    """A dual and its step-size window written by one package's
    ``save_dual`` and read by each package's ``load_dual``: both warm
    starts give the same next iterations within 1e-5."""
    jax_obj, port_obj = _matching()
    first = JaxAGD(max_iter=20, gamma=1e-3, initial_step_size=1e-3)
    dual = np.asarray(first.maximize(jax_obj, jnp.full(5, 0.1, jnp.float32)).dual_val)
    state = jax_init(5)  # a full window, pushed by the JAX package's own step-size function
    for k in range(20):
        _, state = jax_step(jnp.ones(5) * (k + 1), jnp.full(5, 0.1 * k), state, 1e-3, jnp.float32(0.1))
    path = tmp_path / "dual.npz"
    if writer == "jax":
        jax_save_dual(str(path), dual, state)
    else:
        save_dual(str(path), dual, StepSizeState(torch.tensor(np.asarray(state.grad_hist)),
                                                 torch.tensor(np.asarray(state.dual_hist)),
                                                 torch.tensor(int(state.count), dtype=torch.int32)))
    with np.load(path) as data:
        assert data["count"].dtype == np.int32 and int(data["count"]) == 15
    p_dual, p_state = load_dual(str(path))
    j_dual, j_state = jax_load_dual(str(path))
    assert p_state.count.dtype == torch.int32 and int(p_state.count) == int(j_state.count) == 15
    np.testing.assert_array_equal(p_state.grad_hist.numpy(), np.asarray(j_state.grad_hist))
    kw = dict(max_iter=10, gamma=1e-3, initial_step_size=1e-3)
    got = AcceleratedGradientDescent(**kw).maximize(port_obj, torch.from_numpy(p_dual),
                                                    initial_step_size_state=p_state)
    ref = JaxAGD(**kw).maximize(jax_obj, jnp.asarray(j_dual), initial_step_size_state=j_state)
    _close(got.dual_objective_log, ref.dual_objective_log)
    _close(got.step_size_log, ref.step_size_log)
    assert got.step_size_log[0] != np.float32(1e-3)  # the full window: the secant step from iteration 1
    # an int count is taken as well as a tensor
    again = AcceleratedGradientDescent(**kw).maximize(
        port_obj, torch.from_numpy(p_dual), initial_step_size_state=p_state._replace(count=15))
    assert again.dual_objective_log == got.dual_objective_log


def _timing_lines(text):
    return [re.sub(r"\d+\.\d+s$", "Ns", ln) for ln in text.splitlines() if ln.startswith("[timing]")]


def test_dualip_timing_prints_the_jax_lines(monkeypatch, capsys):
    monkeypatch.setenv("DUALIP_TIMING", "1")
    AcceleratedGradientDescent(max_iter=10, gamma=None, launch_chunk=4).maximize(PortQuadratic(), torch.zeros(2))
    port = _timing_lines(capsys.readouterr().out)
    JaxAGD(max_iter=10, gamma=None, launch_chunk=4).maximize(JaxQuadratic(), jnp.zeros(2, jnp.float32))
    ref = _timing_lines(capsys.readouterr().out)
    assert port == ref == ["[timing] chunk pos=0 size=4: Ns", "[timing] chunk pos=4 size=4: Ns",
                           "[timing] chunk pos=8 size=2: Ns", "[timing] drain: Ns"]
    monkeypatch.delenv("DUALIP_TIMING")
    AcceleratedGradientDescent(max_iter=3, gamma=None).maximize(PortQuadratic(), torch.zeros(2))
    assert _timing_lines(capsys.readouterr().out) == []


def _emulated_capture(self):
    """``_Graph._capture`` without a card: the "graph" runs the captured
    iteration again at each replay, on the same static buffers."""
    self.graph = types.SimpleNamespace(replay=self._advance)


@pytest.mark.parametrize("case", ["plain", "restart and decay", "stop", "chunks and callback"])
def test_graph_buffers_give_the_eager_bits(case, monkeypatch):
    """The graph path's static buffers (iteration 1 on them, the copies of
    each iteration's outputs over its inputs, a repeated maximize loading
    its start into the cached buffers) give the eager loop's log, dual,
    gradient and step sizes bit for bit; replays are emulated on the CPU."""
    monkeypatch.setattr(agd_mod._Graph, "_capture", _emulated_capture)
    _, obj = _matching()
    kw = dict(max_iter=25, gamma=1e-3, initial_step_size=1e-3)
    if case == "restart and decay":
        obj, kw = PortValley(), dict(VALLEY, restart="gradient")
    elif case == "stop":
        kw.update(stop_condition=lambda i, y: i >= 15 and bool(y.sum() > 0), stop_check_every=5)
    elif case == "chunks and callback":
        kw.update(launch_chunk=6, callback_chunk=4, iteration_callback=lambda i, r: None)
    m = 2 if isinstance(obj, PortValley) else 5
    solver = AcceleratedGradientDescent(**kw)
    for start in (0.1, 0.1, 0.2):  # the second and third maximize reuse the cached buffers
        got = solver._maximize(obj, torch.full((m,), start), 0, None, graph=True)
        eager = AcceleratedGradientDescent(**kw)
        want = eager._maximize_eager(obj, torch.full((m,), start))
        assert got.dual_objective_log == want.dual_objective_log
        assert got.step_size_log == want.step_size_log
        assert torch.equal(got.dual_val, want.dual_val)
        assert torch.equal(got.objective_result.dual_gradient, want.objective_result.dual_gradient)
        assert solver.gamma == eager.gamma
        solver.gamma = kw["gamma"]  # maximize tracks the decayed gamma, as the JAX package's does
    if case == "restart and decay":  # the restart fired
        assert got.dual_objective_log != AcceleratedGradientDescent(**VALLEY).maximize(
            obj, torch.full((m,), 0.2)).dual_objective_log
    assert len(solver._jit_cache) == 1
    g = next(iter(solver._jit_cache.values()))
    assert got.dual_val.data_ptr() != g.carry.y.data_ptr()  # the result is a copy of the static buffer


@pytest.mark.parametrize("rebound", ["b_vec", "bcsc", "max_iter"])
def test_a_cached_graph_reads_the_params_of_its_call(rebound, monkeypatch):
    """A second graph solve on one solver after the objective's ``b_vec`` or
    ``bcsc`` (or the solver's ``max_iter``) was rebound computes with the new
    values: the eager loop's log, dual and gradient bit for bit (the eager
    loop of a new solver with the new ``max_iter``), the log and step sizes
    within 1e-5 of the JAX package's solve of the new problem, after one more
    capture;
    a call with nothing changed replays without one, and the cache keeps one
    graph."""
    captures = []

    def capture(self):
        captures.append(self)
        _emulated_capture(self)

    monkeypatch.setattr(agd_mod._Graph, "_capture", capture)
    kw = dict(max_iter=25, gamma=1e-3, initial_step_size=1e-3)
    _, obj = _matching()
    solver = AcceleratedGradientDescent(**kw)
    x0 = torch.full((5,), 0.1)
    first = solver._maximize(obj, x0, 0, None, graph=True)
    again = solver._maximize(obj, x0, 0, None, graph=True)
    assert len(captures) == 1 and again.dual_objective_log == first.dual_objective_log

    if rebound == "max_iter":  # longer than the cached metrics table and beta sequence
        jax_new, kw["max_iter"] = None, 30
        solver.max_iter = 30
    else:
        jax_new, new = _matching(b=0.3) if rebound == "b_vec" else _matching(A=A_COMPACT)
        setattr(obj, rebound, getattr(new, rebound))
    got = solver._maximize(obj, x0, 0, None, graph=True)
    want = AcceleratedGradientDescent(**kw)._maximize_eager(obj, x0)
    assert got.dual_objective_log[-1] == want.dual_objective_log[-1] != first.dual_objective_log[-1]
    assert got.dual_objective_log == want.dual_objective_log
    assert len(captures) == 2 and len(solver._jit_cache) == 1
    assert torch.equal(got.dual_val, want.dual_val)
    assert torch.equal(got.objective_result.dual_gradient, want.objective_result.dual_gradient)
    if jax_new is not None:
        ref = JaxAGD(**kw).maximize(jax_new, jnp.full(5, 0.1, jnp.float32))
        _close(got.dual_objective_log, ref.dual_objective_log)
        _close(got.step_size_log, ref.step_size_log)
    assert solver._maximize(obj, x0, 0, None, graph=True).dual_objective_log == got.dual_objective_log
    assert len(captures) == 2


def test_run_solver_passes_launch_chunk():
    """``SolverArgs.launch_chunk`` reaches the maximizer through
    ``run_solver`` (1 is clamped, with the warning)."""
    import dualip_tpu_torch

    A = A_COMPACT.T
    args = MatchingInputArgs(A=csc_from_dense(A), c=csc_from_dense(-A),
                             projection_map=create_projection_map("simplex", {"z": 1}, 5),
                             b_vec=np.full(5, 0.7, dtype=np.float32))
    with pytest.warns(UserWarning, match="clamped to 2"):
        res = dualip_tpu_torch.run_solver(args, dualip_tpu_torch.SolverArgs(max_iter=5, launch_chunk=1),
                                          dualip_tpu_torch.ComputeArgs(host_device="cpu"),
                                          dualip_tpu_torch.ObjectiveArgs())
    assert len(res.dual_objective_log) == 5
