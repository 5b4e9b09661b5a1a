"""The port's matching objective and AGD maximizer against the JAX package,
and the pinned golden traces through the port.

Objective tolerances: gradient atol 1e-4, objective and penalty rtol 1e-4
(both sum in other orders).  Golden traces: 1e-5, as the JAX package's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dualip_tpu.objectives.matching import (
    MatchingInputArgs as JaxArgs,
    MatchingSolverDualObjectiveFunction as JaxObjective,
)
from dualip_tpu.projections import create_projection_map as jax_pm
from dualip_tpu.sparse import csc_from_dense as jax_csc
from dualip_tpu_torch.objectives.matching import MatchingInputArgs, MatchingSolverDualObjectiveFunction
from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent, compute_beta_seq, project_on_nn_cone
from dualip_tpu_torch.optimizers.agd_utils import calculate_step_size, init_step_size_state
from dualip_tpu_torch.projections import create_projection_map
from dualip_tpu_torch.sparse import csc_from_dense
from dualip_tpu_torch.types import ObjectiveResult
from dualip_tpu.optimizers.agd import compute_beta_seq as jax_beta_seq
from tests.objectives.test_dualip_matching_simplex import A_COMPACT, TRUE_VALUES

torch.set_num_threads(1)


def _random_problem():
    """The random problem of tests/ops/test_pallas_matching.py."""
    rng = np.random.default_rng(3)
    m, n = 32, 300
    dense = np.abs(rng.normal(size=(m, n))).astype(np.float32)
    dense[rng.random(size=(m, n)) < 0.7] = 0.0
    dense[0] = np.where(dense[0] == 0, 0.1, dense[0])
    b = np.abs(rng.normal(size=m)).astype(np.float32)
    lam = np.abs(rng.normal(size=m)).astype(np.float32)
    return dense, b, lam


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("save_primal", [False, True])
def test_objective_matches_jax(use_pallas, save_primal):
    dense, b, lam = _random_problem()
    n = dense.shape[1]
    kwargs = {"use_pallas": use_pallas, "pallas_block_k": 64}
    neg = np.where(dense != 0, -dense, 0).astype(np.float32)
    ref = JaxObjective(
        JaxArgs(A=jax_csc(dense), c=jax_csc(neg), projection_map=jax_pm("simplex", {"z": 1}, n), b_vec=b),
        gamma=1e-2, **kwargs,
    ).calculate(jnp.asarray(lam), save_primal=save_primal)
    got = MatchingSolverDualObjectiveFunction(
        MatchingInputArgs(
            A=csc_from_dense(dense), c=csc_from_dense(neg),
            projection_map=create_projection_map("simplex", {"z": 1}, n), b_vec=b,
        ),
        gamma=1e-2, device="cpu", **kwargs,
    ).calculate(lam, save_primal=save_primal)

    np.testing.assert_allclose(got.dual_gradient.numpy(), np.asarray(ref.dual_gradient), atol=1e-4)
    for name in ("dual_objective", "reg_penalty", "dual_val_times_grad", "sum_pos_slack"):
        assert np.isclose(float(getattr(got, name)), float(getattr(ref, name)), rtol=1e-4, atol=1e-6), name
    assert np.isclose(float(got.max_pos_slack), float(ref.max_pos_slack), atol=1e-4)
    if save_primal:
        x_ref = np.asarray(ref.primal_var)
        assert got.primal_var.shape == x_ref.shape == (int((dense != 0).sum()),)
        np.testing.assert_allclose(got.primal_var, x_ref, atol=5e-5 * max(1.0, np.abs(x_ref).max()))
        assert np.isclose(float(got.primal_objective), float(ref.primal_objective), rtol=1e-4)


def _scala_objective(**kwargs):
    A = csc_from_dense(A_COMPACT.T)
    C = csc_from_dense(-A_COMPACT.T)
    b = np.full(5, 0.7, dtype=np.float32)
    pm = create_projection_map("simplex", {"z": 1}, A.shape[1])
    return MatchingSolverDualObjectiveFunction(
        MatchingInputArgs(A=A, c=C, projection_map=pm, b_vec=b), gamma=1e-3, device="cpu", **kwargs
    )


@pytest.mark.parametrize("kwargs", [{}, {"use_pallas": True, "pallas_block_k": 8}])
def test_matching_golden_trace(kwargs):
    """The 5x5 Scala trace (tests/objectives/test_dualip_matching_simplex.py)."""
    solver = AcceleratedGradientDescent(max_iter=30, gamma=1e-3)
    res = solver.maximize(_scala_objective(**kwargs), torch.full((5,), 0.1))
    for i, true_val in TRUE_VALUES:
        got = res.dual_objective_log[i - 1]
        assert abs(got - true_val) < 1e-5, f"iter {i}: {got} vs {true_val}"


def test_matching_save_primal_through_solver():
    solver = AcceleratedGradientDescent(max_iter=5, gamma=1e-3, save_primal=True)
    res = solver.maximize(_scala_objective(use_pallas=True, pallas_block_k=8), torch.zeros(5))
    x = res.objective_result.primal_var
    assert x.shape == (25,) and np.all(x >= 0)
    assert np.all(np.add.reduceat(x, np.arange(0, 25, 5)) <= 1.0 + 1e-5)


class SimpleObjective:
    """f(x, y) = -(x-3)^2 - (y+5)^2 (tests/test_agd.py)."""

    equality_mask = None

    def calculate(self, dual_val, save_primal=False, **kwargs):
        x, y = dual_val[0], dual_val[1]
        obj = -((x - 3.0) ** 2) - (y + 5.0) ** 2
        grad = torch.stack([-2.0 * (x - 3.0), -2.0 * (y + 5.0)])
        return ObjectiveResult(dual_gradient=grad, dual_objective=obj)


def test_agd_golden_trace():
    solver = AcceleratedGradientDescent(max_iter=30, gamma=None, initial_step_size=1e-5)
    res = solver.maximize(SimpleObjective(), torch.zeros(2))
    true_values = [
        (2, -33.9996400036),
        (16, -28.60551547593112),
        (23, -25.473701313626133),
        (29, -25.00382134903756),
    ]
    for i, true_val in true_values:
        got = res.dual_objective_log[i - 1]
        assert abs(got - true_val) < 1e-5, f"iteration {i}: expected {true_val}, got {got}"
    assert len(res.dual_objective_log) == len(res.step_size_log) == 30
    assert res.dual_objective == res.dual_objective_log[-1]


def test_agd_first_step_and_callback():
    seen = []
    solver = AcceleratedGradientDescent(
        max_iter=5, gamma=None, initial_step_size=0.1, iteration_callback=lambda i, r: seen.append(i)
    )
    res = solver.maximize(SimpleObjective(), torch.zeros(2))
    assert seen == [1, 2, 3, 4, 5]
    assert np.isfinite(res.dual_objective)


def test_gamma_decay_and_stop_condition():
    class GammaProbe:
        equality_mask = None
        params = ()

        def calculate_traceable(self, params, dual_val, gamma):
            return ObjectiveResult(dual_gradient=torch.zeros_like(dual_val), dual_objective=gamma)

    solver = AcceleratedGradientDescent(
        max_iter=6, gamma=1.0, gamma_decay_type="step",
        gamma_decay_params={"decay_steps": 2, "decay_factor": 0.5},
    )
    res = solver.maximize(GammaProbe(), torch.zeros(3))
    assert np.allclose(res.dual_objective_log, [1.0, 1.0, 0.5, 0.5, 0.25, 0.25])
    stopper = AcceleratedGradientDescent(
        max_iter=50, gamma=1.0, stop_condition=lambda it, y: it >= 20, stop_check_every=10
    )
    assert len(stopper.maximize(GammaProbe(), torch.zeros(3)).dual_objective_log) == 20


def test_beta_seq_step_size_and_cone_match_jax():
    np.testing.assert_array_equal(compute_beta_seq(200), jax_beta_seq(200))
    y = torch.tensor([-1.0, -1.0, 2.0, -3.0, 4.0])
    mask = torch.tensor([False, True, False, True, False])
    assert project_on_nn_cone(y, mask).tolist() == [0.0, -1.0, 2.0, -3.0, 4.0]
    # window not full -> initial step; full with a zero estimate -> max step
    state = init_step_size_state(3, history_length=3)
    g = torch.ones(3)
    for k in range(3):
        step, state = calculate_step_size(g, torch.full((3,), float(k)), state, 1e-5, torch.tensor(0.1))
    assert int(state.count) == 3 and float(step) == np.float32(0.1)
    assert state.count.dtype == torch.int32 and state.count.dim() == 0  # on the device, as in the JAX package
    _, s1 = calculate_step_size(g, torch.zeros(3), init_step_size_state(3, 3), 1e-5, torch.tensor(0.1))
    assert int(s1.count) == 1


def test_later_slice_options_raise():
    """The mesh is in (distributed slice) and takes an ``EntityMesh`` only.
    The tile cache is in (I/O slice); layouts it does not serve ignore it and
    write nothing."""
    for kwargs in ({"mesh": object()}, {"layout": "butterfly", "mesh": object()}):
        with pytest.raises(TypeError, match="EntityMesh"):
            _scala_objective(**kwargs)
    for kwargs in ({"tile_cache_dir": "/nonexistent/x"}, {"layout": "butterfly", "tile_cache_dir": "/nonexistent/x"}):
        assert _scala_objective(**kwargs).tile_cache_key is None
