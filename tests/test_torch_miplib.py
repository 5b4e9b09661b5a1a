"""The port's general-LP objective against the JAX package on the CPU
(mirrors of ``tests/objectives/test_miplib_objective.py``,
``tests/test_equality_constraints.py`` and ``tests/test_early_stopping.py``).

Per ``calculate`` at the same dual, the port agrees with the JAX package to
float32 reassociation: the gradient within 1e-5 of its largest entry, the
objective and penalty to 1e-5 relative (COO sums in the segment-sum's fixed
order, XLA in its own; butterfly sums lanes).  Whole solves are held to the
reference's own assertions, and to the JAX package's final dual objective
at 1e-4 relative (the Lipschitz window amplifies float32 noise)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dualip_tpu.objectives.miplib import MIPLIB2017ObjectiveFunction as JaxMIPLIB
from dualip_tpu.objectives.miplib import MIPLIBInputArgs as JaxArgs
from dualip_tpu.optimizers.agd import AcceleratedGradientDescent as JaxAGD
from dualip_tpu.projections import ProjectionEntry as JaxEntry
from dualip_tpu.projections import create_projection_map as jax_pm
from dualip_tpu.sparse import csc_from_dense as jax_csc
from dualip_tpu_torch import ComputeArgs, ObjectiveArgs, SolverArgs, run_solver
from dualip_tpu_torch.objectives.miplib import MIPLIB2017ObjectiveFunction, MIPLIBInputArgs
from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent, project_on_nn_cone
from dualip_tpu_torch.projections import ProjectionEntry, create_projection_map
from dualip_tpu_torch.sparse import csc_from_dense

torch.set_num_threads(1)


def _pair(A, c, b, pm_fn, eq=None, sparse=False, **kw):
    """(port objective on the CPU, JAX objective) on the same inputs; pm_fn
    builds the map from either package's (ProjectionEntry, create_projection_map)."""
    port = MIPLIB2017ObjectiveFunction(
        MIPLIBInputArgs(A=csc_from_dense(A) if sparse else A, c=c, projection_map=pm_fn(ProjectionEntry,
                        create_projection_map), b_vec=b, equality_mask=eq), device="cpu", **kw)
    ref = JaxMIPLIB(JaxArgs(A=jax_csc(A) if sparse else A, c=c, projection_map=pm_fn(JaxEntry, jax_pm), b_vec=b,
                            equality_mask=eq), **kw)
    return port, ref


def _same_result(got, ref, rtol=1e-5):
    g_ref = np.asarray(ref.dual_gradient)
    np.testing.assert_allclose(got.dual_gradient.numpy(), g_ref, atol=1e-5 * max(1.0, np.abs(g_ref).max()))
    for f in ("dual_objective", "reg_penalty"):
        w = float(getattr(ref, f))
        assert float(getattr(got, f)) == pytest.approx(w, rel=rtol, abs=1e-6), f


SMALL = dict(
    A=np.array([[1.0, 1.0, 1.0, 0.0], [2.0, -1.0, 0.0, 1.0], [-1.0, 0.0, 4.0, -1.0]], np.float32),
    c=np.array([2.0, 3.0, -1.0, 4.0], np.float32),
    b=np.array([5.0, 3.0, 2.0], np.float32),
    pm_fn=lambda E, cpm: {
        "bound_1": E("box", {"l": 0.0, "u": 3.0}, indices=[0]),
        "bound_2": E("box", {"l": 1.0, "u": 4.0}, indices=[1]),
        "bound_3": E("box", {"l": 0.0, "u": float("nan")}, indices=[2]),
        "bound_4": E("box", {"l": -2.0, "u": 2.0}, indices=[3]),
    },
    eq=np.array([False, False, False]),
)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "coo"])
def test_convergence_bound_matches_the_jax_package(sparse):
    port, ref = _pair(**SMALL, sparse=sparse)
    for dual, x, tol in (([0.0, 0.0, 0.25], None, 1e-5), ([0.0, -0.01, 0.26], None, 1e-1),
                         ([0.0, -0.01, 0.26], None, 1e-5), ([0.1, 0.2, 0.3], [0.5, 1.5, 0.2, -1.0], 1e-5)):
        got = port.calculate_convergence_bound(torch.tensor(dual), x=x, optimal_primal_obj=3.0, tol=tol)
        want = ref.calculate_convergence_bound(jnp.asarray(dual, jnp.float32),
                                               x=None if x is None else jnp.asarray(x, jnp.float32),
                                               optimal_primal_obj=3.0, tol=tol)
        np.testing.assert_allclose(got[:4], [float(v) for v in want[:4]], rtol=1e-5, atol=1e-7)
        assert got[4] == want[4]
    # the reference's three verdicts
    assert port.calculate_convergence_bound(torch.tensor([0.0, 0.0, 0.25]), tol=1e-5)[4]
    assert port.calculate_convergence_bound(torch.tensor([0.0, -0.01, 0.26]), tol=1e-1)[4]
    assert not port.calculate_convergence_bound(torch.tensor([0.0, -0.01, 0.26]), tol=1e-5)[4]


def _random_lp(seed, m, n, cut=0.6):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    A[np.abs(A) < cut] = 0.0
    A[0, :] = np.where(A[0, :] == 0, 0.3, A[0, :])
    return A, rng.normal(size=n).astype(np.float32), rng.normal(size=m).astype(np.float32)


CALC_CASES = [
    ("dense", dict(sparse=False)),
    ("coo", dict(sparse=True)),
    ("dense jacobi", dict(sparse=False, use_jacobi_precondition=True)),
    ("coo jacobi", dict(sparse=True, use_jacobi_precondition=True)),
    ("butterfly", dict(sparse=True, layout="butterfly")),
    ("butterfly jacobi", dict(sparse=True, layout="butterfly", use_jacobi_precondition=True)),
    ("coo bf16 inputs", dict(sparse=True, dtype=np.dtype(jnp.bfloat16))),
]


@pytest.mark.parametrize("name,kw", CALC_CASES, ids=[c[0] for c in CALC_CASES])
def test_calculate_matches_the_jax_package(name, kw):
    """Mixed box / cone / simplex entries over 120 variables, save_primal on."""
    A, c, b = _random_lp(4, 20, 120, cut=1.0)

    def pm(E, cpm):
        idx = np.arange(120)
        return {"box": E("box", {"l": -1.0, "u": 1.0}, idx[:60]), "cone": E("cone", {"lower": 0.0}, idx[60:90]),
                "simplex": E("simplex", {"z": 2.0}, idx[90:])}

    port, ref = _pair(A, c, b, pm, **kw)
    for seed in range(3):
        lam = np.abs(np.random.default_rng(seed).normal(size=20)).astype(np.float32)
        got = port.calculate(torch.from_numpy(lam), gamma=1e-2, save_primal=True)
        want = ref.calculate(jnp.asarray(lam), gamma=1e-2, save_primal=True)
        _same_result(got, want)
        x_ref = np.asarray(want.primal_var)
        np.testing.assert_allclose(got.primal_var.numpy(), x_ref, atol=1e-5 * max(1.0, np.abs(x_ref).max()))
        assert float(got.primal_objective) == pytest.approx(float(want.primal_objective), rel=1e-5, abs=1e-6)
    if kw.get("use_jacobi_precondition"):
        inv = port.invert_jacobi_precondition(torch.from_numpy(lam), got.dual_gradient)
        rinv = ref.invert_jacobi_precondition(jnp.asarray(lam), want.dual_gradient)
        for g, r in zip(inv, rinv):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


def test_later_entry_overrides_an_earlier_one():
    """Indexed projections run in map order, reading what earlier entries
    wrote (``.at[idx].set``): here the box [0, 1] then the box [0.5, 2] on
    an overlapping index."""
    A, c, b = _random_lp(2, 4, 6)

    def pm(E, cpm):
        return {"a": E("box", {"l": 0.0, "u": 1.0}, [0, 1, 2, 3]), "b": E("box", {"lower": 0.5, "upper": 2.0}, [2, 3, 4])}

    port, ref = _pair(A, c, b, pm, sparse=True)
    lam = np.abs(np.random.default_rng(0).normal(size=4)).astype(np.float32)
    got = port.calculate(torch.from_numpy(lam), gamma=1e-1, save_primal=True)
    want = ref.calculate(jnp.asarray(lam), gamma=1e-1, save_primal=True)
    np.testing.assert_allclose(got.primal_var.numpy(), np.asarray(want.primal_var), atol=1e-6)
    assert float(got.primal_var[2]) >= 0.5 and float(got.primal_var[2]) <= 1.0


SOLVES = [
    # (name, A, c, b, map, solver kwargs, the reference's assertion on the final dual objective)
    ("box", [[4.0, 1.0], [1.0, 2.0]], [-1.0, -1.0], [2.0, 1.0], ("box", {"lower": 0.0, "upper": 1.0}),
     dict(max_iter=500, gamma=1e-3), -5.0 / 7.0),
    ("cone lower", [[4.0, 1.0], [1.0, 2.0]], [-1.0, -1.0], [2.0, 1.0], ("cone", {"lower": 0.0}),
     dict(initial_step_size=1e-6, max_step_size=1e-5, max_iter=10000, gamma=1e-3), None),
    ("cone upper", [[4.0, 1.0], [1.0, 2.0]], [-1.0, -1.0], [2.0, 1.0], ("cone", {"upper": 1.0}),
     dict(initial_step_size=1e-6, max_step_size=1e-5, max_iter=10000, gamma=1e-3), None),
]


@pytest.mark.parametrize("name,A,c,b,proj,skw,want", SOLVES, ids=[s[0] for s in SOLVES])
def test_solve_matches_the_jax_package(name, A, c, b, proj, skw, want):
    """The reference's solves of min -x1-x2 s.t. 4x1+x2<=2, x1+2x2<=1
    (optimum -5/7 at the dual (1/7, 3/7)), certified with the known dual."""
    A, c, b = (np.asarray(v, np.float32) for v in (A, c, b))
    port, ref = _pair(A, c, b, lambda E, cpm: cpm(proj[0], proj[1], 2, indices=[0, 1]))
    got = AcceleratedGradientDescent(save_primal=True, **skw).maximize(port, torch.zeros(2))
    r = JaxAGD(save_primal=True, **skw).maximize(ref, jnp.zeros(2, jnp.float32))
    assert got.dual_objective == pytest.approx(r.dual_objective, rel=1e-4, abs=1e-5)
    if want is not None:
        assert abs(got.dual_objective - want) < 1e-2
    optimal_dual = torch.tensor([0.14285714, 0.42857143])
    *_, converged = port.calculate_convergence_bound(optimal_dual, x=got.objective_result.primal_var, tol=1e-3)
    assert converged


def test_equality_constraint_solve():
    """min x1 + 2 x2 s.t. x1 + x2 = 4, 0 <= x1 <= 1: optimum 7, the equality
    row's dual free to reach -2."""
    y = torch.tensor([-1.0, -1.0, 2.0, -3.0, 4.0])
    mask = torch.tensor([False, True, False, True, False])
    assert project_on_nn_cone(y, mask).tolist() == [0.0, -1.0, 2.0, -3.0, 4.0]
    port, ref = _pair(np.array([[1.0, 1.0]], np.float32), np.array([1.0, 2.0], np.float32),
                      np.array([4.0], np.float32), lambda E, cpm: cpm("box", {"upper": 1}, 2, indices=[0]),
                      eq=np.array([True]))
    res = AcceleratedGradientDescent(max_iter=1000, gamma=1e-5).maximize(port, torch.zeros(1))
    assert abs(res.dual_objective - 7.0) < 1e-4
    assert abs(float(res.dual_val[0]) - (-2.0)) < 1e-3
    r = JaxAGD(max_iter=1000, gamma=1e-5).maximize(ref, jnp.zeros(1, jnp.float32))
    assert res.dual_objective == pytest.approx(r.dual_objective, rel=1e-5)


@pytest.mark.parametrize("mode", ["stops", "none", "never"])
def test_stop_condition(mode):
    """The PDLP test as AGD's stop condition, checked every 50 iterations."""
    A = np.array([[4.0, 1.0], [1.0, 2.0]], np.float32)
    port, _ = _pair(A, np.array([-1.0, -1.0], np.float32), np.array([2.0, 1.0], np.float32),
                    lambda E, cpm: cpm("box", {"lower": 0.0, "upper": 1.0}, 2))
    checks = []
    if mode == "stops":
        base = port.convergence_stop_condition(tol=5e-3, gamma=1e-3)

        def stop(i, d):
            checks.append(i)
            return base(i, d)

        solver = AcceleratedGradientDescent(max_iter=5000, gamma=1e-3, stop_condition=stop, stop_check_every=50)
    elif mode == "never":
        solver = AcceleratedGradientDescent(max_iter=120, gamma=1e-3, stop_condition=lambda i, d: False,
                                            stop_check_every=40)
    else:
        solver = AcceleratedGradientDescent(max_iter=120, gamma=1e-3)
    res = solver.maximize(port, torch.zeros(2))
    n = len(res.dual_objective_log)
    if mode == "stops":
        assert n < 5000 and n % 50 == 0
        assert checks == list(range(50, n + 1, 50))
        assert abs(res.dual_objective - (-5.0 / 7.0)) < 2e-2
    else:
        assert n == 120


def test_run_solver_runs_miplib2017_with_jacobi():
    """``objective_type="miplib2017"`` through run_solver on both sparse
    layouts, the dual mapped back from the row-scaled problem."""
    A, c, b = _random_lp(7, 12, 60)
    b = np.abs(b) + 1.0
    logs = []
    for layout in ("coo", "butterfly"):
        res = run_solver(
            MIPLIBInputArgs(A=csc_from_dense(A), c=c, projection_map=create_projection_map("box", {"l": 0.0, "u": 1.0}, 60),
                            b_vec=b),
            SolverArgs(max_iter=40, gamma=1e-2), ComputeArgs(host_device="cpu"),
            ObjectiveArgs(objective_type="miplib2017", use_jacobi_precondition=True,
                          objective_kwargs={"layout": layout}),
        )
        assert res.dual_val.device.type == "cpu" and len(res.dual_objective_log) == 40
        logs.append(np.asarray(res.dual_objective_log))
    np.testing.assert_allclose(logs[1], logs[0], rtol=1e-4, atol=1e-5)
    ref = JaxAGD(max_iter=40, gamma=1e-2).maximize(
        JaxMIPLIB(JaxArgs(A=jax_csc(A), c=c, projection_map=jax_pm("box", {"l": 0.0, "u": 1.0}, 60), b_vec=b),
                  use_jacobi_precondition=True), jnp.zeros(12, jnp.float32))
    np.testing.assert_allclose(logs[0][:15], np.asarray(ref.dual_objective_log)[:15], rtol=1e-5)


def test_refusals():
    A, c, b = _random_lp(1, 4, 6)
    args = MIPLIBInputArgs(A=A, c=c, projection_map=create_projection_map("box", {}, 6), b_vec=b)
    with pytest.raises(ValueError, match="sparse A"):
        MIPLIB2017ObjectiveFunction(args, layout="butterfly", device="cpu")
    with pytest.raises(ValueError, match="Unknown layout"):
        MIPLIB2017ObjectiveFunction(args, layout="csr", device="cpu")
    with pytest.raises(TypeError, match="EntityMesh"):
        MIPLIB2017ObjectiveFunction(args, mesh=object(), device="cpu")
    obj = MIPLIB2017ObjectiveFunction(MIPLIBInputArgs(A=A, c=c, projection_map={"f": ProjectionEntry("box", {},
                                      [0])}, b_vec=b), device="cpu")
    with pytest.raises(ValueError, match="Unbounded x"):
        obj.calculate_convergence_bound(torch.zeros(4))
