"""The port's exact matching certificate against the JAX package and against
scipy's HiGHS on the edge-level LP (a mirror of
``tests/objectives/test_exact_certificate.py``).

At the same dual, the port's ``primal_ub`` and ``dual_lb`` equal the JAX
package's to 1e-5 relative on csc and butterfly (the same float32
arithmetic, summed in another order).  Across the port's own layouts they
agree to 2e-4 relative, the JAX test's tolerance (the bf16 carry of the
solve does not reach the certificate, which carries in the dual's dtype).

With ``use_pallas=True`` the tiles are (L, K): the JAX package's certificate
reads them as (K, L) and stops with a shape error there, so the port's is
held to the port's own csc result."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dualip_tpu.objectives.matching import MatchingSolverDualObjectiveFunction as JaxObjective
from dualip_tpu_torch.objectives.matching import MatchingSolverDualObjectiveFunction
from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent
from dualip_tpu_torch.parallel import EntityMesh
from dualip_tpu_torch.projections import create_projection_map
from dualip_tpu_torch.synthetic import generate_synthetic_matching_input_args

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    """300 sources x 30 destinations, sparsity 0.08, seed 7, and the LP
    optimum by HiGHS over the nonzeros (one sum <= 1 row per source)."""
    args = generate_synthetic_matching_input_args(300, 30, 0.08, seed=7)
    scipy_opt = pytest.importorskip("scipy.optimize")
    sparse = pytest.importorskip("scipy.sparse")
    nnz = args.A.nnz
    m, n = args.A.shape
    colid = np.repeat(np.arange(n), np.diff(args.A.indptr))
    Arow = sparse.csr_matrix((args.A.data, (args.A.row_indices, np.arange(nnz))), shape=(m, nnz))
    Acol = sparse.csr_matrix((np.ones(nnz), (colid, np.arange(nnz))), shape=(n, nnz))
    res = scipy_opt.linprog(args.c.data, A_ub=sparse.vstack([Arow, Acol]),
                            b_ub=np.concatenate([args.b_vec, np.ones(n)]), bounds=(0, None), method="highs")
    assert res.status == 0
    return args, float(res.fun)


def _solve(args, gamma=1e-3, iters=300, dual0=None, **kw):
    obj = MatchingSolverDualObjectiveFunction(args, gamma=gamma, device="cpu", **kw)
    solver = AcceleratedGradientDescent(max_iter=iters, gamma=gamma, initial_step_size=1e-3, max_step_size=1e-1)
    return obj, solver.maximize(obj, torch.zeros(args.A.shape[0]) if dual0 is None else dual0)


@pytest.fixture(scope="module")
def solved(problem):
    args, _ = problem
    return _solve(args)


LAYOUTS = [("csc", {}), ("butterfly", {"layout": "butterfly"})]


@pytest.mark.parametrize("name,kw", LAYOUTS, ids=[n for n, _ in LAYOUTS])
def test_certificate_matches_the_jax_package(problem, solved, name, kw):
    args, _ = problem
    _, res = solved
    dual = res.dual_val.numpy()
    got = MatchingSolverDualObjectiveFunction(args, gamma=1e-3, device="cpu", **kw).exact_certificate(dual)
    want = JaxObjective(args, gamma=1e-3, **kw).exact_certificate(jnp.asarray(dual))
    for k in ("primal_ub", "dual_lb"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert got["max_row_violation"] == pytest.approx(want["max_row_violation"], rel=1e-4, abs=1e-6)


def test_certificate_sandwiches_lp_optimum(problem, solved):
    _, lp_opt = problem
    obj, res = solved
    cert = obj.exact_certificate(res.dual_val)
    assert cert["dual_lb"] <= lp_opt + 1e-4
    assert cert["primal_ub"] >= lp_opt - 1e-4
    assert cert["gap_abs"] >= 0
    assert cert["gap_rel"] < 0.1  # 300 iterations at gamma 1e-3 get close


def test_certificate_sandwich_holds_at_crude_duals(problem, solved):
    """Weak duality holds at any dual, negative entries clamped to 0."""
    _, lp_opt = problem
    obj, _ = solved
    for lam in (np.zeros(30), np.full(30, 5.0), np.linspace(-1, 2, 30)):
        cert = obj.exact_certificate(torch.tensor(lam, dtype=torch.float32))
        assert cert["dual_lb"] <= lp_opt + 1e-4
        assert cert["primal_ub"] >= lp_opt - 1e-4


PORT_LAYOUTS = [
    ("use_pallas", {"use_pallas": True, "pallas_block_k": 64}),
    ("compact", {"layout": "butterfly", "compact": True}),
    ("butterfly bf16 carry", {"layout": "butterfly", "carry_dtype": "bfloat16"}),
    ("row", {"layout": "row"}),
    ("butterfly srow_gather", {"layout": "butterfly", "srow_gather": True}),
]


@pytest.mark.parametrize("name,kw", PORT_LAYOUTS, ids=[n for n, _ in PORT_LAYOUTS])
def test_certificate_layout_parity(problem, solved, name, kw):
    args, _ = problem
    obj_c, res = solved
    ref = obj_c.exact_certificate(res.dual_val)
    cert = MatchingSolverDualObjectiveFunction(args, gamma=1e-3, device="cpu", **kw).exact_certificate(res.dual_val)
    for k in ("primal_ub", "dual_lb"):
        assert cert[k] == pytest.approx(ref[k], rel=2e-4), k


def test_certificate_gap_shrinks_with_gamma_ladder(problem):
    """A warm-started gamma continuation tightens the certified gap."""
    args, _ = problem
    obj, res = _solve(args, gamma=1e-3, iters=400)
    gap0 = obj.exact_certificate(res.dual_val)["gap_rel"]
    obj2, res2 = _solve(args, gamma=2.5e-4, iters=1200, dual0=res.dual_val)
    assert obj2.exact_certificate(res2.dual_val)["gap_rel"] < gap0


def test_certificate_refusals(problem):
    args, _ = problem
    with pytest.raises(ValueError, match="b_vec"):
        MatchingSolverDualObjectiveFunction(replace(args, b_vec=None), gamma=1e-3, device="cpu").exact_certificate(
            torch.zeros(30))
    with pytest.raises(NotImplementedError, match="inequality rows"):
        MatchingSolverDualObjectiveFunction(replace(args, equality_mask=np.arange(30) < 3), gamma=1e-3,
                                            device="cpu").exact_certificate(torch.zeros(30))
    box = replace(args, projection_map=create_projection_map("box", {"lower": 0.0, "upper": 1.0}, args.A.shape[1]))
    with pytest.raises(NotImplementedError, match="simplex-inequality"):
        MatchingSolverDualObjectiveFunction(box, gamma=1e-3, device="cpu").exact_certificate(torch.zeros(30))
    # on a mesh, as in the JAX package (its 8-device CPU mesh raises the same)
    mesh = EntityMesh(group=None, rank=0, world_size=1, device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="single mesh device"):
        MatchingSolverDualObjectiveFunction(args, gamma=1e-3, mesh=mesh).exact_certificate(torch.zeros(30))
