"""The port's host CSC helpers, BlockCSC extras and AGD utilities against the
JAX package on the same numpy inputs (mirrors of ``tests/test_sparse_utils.py``,
``tests/test_utils.py`` and ``tests/test_agd_restart.py``).

The CSC helpers are numpy in both packages: their outputs are compared
exactly.  Projections and norms run in float32 torch against float32 jnp:
1e-6 absolute."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dualip_tpu.sparse as J
import dualip_tpu_torch.sparse as P
from dualip_tpu.optimizers.agd import AcceleratedGradientDescent as JaxAGD
from dualip_tpu.optimizers.agd_utils import estimate_lipschitz_constant as jax_lipschitz
from dualip_tpu.projections import ProjectionEntry as JaxEntry
from dualip_tpu.types import ObjectiveResult as JaxResult
from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent
from dualip_tpu_torch.optimizers.agd_utils import estimate_lipschitz_constant, norm_of_difference
from dualip_tpu_torch.projections import ProjectionEntry
from dualip_tpu_torch.types import ObjectiveResult

torch.set_num_threads(1)


def _random_dense(rng, m, n, density=0.4):
    d = rng.normal(size=(m, n)).astype(np.float32)
    mask = rng.random(size=(m, n)) < density
    for j in range(n):  # no empty column
        if not mask[:, j].any():
            mask[rng.integers(m), j] = True
    return np.where(mask, d, 0.0).astype(np.float32)


def _same(got, want):
    if isinstance(want, tuple) and hasattr(want, "indptr"):
        assert got.shape == want.shape
        for f in ("indptr", "row_indices", "data"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
            assert getattr(got, f).dtype == getattr(want, f).dtype, f
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# (name, function of (package, A, B, v_rows, v_cols, rng-free extras))
HELPERS = [
    ("csc_to_dense", lambda S, A, B, r, c: S.csc_to_dense(A)),
    ("csc_from_scipy", lambda S, A, B, r, c: S.csc_from_scipy(__import__("scipy.sparse").sparse.csc_matrix(
        S.csc_to_dense(A)))),
    ("dot_product_csc", lambda S, A, B, r, c: S.dot_product_csc(A, B)),
    ("elementwise_csc", lambda S, A, B, r, c: S.elementwise_csc(A, B, np.multiply)),
    ("left_multiply_sparse", lambda S, A, B, r, c: S.left_multiply_sparse(r, A)),
    ("right_multiply_sparse", lambda S, A, B, r, c: S.right_multiply_sparse(A, c)),
    ("row_sums_csc", lambda S, A, B, r, c: S.row_sums_csc(A)),
    ("row_norms_csc", lambda S, A, B, r, c: S.row_norms_csc(A)),
    ("split_csc_by_cols", lambda S, A, B, r, c: S.split_csc_by_cols(A, [2, 3, 4])),
    ("hstack_csc", lambda S, A, B, r, c: S.hstack_csc(S.split_csc_by_cols(A, [4, 5]) + [B])),
    ("vstack_csc", lambda S, A, B, r, c: S.vstack_csc([A, B, A])),
    ("csc_matvec", lambda S, A, B, r, c: S.csc_matvec(A, c)),
    ("csc_rmatvec", lambda S, A, B, r, c: S.csc_rmatvec(A, r)),
]


@pytest.mark.parametrize("name,fn", HELPERS, ids=[h[0] for h in HELPERS])
def test_csc_helper_matches_the_jax_package(name, fn):
    rng = np.random.default_rng(len(name))
    d = _random_dense(rng, 7, 9)
    e = np.where(d != 0, rng.normal(size=d.shape), 0).astype(np.float32)
    e[d != 0] = np.where(e[d != 0] == 0, 1.0, e[d != 0])
    v_rows, v_cols = rng.normal(size=7).astype(np.float32), rng.normal(size=9).astype(np.float32)
    want = fn(J, J.csc_from_dense(d), J.csc_from_dense(e), v_rows, v_cols)
    got = fn(P, P.csc_from_dense(d), P.csc_from_dense(e), v_rows, v_cols)
    _same(got, want)


def test_csc_helpers_against_dense_oracles():
    rng = np.random.default_rng(0)
    d = _random_dense(rng, 7, 5)
    A = P.csc_from_dense(d)
    np.testing.assert_array_equal(P.csc_to_dense(A), d)
    x, y = rng.normal(size=5).astype(np.float32), rng.normal(size=7).astype(np.float32)
    np.testing.assert_allclose(P.csc_matvec(A, x), d @ x, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(P.csc_rmatvec(A, y), d.T @ y, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(P.row_norms_csc(A), np.linalg.norm(d, axis=1), rtol=1e-6)
    np.testing.assert_array_equal(P.csc_to_dense(P.vstack_csc([A, A])), np.vstack([d, d]))
    np.testing.assert_array_equal(P.csc_to_dense(P.hstack_csc(P.split_csc_by_cols(A, [2, 3]))), d)
    with pytest.raises(ValueError, match="sum to"):
        P.split_csc_by_cols(A, [2, 2])
    with pytest.raises(ValueError, match="rows"):
        P.hstack_csc([A, P.csc_from_dense(d[:3])])
    with pytest.raises(ValueError, match="columns"):
        P.vstack_csc([A, P.csc_from_dense(d[:, :3])])
    with pytest.raises(ValueError, match="sparsity pattern"):
        P.elementwise_csc(A, P.csc_from_dense(np.ones_like(d)), np.add)


def _entries(cls, n):
    idx = np.arange(n)
    return {
        "s": cls("simplex", {"z": 1.0}, idx[:7]),
        "b": cls("box", {"lower": -0.5, "upper": 0.5}, idx[7:12]),
        "bc": cls("box_cut", {"lower": 0.0, "upper": 0.6, "z": 1.0}, idx[12:]),
    }


def test_apply_projections_and_flat_roundtrip_match_the_jax_package():
    rng = np.random.default_rng(1)
    d = _random_dense(rng, 12, 16)
    A_j, A_p = J.csc_from_dense(d), P.csc_from_dense(d)
    ref = J.build_blockcsc(A_j, A_j, _entries(JaxEntry, 16), pad_cols_to=4)
    host = P.build_blockcsc(A_p, A_p, _entries(ProjectionEntry, 16), pad_cols_to=4)
    flat = rng.normal(size=A_p.nnz).astype(np.float32) * 3
    vals_j = J.flat_to_tiles_values(ref, flat)
    vals_p = P.flat_to_tiles_values(host, flat)
    _same(vals_p, vals_j)
    np.testing.assert_array_equal(P.tiles_values_to_flat(host, vals_p), flat)
    bc = P.device_put_blockcsc(host, "cpu")
    for mask in (True, False):
        want = J.apply_projections(J.device_put_blockcsc(ref), [jnp.asarray(v) for v in vals_j], mask_output=mask)
        got = P.apply_projections(bc, [torch.from_numpy(v) for v in vals_p], mask_output=mask)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    with pytest.raises(ValueError, match="keep_flat_idx"):
        P.flat_to_tiles_values(P.build_blockcsc(A_p, A_p, {}, keep_flat_idx=False), flat)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lipschitz_estimate_matches_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    g1, g2, d1, d2 = (rng.normal(size=50).astype(np.float32) for _ in range(4))
    want = float(jax_lipschitz(*(jnp.asarray(v) for v in (g1, g2, d1, d2))))
    got = float(estimate_lipschitz_constant(*(torch.from_numpy(v) for v in (g1, g2, d1, d2))))
    assert got == pytest.approx(want, rel=1e-6)
    assert float(norm_of_difference(torch.from_numpy(g1), torch.from_numpy(g1))) == 0.0
    assert float(norm_of_difference(torch.tensor([3.0, 0.0]), torch.tensor([0.0, 4.0]))) == 5.0


class _Quadratic:
    """g(lambda) = -0.5 lambda.D lambda + b.lambda with condition number 1000
    (``tests/test_agd_restart.py``), in either package's tensors."""

    equality_mask = None

    def __init__(self, xp, result):
        rng = np.random.default_rng(0)
        d = np.geomspace(1.0, 1000.0, 64).astype(np.float32)
        self.xp, self.result = xp, result
        b = rng.uniform(0.5, 2.0, 64).astype(np.float32) * d
        self.d, self.b = xp.asarray(d), xp.asarray(b)
        self.g_star = float(0.5 * np.sum(b.astype(np.float64) ** 2 / d))

    def calculate(self, dual_val, save_primal=False, **kwargs):
        obj = -0.5 * (dual_val * self.d * dual_val).sum() + (self.b * dual_val).sum()
        return self.result(dual_gradient=self.b - self.d * dual_val, dual_objective=obj)


@pytest.mark.parametrize("restart", [None, "gradient", "function"])
def test_restart_matches_the_jax_package(restart):
    """The same iterations while the step-size window fills (float32 noise
    only; later the Lipschitz window amplifies it), and restarting beats
    plain momentum by orders of magnitude in both packages."""
    kw = dict(max_iter=800, gamma=None, initial_step_size=1e-4, max_step_size=1.0, restart=restart)
    ref = JaxAGD(**kw).maximize(_Quadratic(jnp, JaxResult), jnp.zeros(64, jnp.float32))
    q = _Quadratic(torch, ObjectiveResult)
    got = AcceleratedGradientDescent(**kw).maximize(q, torch.zeros(64))
    np.testing.assert_allclose(got.dual_objective_log[:20], ref.dual_objective_log[:20], rtol=1e-5)
    if restart is not None:
        plain = AcceleratedGradientDescent(**dict(kw, restart=None)).maximize(q, torch.zeros(64))
        gap, plain_gap = q.g_star - got.dual_objective_log[-1], q.g_star - plain.dual_objective_log[-1]
        # the float32 objective (about g_star in size) rounds to a few 1e-7 of it
        assert gap > -1e-6 * q.g_star and gap < 1e-2 * plain_gap, (gap, plain_gap)
