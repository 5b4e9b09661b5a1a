"""The port's preprocessing (input validation, Jacobi preconditioning) against
the JAX package on the same numpy inputs, and the bfloat16 cases of the
projections (mirrors of ``tests/preprocessing/*`` and the bf16 tests of
``tests/projections/*``).

Validation: the same inputs pass, or fail with the same message, in both
packages.  Preconditioning is numpy in both: equal arrays.  Projections in
bfloat16: both packages round at other places, so they agree to 2e-2 (the
JAX package's own bf16-vs-fp32 tolerance) and sum to the radius to 1e-5 in
float32 (in bfloat16, to half a bf16 ulp per entry)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dualip_tpu.preprocessing as JP
import dualip_tpu_torch.preprocessing as PP
from dualip_tpu.projections import ProjectionEntry as JaxEntry
from dualip_tpu.projections import bisection_project as jax_bisection
from dualip_tpu.projections.box_cut import box_cut_project as jax_box_cut
from dualip_tpu.projections import duchi_project as jax_duchi
from dualip_tpu.sparse import CSCMatrix as JaxCSC
from dualip_tpu.sparse import csc_from_dense as jax_csc
from dualip_tpu_torch.projections import ProjectionEntry, bisection_project, box_cut_project, duchi_project
from dualip_tpu_torch.sparse import CSCMatrix, csc_from_dense, csc_to_dense

torch.set_num_threads(1)


def _csc(cls, indptr, rows, data, shape):
    return cls(indptr=np.asarray(indptr), row_indices=np.asarray(rows, np.int32),
               data=np.asarray(data, np.float32), shape=shape)


# (name, check, input as a function of (CSC class, csc_from_dense)); None input = dense
CHECK_CASES = [
    ("dense zero row", "check_no_zero_row_or_col", lambda C, f: np.array([[1.0, 2.0], [0.0, 0.0]])),
    ("dense zero col", "check_no_zero_row_or_col", lambda C, f: np.array([[0.0, 2.0], [0.0, 3.0]])),
    ("csc zero row", "check_no_zero_row_or_col", lambda C, f: f(np.array([[1.0, 2.0], [0.0, 0.0], [3.0, 1.0]]))),
    ("nan", "check_nan_or_inf", lambda C, f: np.array([1.0, np.nan])),
    ("inf", "check_nan_or_inf", lambda C, f: np.array([1.0, np.inf])),
    ("csc -inf", "check_nan_or_inf", lambda C, f: f(np.array([[1.0, -np.inf]]))),
    ("indptr", "check_correct_csc_construction", lambda C, f: _csc(C, [0, 2, 1, 3], [0, 1, 0], [1, 2, 3], (2, 3))),
    ("unsorted", "check_correct_csc_construction", lambda C, f: _csc(C, [0, 2], [1, 0], [1, 2], (2, 1))),
    ("duplicate", "check_correct_csc_construction", lambda C, f: _csc(C, [0, 2], [1, 1], [1, 2], (2, 1))),
    ("explicit zero", "check_correct_csc_construction", lambda C, f: _csc(C, [0, 2], [0, 1], [1, 0], (2, 1))),
    ("boundary pairs", "check_correct_csc_construction", lambda C, f: _csc(C, [0, 2, 4], [0, 1, 0, 1], [1, 2, 3, 4], (2, 2))),
    ("good input", "run_all_checks", lambda C, f: f(np.array([[1.0, 0.0], [2.0, 3.0]]))),
    ("good dense", "run_all_checks", lambda C, f: np.array([[1.0, 0.5], [2.0, 3.0]])),
]


def _outcome(pkg, check, arg):
    try:
        getattr(pkg, check)(arg)
    except pkg.InputValidationError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name,check,make", CHECK_CASES, ids=[c[0] for c in CHECK_CASES])
def test_input_check_matches_the_jax_package(name, check, make):
    want = _outcome(JP, check, make(JaxCSC, jax_csc))
    got = _outcome(PP, check, make(CSCMatrix, csc_from_dense))
    assert got == want
    assert (want is None) == (name.startswith("good") or name == "boundary pairs")


PM_CASES = [
    ("good", lambda E: {"a": E("simplex", {"z": 1.0}, [0, 1]), "b": E("box", {"l": 0.0, "u": 1.0}, [2])}),
    ("empty map", lambda E: {}),
    ("not an entry", lambda E: {"a": (1, 2)}),
    ("unknown type", lambda E: {"a": E("ball", {}, [0])}),
    ("unknown method", lambda E: {"a": E("simplex", {"method": "newton"}, [0])}),
    ("box lower > upper", lambda E: {"a": E("box", {"lower": 2.0, "upper": 1.0}, [0])}),
    ("cone two bounds", lambda E: {"a": E("cone", {"lower": 0.0, "upper": 1.0}, [0])}),
    ("simplex z <= 0", lambda E: {"a": E("simplex", {"z": 0.0}, [0])}),
    ("box_cut one bound", lambda E: {"a": E("box_cut", {"lower": 0.0}, [0])}),
    ("box_cut duchi", lambda E: {"a": E("box_cut", {"lower": 0.0, "upper": 1.0, "method": "duchi"}, [0])}),
    ("no indices", lambda E: {"a": E("box", {}, [])}),
    ("negative index", lambda E: {"a": E("box", {}, [-1])}),
    ("index past n", lambda E: {"a": E("box", {}, [5])}),
    ("duplicate index", lambda E: {"a": E("box", {}, [1, 1])}),
    ("shared column", lambda E: {"a": E("box", {}, [0, 1]), "b": E("cone", {}, [1])}),
]


@pytest.mark.parametrize("name,make", PM_CASES, ids=[c[0] for c in PM_CASES])
def test_check_projection_map_matches_the_jax_package(name, make):
    def outcome(pkg, entry):
        try:
            pkg.check_projection_map(make(entry), num_cols=4)
        except pkg.InputValidationError as e:
            return str(e)
        return None

    want, got = outcome(JP, JaxEntry), outcome(PP, ProjectionEntry)
    assert got == want
    assert (want is None) == (name == "good")


@pytest.mark.parametrize("zero_row", [False, True])
def test_jacobi_precondition_matches_the_jax_package(tmp_path, zero_row):
    rng = np.random.default_rng(0)
    dense = rng.normal(size=(4, 6)).astype(np.float32)
    dense[np.abs(dense) < 0.3] = 0.0
    dense[:, 0] = np.where(dense[:, 0] == 0, 0.5, dense[:, 0])
    if zero_row:
        dense[2] = 0.0
    b = rng.normal(size=4).astype(np.float32)
    A2, b2, norms = PP.jacobi_precondition(csc_from_dense(dense), b, norms_save_path=str(tmp_path / "p"))
    R2, rb2, rnorms = JP.jacobi_precondition(jax_csc(dense), b, norms_save_path=str(tmp_path / "j"))
    for f in ("indptr", "row_indices", "data"):
        np.testing.assert_array_equal(getattr(A2, f), getattr(R2, f))
    np.testing.assert_array_equal(b2, rb2)
    np.testing.assert_array_equal(norms, rnorms)
    expected = np.linalg.norm(dense, axis=1)
    np.testing.assert_allclose(norms, expected, atol=1e-5)
    safe = np.where(expected == 0, 1.0, expected)
    np.testing.assert_allclose(csc_to_dense(A2), dense / safe[:, None], atol=1e-5)
    dual = rng.normal(size=4).astype(np.float32)
    from_file = PP.jacobi_invert_precondition(dual, str(tmp_path / "p"))
    np.testing.assert_array_equal(from_file, JP.jacobi_invert_precondition(dual, rnorms))
    np.testing.assert_array_equal(from_file, PP.jacobi_invert_precondition(dual, norms))


PROJ_CASES = [
    ("duchi", lambda x: duchi_project(x, 1.0), lambda x: jax_duchi(x, 1.0)),
    ("bisection", lambda x: bisection_project(x, 1.0), lambda x: jax_bisection(x, 1.0)),
    ("box_cut", lambda x: box_cut_project(x, -0.2, 0.9, 1.3, inequality=False),
     lambda x: jax_box_cut(x, -0.2, 0.9, 1.3, inequality=False)),
]


@pytest.mark.parametrize("name,port,ref", PROJ_CASES, ids=[c[0] for c in PROJ_CASES])
def test_bfloat16_projection_matches_the_jax_package(name, port, ref):
    rng = np.random.default_rng(4)
    v = np.concatenate([np.array([[1.0, 3.0, 5.0, 0.0, 0.0, 0.0], [2.0, 4.0, 6.0, 0.0, 0.0, 0.0]], np.float32),
                        rng.normal(size=(20, 6)).astype(np.float32)])
    x32 = port(torch.from_numpy(v)).numpy()
    x16 = port(torch.from_numpy(v).to(torch.bfloat16))
    assert x16.dtype == torch.bfloat16
    x16 = x16.float().numpy()
    r16 = np.asarray(ref(jnp.asarray(v, jnp.bfloat16)), dtype=np.float32)
    np.testing.assert_allclose(x32, np.asarray(ref(jnp.asarray(v)), dtype=np.float32), atol=1e-5)
    np.testing.assert_allclose(x16, x32, atol=2e-2)
    np.testing.assert_allclose(x16, r16, atol=2e-2)
    if name != "box_cut":  # onto the simplex {x >= 0, sum x = 1}
        np.testing.assert_allclose(x32.sum(-1), 1.0, atol=1e-5)
        np.testing.assert_allclose(x16[:2].sum(-1), 1.0, atol=1e-5)  # the JAX package's two exact rows
        # each of the 6 entries (all below 1) rounds by at most half a bf16 ulp, 2^-9
        np.testing.assert_allclose(x16.sum(-1), 1.0, atol=6 * 2.0 ** -9)
