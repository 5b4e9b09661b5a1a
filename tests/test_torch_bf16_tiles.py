"""Tiles in bfloat16 through the port, against the JAX package on the CPU.

* The tiles: a and c rounded to bfloat16 (nearest, ties to even) equal the
  JAX package's bit for bit, for every spelling of the dtype, on the column
  tiles and on the butterfly layout's panel tiles.
* The objective: 1e-6 relative on the dual objective, gradient within 1e-5
  of its largest entry, on csc (plain path), butterfly and row, at
  the dual 0 and at a random dual.  Both packages compute in float32 on the
  rounded values; only the order of the sums differs.
* The panel kernel's plain version with bf16 a and c against the Pallas
  kernel in interpret mode, at the tolerances of ``tests/test_torch_panel.py``.
* ``use_pallas=True`` refuses bf16 tiles, as the JAX package's fused tile
  kernel does not take them either.
* A 15-iteration solve (``tests/test_resume_and_dtypes.py::test_bf16_tiles_solve``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dualip_tpu.objectives.matching import (
    MatchingInputArgs as JaxArgs,
    MatchingSolverDualObjectiveFunction as JaxObjective,
)
from dualip_tpu.ops.pallas_matching import fused_panel_project as jax_panel
from dualip_tpu.optimizers.agd import AcceleratedGradientDescent as JaxAGD
from dualip_tpu.projections import ProjectionEntry as JaxEntry
from dualip_tpu.projections import create_projection_map as jax_pm
from dualip_tpu.sparse.bcsc import build_blockcsc as jax_build
from dualip_tpu.sparse.rowmajor import build_row_layout as jax_row_layout
from dualip_tpu_torch.objectives.matching import MatchingInputArgs, MatchingSolverDualObjectiveFunction
from dualip_tpu_torch.ops.fused_matching import build_panel_table, fused_panel_project
from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent
from dualip_tpu_torch.projections import ProjectionEntry, create_projection_map
from dualip_tpu_torch.sparse.bcsc import build_blockcsc, device_put_blockcsc, is_bfloat16
from dualip_tpu_torch.sparse.rowmajor import PanelTile, build_row_layout
from dualip_tpu_torch.synthetic import generate_synthetic_matching_input_args
from tests.objectives.test_dualip_matching_simplex import set_up_data_scala

torch.set_num_threads(1)

BF16_FORMS = [torch.bfloat16, "bfloat16", np.dtype(jnp.bfloat16)]
FORM_IDS = ["torch", "str", "numpy"]


def _bits(x) -> np.ndarray:
    """The 16 bits of a bfloat16 tensor or numpy array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _map(n, pm_cls):
    """Simplex / box_cut / simplex_eq over thirds of the columns."""
    idx = np.arange(n)
    return {
        "s": pm_cls("simplex", {"z": 1.0}, idx[: n // 3]),
        "bc": pm_cls("box_cut", {"lower": 0.0, "upper": 1.0, "z": 1.0}, idx[n // 3: 2 * n // 3]),
        "se": pm_cls("simplex_eq", {"z": 1.0}, idx[2 * n // 3:]),
    }


@pytest.fixture(scope="module")
def problem():
    """4000 sources x 100 destinations, sparsity 0.03, seed 7 (11,653 nnz)."""
    return generate_synthetic_matching_input_args(4000, 100, 0.03, seed=7)


@pytest.mark.parametrize("form", BF16_FORMS, ids=FORM_IDS)
def test_bf16_tiles_equal_the_jax_package_bit_for_bit(problem, form):
    n = problem.A.shape[1]
    assert is_bfloat16(form)
    ref = jax_build(problem.A, problem.c, _map(n, JaxEntry), pad_cols_to=128, dtype=np.dtype(jnp.bfloat16))
    host = build_blockcsc(problem.A, problem.c, _map(n, ProjectionEntry), pad_cols_to=128, dtype=form)
    got = device_put_blockcsc(host, "cpu")
    assert len(got.tiles) == len(ref.tiles)
    for g, r in zip(got.tiles, ref.tiles):
        assert g.a.dtype == g.c.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(g.a), _bits(r.a))
        np.testing.assert_array_equal(_bits(g.c), _bits(r.c))
    # the butterfly layout's panel tiles, from the port's tiles and from the JAX package's
    rl = build_row_layout(host, method="butterfly")
    rl_ref = jax_row_layout(ref, method="butterfly")
    for g, r in zip(rl.col_tiles_T, rl_ref.col_tiles_T):
        assert g.a.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(g.a), _bits(np.asarray(r.a)))
        np.testing.assert_array_equal(_bits(g.c), _bits(np.asarray(r.c)))
    # numpy bfloat16 arrays of another package go through the 16-bit view
    from dualip_tpu_torch.sparse.bcsc import blockcsc_from_numpy

    placed = blockcsc_from_numpy([tuple(np.asarray(x) for x in t) for t in ref.tiles], ref.specs, ref.m, ref.n,
                                 ref.nnz, "cpu")
    for g, r in zip(placed.tiles, ref.tiles):
        np.testing.assert_array_equal(_bits(g.a), _bits(r.a))


LAYOUTS = [
    ("csc", {}),
    ("butterfly", {"layout": "butterfly"}),
    ("row", {"layout": "row"}),
]


@pytest.mark.parametrize("name,kw", LAYOUTS, ids=[n for n, _ in LAYOUTS])
def test_bf16_objective_matches_the_jax_package(problem, name, kw):
    """The dual 0 at gamma 1e-2 with bf16 tiles and a mixed map (where the
    port used to refuse bf16 tiles), and a random dual with save_primal."""
    m, n = problem.A.shape
    ref_obj = JaxObjective(JaxArgs(A=problem.A, c=problem.c, projection_map=_map(n, JaxEntry), b_vec=problem.b_vec),
                           gamma=1e-2, dtype=np.dtype(jnp.bfloat16), **kw)
    obj = MatchingSolverDualObjectiveFunction(
        MatchingInputArgs(A=problem.A, c=problem.c, projection_map=_map(n, ProjectionEntry), b_vec=problem.b_vec),
        gamma=1e-2, dtype=torch.bfloat16, device="cpu", **kw)
    rng = np.random.default_rng(11)
    for lam, save_primal in ((np.zeros(m, np.float32), False), (np.abs(rng.normal(size=m)).astype(np.float32), True)):
        ref = ref_obj.calculate(jnp.asarray(lam), save_primal=save_primal)
        got = obj.calculate(lam, save_primal=save_primal)
        want = float(ref.dual_objective)
        assert abs(float(got.dual_objective) - want) <= 1e-6 * abs(want), (float(got.dual_objective), want)
        g_ref = np.asarray(ref.dual_gradient)
        np.testing.assert_allclose(got.dual_gradient.numpy(), g_ref, atol=1e-5 * np.abs(g_ref).max())
        assert got.dual_gradient.dtype == torch.float32
        if save_primal:
            np.testing.assert_allclose(got.primal_var, np.asarray(ref.primal_var), atol=1e-5)


@pytest.mark.parametrize("want_x", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("carry", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,compact", [(5, False), (48, False), (3, True)], ids=["L5", "L48", "L3-compact"])
def test_panel_bf16_tiles_match_pallas_interpret(L, compact, carry, want_x):
    """K3/K4's plain version with bf16 a and c: z in fp32 (the TPU kernel's
    rule), a*x stored in the carry type."""
    from dualip_tpu_torch.sparse.rowmajor import _pack_geometry

    rng = np.random.default_rng(L)
    KP = 4
    if compact:
        L2, q = _pack_geometry(L)
        pack = (L, L2, q)
    else:
        L2, q, pack = 1 << (L - 1).bit_length(), 1, None
    a = np.abs(rng.normal(size=(KP, q, L, 128))).astype(np.float32)
    c = -np.abs(rng.normal(size=(KP, q, L, 128))).astype(np.float32)
    length = rng.integers(0, L + 1, size=(KP, q, 1, 128)).astype(np.int32)
    mask = np.arange(L)[None, None, :, None] < length
    a = np.where(mask, a, 0).reshape(KP, q * L, 128).astype(np.float32)
    c = np.where(mask, c, 0).reshape(KP, q * L, 128).astype(np.float32)
    length = length.reshape(KP, q, 128)
    region = KP * L2 * 128
    buf = (rng.normal(size=3 * region) * 3).astype(np.float32)
    off = region
    a16, c16 = jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(c).astype(jnp.bfloat16)
    ref = jax_panel(jnp.asarray(buf).astype(carry), a16, c16, jnp.asarray(length), off, "simplex", (("z", 1.0),),
                    interpret=True, want_x=want_x, neg_inv_gamma=jnp.float32(-2.0), pack=pack)
    t_a = torch.from_numpy(np.asarray(a16).view(np.int16).copy()).view(torch.bfloat16)
    t_c = torch.from_numpy(np.asarray(c16).view(np.int16).copy()).view(torch.bfloat16)
    got = fused_panel_project(torch.from_numpy(buf).to(getattr(torch, carry)), t_a, t_c, torch.from_numpy(length),
                              off, "simplex", (("z", 1.0),), want_x=want_x, neg_inv_gamma=-2.0, pack=pack)
    assert got[0].dtype == getattr(torch, carry)
    gb, rb = got[0].float().numpy(), np.asarray(ref[0].astype(jnp.float32))
    np.testing.assert_array_equal(gb[:off], rb[:off])
    np.testing.assert_array_equal(gb[off + region:], rb[off + region:])
    slack = 2.0 ** -7 * np.abs(rb).max() if carry == "bfloat16" else 0.0  # one bf16 ulp at the store
    np.testing.assert_allclose(gb[off:off + region], rb[off:off + region], atol=1e-5 * max(1.0, np.abs(rb).max()) + slack)
    assert np.isclose(float(got[1]), float(ref[1]), rtol=1e-4, atol=1e-5)
    assert np.isclose(float(got[2]), float(ref[2]), rtol=1e-4, atol=1e-5)
    if want_x:
        x_ref = np.asarray(ref[3])
        np.testing.assert_allclose(got[3].numpy(), x_ref, atol=1e-5 * max(1.0, np.abs(x_ref).max()))


def test_panel_table_takes_one_tile_type():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.random((2, 4, 128)).astype(np.float32))
    length = torch.full((2, 1, 128), 4, dtype=torch.int32)
    t16 = PanelTile(a.to(torch.bfloat16), a.to(torch.bfloat16), length)
    table = build_panel_table([t16, t16], [0, 2 * 4 * 128], [None, None], [("simplex", (("z", 1.0),))] * 2)
    assert table.tile_dtype == torch.bfloat16
    with pytest.raises(TypeError, match="one type"):
        build_panel_table([t16, PanelTile(a, a, length)], [0, 2 * 4 * 128], [None, None], [("simplex", ())] * 2)


def test_use_pallas_refuses_bf16_tiles(problem):
    n = problem.A.shape[1]
    args = MatchingInputArgs(A=problem.A, c=problem.c, projection_map=_map(n, ProjectionEntry), b_vec=problem.b_vec)
    for form in BF16_FORMS:
        with pytest.raises(TypeError, match="no bfloat16 form"):
            MatchingSolverDualObjectiveFunction(args, gamma=1e-2, dtype=form, use_pallas=True, device="cpu")


def test_bf16_tiles_solve():
    """Tiles in bfloat16: the solve runs and lands near the fp32 answer, and
    on the JAX package's bf16 answer."""
    A, C, b_vec = set_up_data_scala()

    def solve(dtype):
        obj = MatchingSolverDualObjectiveFunction(
            MatchingInputArgs(A=A, c=C, projection_map=create_projection_map("simplex", {"z": 1}, 5), b_vec=b_vec),
            gamma=1e-3, dtype=dtype, device="cpu")
        return AcceleratedGradientDescent(max_iter=15, gamma=1e-3).maximize(obj, torch.full((5,), 0.1))

    r16, r32 = solve(torch.bfloat16), solve(np.float32)
    assert np.isfinite(r16.dual_objective)
    assert abs(r16.dual_objective - r32.dual_objective) / (1 + abs(r32.dual_objective)) < 0.05
    ref_obj = JaxObjective(JaxArgs(A=A, c=C, projection_map=jax_pm("simplex", {"z": 1}, 5), b_vec=b_vec),
                           gamma=1e-3, dtype=np.dtype(jnp.bfloat16))
    ref = JaxAGD(max_iter=15, gamma=1e-3).maximize(ref_obj, jnp.asarray(0.1 * np.ones(5, np.float32)))
    np.testing.assert_allclose(r16.dual_objective_log, ref.dual_objective_log, rtol=1e-5, atol=1e-6)
