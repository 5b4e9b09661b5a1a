"""The port's row-major companion layout and the objective on it, against the
JAX package, on the CPU.

Layouts are exact (every array and static tuple of ``build_row_layout``, and
``srow_colidx``).  ``matching_local_parts_rowmajor`` and the objective hold to
fp32 tolerance 1e-5 (gradient 2e-5 of its scale, as the JAX package's own
layout tests); the bf16 carry to the JAX tests' 4e-2/6e-2; golden traces 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dualip_tpu.objectives.matching import (
    MatchingInputArgs as JaxArgs,
    MatchingSolverDualObjectiveFunction as JaxObjective,
    matching_local_parts_rowmajor as jax_rowmajor_parts,
)
from dualip_tpu.projections import create_projection_map as jax_pm
from dualip_tpu.sparse import csc_from_dense as jax_csc
from dualip_tpu.sparse.bcsc import _exact_thresholds as jax_exact, _geom_thresholds as jax_geom
from dualip_tpu.sparse.bcsc import build_blockcsc as jax_build_blockcsc
from dualip_tpu.sparse.rowmajor import _pack_geometry as jax_pack_geometry
from dualip_tpu.sparse.rowmajor import build_row_layout as jax_build_row_layout
from dualip_tpu_torch import ComputeArgs, ObjectiveArgs, SolverArgs, run_solver
from dualip_tpu_torch.checkpoint import save_dual
from dualip_tpu_torch.objectives.matching import (
    MatchingInputArgs,
    MatchingSolverDualObjectiveFunction,
    matching_local_parts_rowmajor,
)
from dualip_tpu_torch.projections import create_projection_map
from dualip_tpu_torch.sparse import build_blockcsc, csc_from_dense
from dualip_tpu_torch.sparse.bcsc import _exact_thresholds, _geom_thresholds, blockcsc_from_numpy
from dualip_tpu_torch.sparse.rowmajor import _col_geometry, _pack_geometry, build_row_layout, row_layout_from_numpy
from tests.objectives.test_dualip_matching_simplex import A_COMPACT, TRUE_VALUES

torch.set_num_threads(1)


def _dense(seed, m=40, n=700, density=0.15):
    """The problem of tests/test_compact_layout.py, with one emptied row."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((m, n)) < density) * rng.random((m, n)).astype(np.float32)
    empty = np.nonzero(dense.sum(axis=0) == 0)[0]
    dense[rng.integers(0, m, size=empty.size), empty] = 0.5
    dense[3] = 0.0
    dense[5, dense.sum(axis=0) == 0] = 0.25
    cost = np.where(dense != 0, -rng.random((m, n)).astype(np.float32), 0).astype(np.float32)
    b = rng.random(m).astype(np.float32) * 3
    lam = np.abs(rng.normal(size=m)).astype(np.float32) * 0.05
    return dense.astype(np.float32), cost, b, lam


def _args(seed, proj=("simplex", {"z": 1.0}), small=False):
    """``small``: few rows, so few distinct column degrees (the compact
    packing makes a tile of each, and JAX compiles each)."""
    dense, cost, b, lam = _dense(seed, m=12, n=400, density=0.3) if small else _dense(seed)
    n = dense.shape[1]
    ref = JaxArgs(A=jax_csc(dense), c=jax_csc(cost), projection_map=jax_pm(proj[0], proj[1], n), b_vec=b)
    got = MatchingInputArgs(
        A=csc_from_dense(dense), c=csc_from_dense(cost),
        projection_map=create_projection_map(proj[0], proj[1], n), b_vec=b,
    )
    return ref, got, lam


def _both_bcsc(seed, compact, pad=128, small=False):
    ref_a, got_a, _ = _args(seed, small=small)
    kw = dict(pad_cols_to=pad, bucketing="exact" if compact else "pow2")
    return (
        jax_build_blockcsc(ref_a.A, ref_a.c, ref_a.projection_map, **kw),
        build_blockcsc(got_a.A, got_a.c, got_a.projection_map, **kw),
    )


def _eq(t, a):
    if a is None:
        assert t is None
        return
    a = np.asarray(a)
    assert tuple(t.shape) == a.shape, (t.shape, a.shape)
    np.testing.assert_array_equal(t.numpy(), a)


def test_thresholds_and_pack_geometry_equal():
    for mx in (1, 2, 7, 33, 500, 2700):
        np.testing.assert_array_equal(_geom_thresholds(mx, 1.05), jax_geom(mx, 1.05))
    lengths = np.array([0, 3, 3, 1, 9, 0, 34])
    np.testing.assert_array_equal(_exact_thresholds(lengths), jax_exact(lengths))
    np.testing.assert_array_equal(_exact_thresholds(np.zeros(3, int)), jax_exact(np.zeros(3, int)))
    for L in range(1, 600):
        assert _pack_geometry(L) == jax_pack_geometry(L)
    assert _pack_geometry(34) == (512, 15)
    assert _col_geometry(1024, 34, True) == (512, 15, 8) and _col_geometry(1024, 5, False) == (8, 1, 8)


@pytest.mark.parametrize("compact", [False, True], ids=["pow2", "exact"])
def test_blockcsc_bucketing_equal(compact):
    ref, got = _both_bcsc(0, compact)
    assert [(s.K, s.L, s.proj_type) for s in got.specs] == [(s.K, s.L, s.proj_type) for s in ref.specs]
    for t, r in zip(got.tiles, ref.tiles):
        for f in ("rows", "a", "c", "length", "col_ids"):
            np.testing.assert_array_equal(np.asarray(getattr(t, f)), np.asarray(getattr(r, f)).astype(getattr(t, f).dtype))
    with pytest.raises(ValueError, match="Unknown bucketing"):
        build_blockcsc(csc_from_dense(np.eye(3, dtype=np.float32)), csc_from_dense(np.eye(3, dtype=np.float32)),
                       create_projection_map("simplex", {"z": 1}, 3), bucketing="geom")


@pytest.mark.parametrize("method,compact", [("gather", False), ("butterfly", False), ("butterfly", True)],
                         ids=["gather", "butterfly", "compact"])
def test_row_layout_equal(method, compact):
    """Every array and static tuple of build_row_layout."""
    ref_b, got_b = _both_bcsc(1, compact)
    ref = jax_build_row_layout(ref_b, method=method, compact=compact)
    got = build_row_layout(got_b, method=method, compact=compact)
    assert got.row_shapes == ref.row_shapes
    assert got.col_offsets == ref.col_offsets and got.col_pack == ref.col_pack
    assert not got.use_cuda_kernel
    _eq(got.row_pos, ref.row_pos)
    assert len(got.row_tiles) == len(ref.row_tiles)
    for t, r in zip(got.row_tiles, ref.row_tiles):
        for f in ("a", "c", "row_ids", "axidx", "length"):
            _eq(getattr(t, f), getattr(r, f))
    if method == "gather":
        assert got.plan is None and got.col_tiles_T is None
        for t, r in zip(got.zidx, ref.zidx):
            _eq(t, r)
        return
    assert got.zidx is None
    assert got.plan.dists == ref.plan.dists and (got.plan.n_in, got.plan.n_out) == (ref.plan.n_in, ref.plan.n_out)
    _eq(got.plan.masks, ref.plan.masks)
    for t, r in zip(got.col_tiles_T, ref.col_tiles_T):
        for f in ("a", "c", "length"):
            _eq(getattr(t, f), getattr(r, f))
    if compact:
        assert any(q > 1 for _, _, q in got.col_pack)


def test_row_layout_errors_are_the_jax_packages():
    _, got_b = _both_bcsc(1, False)
    with pytest.raises(ValueError, match="Unknown row-layout method"):
        build_row_layout(got_b, method="scatter")
    with pytest.raises(ValueError, match="compact packing is butterfly-only"):
        build_row_layout(got_b, method="gather", compact=True)
    ref_a, got_a, _ = _args(1)
    with pytest.raises(ValueError, match="divisible by 128"):
        build_row_layout(build_blockcsc(got_a.A, got_a.c, got_a.projection_map, pad_cols_to=8), method="butterfly")


def test_plan_cache_roundtrip(tmp_path):
    _, got_b = _both_bcsc(2, False)
    first = build_row_layout(got_b, method="butterfly", plan_cache_dir=tmp_path)
    files = list(tmp_path.glob("benes2_*.npz"))
    assert len(files) == 1 and first.plan_cache_path == str(files[0])
    again = build_row_layout(got_b, method="butterfly", plan_cache_dir=tmp_path)
    assert again.plan.dists == first.plan.dists
    assert torch.equal(again.plan.masks, first.plan.masks)
    # the JAX package reads the same file
    ref_b, _ = _both_bcsc(2, False)
    ref = jax_build_row_layout(ref_b, method="butterfly", plan_cache_dir=tmp_path)
    assert len(list(tmp_path.glob("benes2_*.npz"))) == 1
    _eq(first.plan.masks, ref.plan.masks)


OPTIONS = [
    pytest.param({"layout": "row"}, id="row"),
    pytest.param({"layout": "butterfly"}, id="butterfly"),
    pytest.param({"layout": "butterfly", "compact": True}, id="compact"),
    pytest.param({"layout": "butterfly", "srow_gather": True}, id="srow_gather"),
    pytest.param({"layout": "butterfly", "compact": True, "srow_gather": True}, id="compact-srow_gather"),
    pytest.param({"layout": "butterfly", "keep_col_tiles": False, "keep_flat_idx": False}, id="no-col-tiles"),
    pytest.param({"layout": "butterfly", "carry_dtype": "bfloat16"}, id="bf16"),
    pytest.param({"layout": "butterfly", "compact": True, "carry_dtype": "bfloat16"}, id="compact-bf16"),
]


def _close(got, ref, lam, bf16):
    g, r = got.dual_gradient.numpy(), np.asarray(ref.dual_gradient)
    scale = max(1.0, np.abs(r).max())
    if bf16:  # the port against the JAX package, both on a bf16 carry: they round at the same two places
        assert np.allclose(g, r, atol=6e-2 * scale)
        assert np.isclose(float(got.dual_objective), float(ref.dual_objective), rtol=4e-2)
        assert np.isclose(float(got.reg_penalty), float(ref.reg_penalty), rtol=6e-2)
        return
    assert np.allclose(g, r, atol=2e-5 * scale), np.abs(g - r).max()
    assert np.isclose(float(got.dual_objective), float(ref.dual_objective), rtol=1e-5, atol=1e-4)
    assert np.isclose(float(got.reg_penalty), float(ref.reg_penalty), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kwargs", OPTIONS)
def test_objective_on_row_layouts_matches_jax(kwargs):
    ref_a, got_a, lam = _args(4, small=bool(kwargs.get("compact")))
    ref_o = JaxObjective(ref_a, gamma=1e-2, **kwargs)
    got_o = MatchingSolverDualObjectiveFunction(got_a, gamma=1e-2, device="cpu", **kwargs)
    if kwargs.get("srow_gather"):
        _eq(got_o.row_layout.srow_colidx, ref_o.row_layout.srow_colidx)
    if kwargs.get("keep_col_tiles") is False:
        assert got_o.bcsc.tiles == []
    for scale in (1.0, 20.0):
        _close(got_o.calculate(lam * scale), ref_o.calculate(jnp.asarray(lam * scale)), lam, "carry_dtype" in kwargs)


@pytest.mark.parametrize("proj", [("box", {"lower": 0.0, "upper": 0.4}), ("simplex_eq", {"z": 2.0}),
                                  ("box_cut", {"lower": 0.0, "upper": 0.6, "z": 1.0})], ids=lambda p: p[0])
def test_butterfly_other_projections_match_jax(proj):
    ref_a, got_a, lam = _args(6, proj)
    ref = JaxObjective(ref_a, gamma=1e-2, layout="butterfly").calculate(jnp.asarray(lam))
    got = MatchingSolverDualObjectiveFunction(got_a, gamma=1e-2, layout="butterfly", device="cpu").calculate(lam)
    _close(got, ref, lam, False)


@pytest.mark.parametrize("compact", [False, True], ids=["plain", "compact"])
@pytest.mark.parametrize("want_primal", [False, True])
def test_local_parts_rowmajor_on_a_carried_layout(compact, want_primal):
    """One layout built by the JAX package, pushed through both packages'
    matching_local_parts_rowmajor (row_layout_from_numpy carries it across)."""
    ref_b, _ = _both_bcsc(5, compact, pad=1024, small=compact)  # 1024: the Pallas panel kernel's grid block
    rl = jax_build_row_layout(ref_b, method="butterfly", compact=compact)
    _, _, lam = _args(5, small=compact)
    ref = jax_rowmajor_parts(ref_b, rl, jnp.asarray(lam), 1e-2, want_primal=want_primal)

    def np_or_none(x):
        return None if x is None else np.asarray(x)

    carried = row_layout_from_numpy(
        [tuple(np_or_none(f) for f in (t.a, t.c, t.row_ids, t.axidx, t.length)) for t in rl.row_tiles],
        None, np.asarray(rl.row_pos),
        plan={"dists": rl.plan.dists, "masks": np.asarray(rl.plan.masks), "n_in": rl.plan.n_in, "n_out": rl.plan.n_out},
        col_tiles_T=[tuple(np.asarray(f) for f in t) for t in rl.col_tiles_T],
        col_offsets=rl.col_offsets, row_shapes=rl.row_shapes, col_pack=rl.col_pack,
    )
    bcsc = blockcsc_from_numpy(ref_b.tiles, ref_b.specs, ref_b.m, ref_b.n, ref_b.nnz, device="cpu")
    got = matching_local_parts_rowmajor(bcsc, carried, torch.from_numpy(lam), 1e-2, want_primal=want_primal)
    scale = max(1.0, np.abs(np.asarray(ref[0])).max())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5 * scale)
    assert np.isclose(float(got[1]), float(ref[1]), rtol=1e-5, atol=1e-5)
    assert np.isclose(float(got[2]), float(ref[2]), rtol=1e-5, atol=1e-5)
    assert len(got[3]) == len(ref[3]) == (len(ref_b.tiles) if want_primal else 0)
    for x, xr in zip(got[3], ref[3]):
        np.testing.assert_allclose(x.numpy(), np.asarray(xr), atol=1e-5)


@pytest.mark.parametrize("kwargs", OPTIONS[:5] + [OPTIONS[6]])
def test_save_primal_matches_jax(kwargs):
    ref_a, got_a, lam = _args(8, small=bool(kwargs.get("compact")))
    ref = JaxObjective(ref_a, gamma=1e-2, **kwargs).calculate(jnp.asarray(lam), save_primal=True)
    got = MatchingSolverDualObjectiveFunction(got_a, gamma=1e-2, device="cpu", **kwargs).calculate(lam, save_primal=True)
    x_ref = np.asarray(ref.primal_var)
    assert got.primal_var.shape == x_ref.shape
    atol = 2e-2 if "carry_dtype" in kwargs else 2e-5
    np.testing.assert_allclose(got.primal_var, x_ref, atol=atol)
    assert np.isclose(float(got.primal_objective), float(ref.primal_objective), rtol=4e-2 if "carry_dtype" in kwargs else 1e-5)


def test_save_primal_without_flat_idx_raises():
    _, got_a, lam = _args(8)
    obj = MatchingSolverDualObjectiveFunction(got_a, gamma=1e-2, layout="butterfly", keep_flat_idx=False, device="cpu")
    with pytest.raises(NotImplementedError, match="keep_flat_idx"):
        obj.calculate(lam, save_primal=True)


GOLDEN_OPTIONS = [
    pytest.param({"layout": "butterfly"}, id="butterfly"),
    pytest.param({"layout": "butterfly", "compact": True}, id="compact"),
    pytest.param({"layout": "butterfly", "srow_gather": True}, id="srow_gather"),
    pytest.param({"layout": "row"}, id="row"),
]


@pytest.mark.parametrize("kwargs", GOLDEN_OPTIONS)
def test_golden_trace_through_run_solver(kwargs, tmp_path):
    """The 5x5 Scala trace through run_solver on the new layouts, at 1e-5."""
    path = tmp_path / "dual0.npz"
    save_dual(str(path), np.full(5, 0.1, dtype=np.float32))
    inp = MatchingInputArgs(
        A=csc_from_dense(A_COMPACT.T), c=csc_from_dense(-A_COMPACT.T),
        projection_map=create_projection_map("simplex", {"z": 1}, 5), b_vec=np.full(5, 0.7, np.float32),
    )
    res = run_solver(
        inp, SolverArgs(max_iter=30, gamma=1e-3, initial_dual_path=str(path)), ComputeArgs(host_device="cpu"),
        ObjectiveArgs(objective_kwargs={**kwargs, "plan_cache_dir": str(tmp_path)} if kwargs["layout"] == "butterfly" else kwargs),
    )
    for i, want in TRUE_VALUES:
        assert abs(res.dual_objective_log[i - 1] - want) < 1e-5, (i, res.dual_objective_log[i - 1], want)


def test_run_solver_butterfly_needs_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    inp = MatchingInputArgs(
        A=csc_from_dense(A_COMPACT.T), c=csc_from_dense(-A_COMPACT.T),
        projection_map=create_projection_map("simplex", {"z": 1}, 5), b_vec=np.full(5, 0.7, np.float32),
    )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_solver(inp, SolverArgs(max_iter=2), ComputeArgs(), ObjectiveArgs(objective_kwargs={"layout": "butterfly"}))


ILLEGAL = [
    ({"layout": "diag"}, "Unknown layout"),
    ({"layout": "row", "use_pallas": True}, "layout='row' is single-device"),
    ({"layout": "row", "mesh": object()}, "layout='row' is single-device"),
    ({"layout": "butterfly", "use_pallas": True}, "runs its own fused kernel"),
    ({"carry_dtype": "bfloat16"}, "carry_dtype is a butterfly-layout knob"),
    ({"layout": "row", "compact": True}, "compact packing is butterfly-only"),
    ({"srow_gather": True}, "srow_gather is a butterfly-layout knob"),
    ({"layout": "butterfly", "srow_gather": True, "mesh": object()}, "srow_gather is single-device only"),
]


@pytest.mark.parametrize("kwargs,message", ILLEGAL, ids=[m for _, m in ILLEGAL])
def test_illegal_combinations_raise_the_jax_packages_errors(kwargs, message):
    _, got_a, _ = _args(0)
    with pytest.raises(ValueError, match=message):
        MatchingSolverDualObjectiveFunction(got_a, gamma=1e-3, device="cpu", **kwargs)
    if "mesh" not in kwargs:  # the JAX package raises the same error
        ref_a, _, _ = _args(0)
        with pytest.raises(ValueError, match=message):
            JaxObjective(ref_a, gamma=1e-3, **kwargs)
