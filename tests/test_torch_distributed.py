"""The port's entity-sharded solve over ``torch.distributed``, held to the JAX
package's mesh paths (``tests/distributed/*``) on the CPU.

Ranks are spawned processes in gloo groups (``parallel.run_ranks``; each with
one torch thread, a 60 s group timeout and a 120 s join): one world of eight
ranks carries the 2-, 4- and 8-rank cases through sub-groups, one of two runs
``run_solver`` and the tile caches.  The rank bodies are in
``tests/_torch_dist_worker.py`` (the port only); here the parent holds their
results to the golden trace, to each other and to the JAX package on its
8-device CPU mesh."""

import contextlib
import functools
import json
import os
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dualip_tpu
import dualip_tpu_torch
from dualip_tpu.io.streaming_build import stream_build_sharded_cache as jax_stream_build
from dualip_tpu.objectives.matching import (
    MatchingInputArgs as JaxArgs,
    MatchingSolverDualObjectiveFunction as JaxObjective,
)
from dualip_tpu.objectives.miplib import MIPLIB2017ObjectiveFunction as JaxLP, MIPLIBInputArgs as JaxLPArgs
from dualip_tpu.optimizers.agd import AcceleratedGradientDescent as JaxAGD
from dualip_tpu.parallel import default_mesh as jax_mesh
from dualip_tpu.projections.base import ProjectionEntry as JaxEntry
from dualip_tpu.sparse import csc_from_arrays as jax_csc_from_arrays
from dualip_tpu_torch.objectives.matching import MatchingSolverDualObjectiveFunction, matching_tile_cache_key
from dualip_tpu_torch.objectives.miplib import MIPLIB2017ObjectiveFunction
from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent, uses_graph
from dualip_tpu_torch.objectives.matching import transpose_tiles
from dualip_tpu_torch.parallel import EntityMesh, default_mesh, run_ranks
from dualip_tpu_torch.sparse.bcsc import build_blockcsc
from dualip_tpu_torch.sparse.rowmajor import _slice_bcsc_cols
from dualip_tpu_torch.synthetic import _cache_path, generate_synthetic_matching_input_args

from tests import _torch_dist_worker as worker

torch.set_num_threads(1)

GOLDEN = [(2, -3.6010155991401818), (16, -3.60842718733725), (23, -3.5080258013053136), (29, -3.4868496294227143)]
RANKS = dict(device="cpu", threads=1, timeout_s=60.0, join_timeout_s=120.0)
STREAM_SPEC = (1500, 30, 0.06, 11)


@pytest.fixture(scope="module")
def world8():
    return run_ranks(worker.world8, 8, **RANKS)


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """The generator's memmap tier for STREAM_SPEC and the port's streamed
    two-shard entry built from it."""
    from dualip_tpu_torch.io.streaming_build import stream_build_sharded_cache

    root = tmp_path_factory.mktemp("stream")
    ns, nd, sp, seed = STREAM_SPEC
    os.environ["DUALIP_GEN_MEMMAP"] = "1"
    try:
        args = generate_synthetic_matching_input_args(ns, nd, sp, seed=seed, cache_dir=str(root))
    finally:
        del os.environ["DUALIP_GEN_MEMMAP"]
    mm_dir = _cache_path(str(root), ns, nd, sp, np.float32, (seed, "numpy")).with_suffix(".mm")
    key = matching_tile_cache_key(args, n_shards=2, pallas_block_k=128, compact=True)
    out = stream_build_sharded_cache(mm_dir, (nd, ns), args.projection_map, n_shards=2, cache_dir=root / "tiles",
                                     key=key, plan_cache_dir=root / "plans", compact=True, pad_cols_to=128)
    return {"spec": STREAM_SPEC, "root": root, "mm_dir": mm_dir, "args": args, "key": key, "entry": out,
            "tiles": str(root / "tiles"), "plans": str(root / "plans")}


@pytest.fixture(scope="module")
def world2(tmp_path_factory, stream):
    tmp = tmp_path_factory.mktemp("world2")
    worker_stream = {k: stream[k] for k in ("spec", "tiles", "plans")}
    return tmp, run_ranks(worker.world2, 2, args=(str(tmp), worker_stream), **RANKS)


def _jax_map(pm):
    return {k: JaxEntry(e.proj_type, dict(e.proj_params), e.indices) for k, e in pm.items()}


def _jax_args(port_args):
    A, C = port_args.A, port_args.c
    return JaxArgs(A=jax_csc_from_arrays(A.indptr, A.row_indices, A.data, A.shape),
                   c=jax_csc_from_arrays(C.indptr, C.row_indices, C.data, C.shape),
                   projection_map=_jax_map(port_args.projection_map), b_vec=port_args.b_vec)


def _jax_lp(port_lp):
    A = port_lp.A
    if not isinstance(A, np.ndarray):
        A = jax_csc_from_arrays(A.indptr, A.row_indices, A.data, A.shape)
    return JaxLPArgs(A=A, c=port_lp.c, projection_map=_jax_map(port_lp.projection_map), b_vec=port_lp.b_vec,
                     equality_mask=port_lp.equality_mask)


def _shard(arr, mesh, d):
    """Device d's shard of a JAX array sharded over ``mesh``."""
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return by_dev[mesh.devices.flat[d]]


GOLDEN_IDS = [(name, ws) for name, (_, sizes) in worker.GOLDEN_CASES.items() for ws in sizes]
GOLDEN_IDS += [("distributed wrapper", 2), ("assembled tiles", 2)]


@pytest.mark.parametrize("case", GOLDEN_IDS, ids=[f"{n}-{w}ranks" for n, w in GOLDEN_IDS])
def test_golden_trace_on_the_mesh(world8, case):
    log = world8[0]["golden"][case][0]
    for i, want in GOLDEN:
        assert abs(log[i - 1] - want) < 1e-5, f"{case}, iteration {i}: {log[i - 1]} vs {want}"


@pytest.mark.parametrize("case", GOLDEN_IDS, ids=[f"{n}-{w}ranks" for n, w in GOLDEN_IDS])
def test_every_rank_keeps_the_same_duals(world8, case):
    """The ranks' logs and final duals are bit-identical."""
    ranks = [r["golden"][case] for r in world8 if case in r["golden"]]
    assert len(ranks) == case[1]
    for log, _, dual in ranks[1:]:
        assert log == ranks[0][0]
        np.testing.assert_array_equal(dual, ranks[0][2])


@pytest.mark.parametrize("case", [c for c in GOLDEN_IDS if c[0] in worker.GOLDEN_CASES],
                         ids=lambda c: f"{c[0]}-{c[1]}ranks")
def test_save_primal_on_the_mesh_gathers_the_whole_primal(world8, case):
    """Every rank returns the whole primal in CSC order: the single-device
    solve's at the same dual."""
    name, ws = case
    log, x, dual = world8[0]["golden"][case]
    for r in world8[:ws]:
        np.testing.assert_array_equal(r["golden"][case][1], x)
    assert x.shape == (25,)
    np.testing.assert_allclose(x, _one_device_primal(name), atol=1e-5)


@functools.lru_cache(maxsize=None)
def _one_device_primal(name):
    """The primal of the same 30-iteration solve on one device (save_primal
    evaluates at the last iterate)."""
    one = MatchingSolverDualObjectiveFunction(worker.golden_args(), gamma=1e-3, device="cpu",
                                              **worker.GOLDEN_CASES[name][0])
    res = AcceleratedGradientDescent(max_iter=30, gamma=1e-3, save_primal=True).maximize(one, torch.full((5,), 0.1))
    return np.asarray(res.objective_result.primal_var)


GRAPH_IDS = [c for c in GOLDEN_IDS if c[0] in worker.GOLDEN_CASES] + [("lp dense", 4), ("lp coo", 4)]


@pytest.mark.parametrize("case", GRAPH_IDS, ids=[f"{n}-{w}ranks" for n, w in GRAPH_IDS])
def test_the_mesh_graph_gives_the_eager_mesh_loops_bits(world8, case):
    """Each mesh path solved on the graph path (one capture a rank, each
    replay emulated by running the captured iteration, all_reduce included,
    again) gives the same ranks' eager mesh loop's log, dual, gradient and
    gathered primal (``save_primal``, after the loop) bit for bit, the same
    on every rank, and the matching paths hold the golden trace at 1e-5."""
    ranks = [r["graph"][case] for r in world8 if case in r["graph"]]
    assert len(ranks) == case[1]
    for r in ranks:
        assert len(r["captures"]) == 1 and r["captures"][0].endswith(" on a gloo mesh")
        assert r["graph"][0] == r["eager"][0] == ranks[0]["graph"][0]
        for got, want in zip(r["graph"][1:], r["eager"][1:]):
            np.testing.assert_array_equal(got, want)
    if case[0] in worker.GOLDEN_CASES:
        log = ranks[0]["graph"][0]
        for i, want in GOLDEN:
            assert abs(log[i - 1] - want) < 1e-5, f"{case}, iteration {i}: {log[i - 1]} vs {want}"


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("backend", [None, "nccl", "gloo"], ids=["no mesh", "nccl", "gloo"])
def test_the_path_rule_takes_the_graph_on_cuda_without_a_mesh_or_over_nccl(device, backend):
    mesh = None if backend is None else types.SimpleNamespace(backend=lambda: backend)
    assert uses_graph(torch.device(device), mesh) is (device == "cuda" and backend in (None, "nccl"))


@pytest.mark.parametrize("objective", ["matching", "lp"])
def test_a_failed_capture_on_a_mesh_raises_and_names_the_objective(monkeypatch, objective):
    """A capture that fails on an NCCL mesh objective raises a RuntimeError
    naming the objective and the backend; no eager result comes back.  One
    rank, its all_reduce the identity; the capture refused as the card
    refuses an unsupported call."""
    monkeypatch.setattr(EntityMesh, "all_reduce_", lambda self, t: t)
    monkeypatch.setattr(EntityMesh, "backend", lambda self: "nccl")

    def refused(*args, **kwargs):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: None)
    monkeypatch.setattr(torch.cuda, "graph", refused)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    mesh = EntityMesh(group=None, rank=0, world_size=1, device=torch.device("cpu"))
    if objective == "matching":
        obj, name = MatchingSolverDualObjectiveFunction(worker.golden_args(), gamma=1e-3, mesh=mesh,
                                                        use_pallas=True, pallas_block_k=8), "MatchingSolver"
    else:
        obj, name = MIPLIB2017ObjectiveFunction(worker.random_lp(seed=3, sparse=True), mesh=mesh), "MIPLIB2017"
    solver = AcceleratedGradientDescent(max_iter=5, gamma=1e-3)
    x0 = torch.full((obj.b_vec.shape[0],), 0.1)
    with pytest.raises(RuntimeError, match=rf"{name}\w* on a nccl mesh in a CUDA graph failed"):
        solver._maximize(obj, x0, 0, None, graph=True)
    assert len(solver._maximize_eager(obj, x0).dual_objective_log) == 5  # the eager loop itself runs


TILE_IDS = [(name, ws) for name in worker.TILE_CASES for ws in (2, 8)]


@pytest.mark.parametrize("case", TILE_IDS, ids=[f"{n}-{w}ranks" for n, w in TILE_IDS])
def test_rank_d_holds_the_jax_packages_shard_d(world8, case):
    """Each rank's tiles (csc, use_pallas) or butterfly layout equal, element
    for element, what the JAX package's objective places on device d."""
    name, ws = case
    kw = worker.TILE_CASES[name]
    mesh = jax_mesh(ws)
    obj = JaxObjective(_jax_args(worker.random_matching()), gamma=1e-3, mesh=mesh, **kw)
    for d in range(ws):
        got = world8[d]["tiles"][case]
        if obj.row_layout is None:
            for i, t in enumerate(obj.bcsc.tiles):
                for f in ("rows", "a", "c", "length", "col_ids"):
                    np.testing.assert_array_equal(got[f"tile{i}_{f}"], _shard(getattr(t, f), mesh, d),
                                                  err_msg=f"rank {d} tile {i} {f}")
            continue
        rl = obj.row_layout
        assert got["col_offsets"] == rl.col_offsets and got["row_shapes"] == rl.row_shapes
        assert got["col_pack"] == rl.col_pack
        np.testing.assert_array_equal(got["row_pos"], np.asarray(rl.row_pos)[d])
        np.testing.assert_array_equal(got["plan_masks"], np.asarray(rl.plan.masks)[d])
        for i, pt in enumerate(rl.col_tiles_T):
            for f, v in (("a", pt.a), ("c", pt.c), ("len", pt.length)):
                np.testing.assert_array_equal(got[f"panel{i}_{f}"], np.asarray(v)[d], err_msg=f"rank {d} panel {i}")
        for i, rt in enumerate(rl.row_tiles):
            np.testing.assert_array_equal(got[f"rowtile{i}_ids"], np.asarray(rt.row_ids)[d])
            np.testing.assert_array_equal(got[f"rowtile{i}_len"], np.asarray(rt.length)[d])


SHARD_IDS = [(name, ws) for name in worker.SHARD_CASES for ws in (2, 4)]


@pytest.mark.parametrize("case", SHARD_IDS, ids=[f"{n}-{w}ranks" for n, w in SHARD_IDS])
def test_a_csc_rank_builds_only_its_own_columns(world8, case):
    """Rank d's tiles (on its device, (L, K/D) for use_pallas) and its specs'
    flat_idx equal, element for element, the whole build's tiles cut to its
    columns; the specs' K and L stay the whole tiles'.  The problem has empty
    columns, an ``__identity__`` entry and padding columns in the last
    ranks' slabs."""
    name, ws = case
    kw = worker.SHARD_CASES[name]
    args = worker.shard_args()
    pad = ws * (kw["pallas_block_k"] if kw.get("use_pallas") else 1)
    whole = build_blockcsc(args.A, args.c, args.projection_map, pad_cols_to=pad)
    assert (args.A.col_lengths == 0).any() and "__identity__" in {s.entry_key for s in whole.specs}
    padding = 0
    for d in range(ws):
        got = world8[d]["shard"][case]
        mine = _slice_bcsc_cols(transpose_tiles(whole) if kw.get("use_pallas") else whole, d, ws)
        assert got["specs"] == [(s.entry_key, s.K, s.L) for s in whole.specs]
        for i, (t, s) in enumerate(zip(mine.tiles, whole.specs)):
            for f in ("rows", "a", "c", "length", "col_ids"):
                np.testing.assert_array_equal(got["leaves"][f"tile{i}_{f}"], getattr(t, f),
                                              err_msg=f"rank {d} tile {i} {f}")
            k = s.K // ws
            np.testing.assert_array_equal(got["flat_idx"][i], s.flat_idx[d * k:(d + 1) * k])
            padding += int((np.asarray(t.col_ids) < 0).sum())
    assert padding > 0


@pytest.mark.parametrize("case", SHARD_IDS, ids=[f"{n}-{w}ranks" for n, w in SHARD_IDS])
def test_a_ranks_shard_counters_count_its_slab(world8, case):
    """``dualip.build.shard_columns`` and ``.shard_slots``: sum K / D and
    sum K * L / D over the tiles, on every rank."""
    ws = case[1]
    for r in world8[:ws]:
        got = r["shard"][case]
        assert got["counters"] == [sum(K for _, K, _ in got["specs"]) // ws,
                                   sum(K * L for _, K, L in got["specs"]) // ws]


@pytest.mark.parametrize("case", SHARD_IDS, ids=[f"{n}-{w}ranks" for n, w in SHARD_IDS])
def test_a_solve_on_the_ranks_own_columns_gives_the_slices_bits(world8, case):
    """A sharded solve on the rank-local build gives, bit for bit, the log
    and dual of the same solve on the whole build's slice, on every rank; the
    primal that ``save_primal`` scatters through the ranks' own flat_idx is
    the one scattered through the whole tiles' flat_idx."""
    ws = case[1]
    for r in world8[:ws]:
        got = r["shard"][case]
        (log, _, dual), (log_sliced, _, dual_sliced) = got["solve"], got["solve_sliced"]
        assert log == log_sliced and dual.tobytes() == dual_sliced.tobytes()
        assert got["primal"].tobytes() == got["primal_sliced"].tobytes()
        assert got["primal"].tobytes() == world8[0]["shard"][case]["primal"].tobytes()


def test_assembled_tiles_take_global_column_ids(world8):
    assert [r["shard_bounds"] for r in world8[:2]] == [(0, 3), (3, 5)]
    for d, r in enumerate(world8[:2]):
        ids = np.concatenate(r["assembled_col_ids"])
        assert sorted(ids[ids >= 0]) == list(range(*r["shard_bounds"]))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("ws", [2, 8])
def test_sharded_lp_calculate_matches_the_jax_packages(world8, sparse, ws):
    lam = jnp.asarray(np.random.default_rng(2).normal(size=12).astype(np.float32))
    want = JaxLP(_jax_lp(worker.random_lp(seed=1, sparse=sparse)), mesh=jax_mesh(ws)).calculate(lam, gamma=1e-2)
    for r in world8[:ws]:
        grad, obj, reg = r["lp"][("calculate", sparse, ws)]
        np.testing.assert_allclose(grad, np.asarray(want.dual_gradient), atol=1e-5)
        assert np.isclose(obj, float(want.dual_objective), rtol=1e-6, atol=1e-5)
        assert np.isclose(reg, float(want.reg_penalty), rtol=1e-6, atol=1e-6)
        assert grad.tobytes() == world8[0]["lp"][("calculate", sparse, ws)][0].tobytes()


def test_sharded_lp_jacobi_and_certificate(world8):
    lam = jnp.asarray(np.abs(np.random.default_rng(6).normal(size=12)).astype(np.float32))
    ref = JaxLP(_jax_lp(worker.random_lp(seed=5, sparse=True)), use_jacobi_precondition=True, mesh=jax_mesh(2))
    grad, bounds = world8[0]["lp"]["jacobi"]
    np.testing.assert_allclose(grad, np.asarray(ref.calculate(lam, gamma=1e-2).dual_gradient), atol=1e-5)
    want = ref.calculate_convergence_bound(lam, tol=1e-4)
    for s, r in zip(bounds[:4], want[:4]):
        if not (np.isnan(float(s)) and np.isnan(float(r))):
            assert np.isclose(float(s), float(r), rtol=1e-5, atol=1e-6)
    assert bounds[4] == want[4]


def test_sharded_lp_solve_matches_the_jax_packages(world8):
    log, _, dual = world8[0]["lp"]["solve"]
    ref = JaxAGD(max_iter=40, gamma=1e-2, initial_step_size=1e-3, max_step_size=1e-1).maximize(
        JaxLP(_jax_lp(worker.random_lp(seed=3, sparse=True)), mesh=jax_mesh(4)), jnp.zeros(12, jnp.float32))
    np.testing.assert_allclose(log, np.asarray(ref.dual_objective_log), atol=5e-4)
    np.testing.assert_allclose(dual, np.asarray(ref.dual_val), atol=1e-4)


def test_joint_entry_spanning_the_even_split_snaps_and_solves(world8):
    A, args = worker.joint_lp()
    lam = jnp.asarray(np.abs(np.random.default_rng(14).normal(size=12)).astype(np.float32))
    jax_args = _jax_lp(args)
    sharded = JaxLP(jax_args, mesh=jax_mesh(8))
    single = JaxLP(jax_args).calculate(lam, gamma=1e-2, save_primal=True)
    for r in world8:
        bounds, grad, x, obj, ax, aty, xin = r["lp"]["joint"]
        assert bounds == list(sharded.ops._bounds)
        np.testing.assert_allclose(grad, np.asarray(single.dual_gradient), atol=1e-5)
        np.testing.assert_allclose(x, np.asarray(single.primal_var), atol=1e-5)
        assert np.isclose(obj, float(single.dual_objective), rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(ax, A @ xin, atol=1e-4)
        np.testing.assert_allclose(aty, A.T @ np.asarray(lam), atol=1e-4)


def test_run_solver_with_compute_device_num_2(world2):
    _, ranks = world2
    log, dual = ranks[0]["run_solver matching"]
    one = dualip_tpu_torch.run_solver(
        worker.golden_args(), dualip_tpu_torch.SolverArgs(max_iter=30, gamma=1e-3, initial_step_size=1e-5),
        dualip_tpu_torch.ComputeArgs(host_device="cpu"),
        dualip_tpu_torch.ObjectiveArgs(objective_kwargs={"use_pallas": True, "pallas_block_k": 8}))
    np.testing.assert_allclose(log, one.dual_objective_log, atol=1e-5)
    np.testing.assert_allclose(dual, one.dual_val.numpy(), atol=1e-5)
    for key in ("run_solver matching", "run_solver miplib2017"):
        assert ranks[1][key][0] == ranks[0][key][0]
        np.testing.assert_array_equal(ranks[1][key][1], ranks[0][key][1])
    assert [r["gloo captures"] for r in ranks] == [[], []]  # a gloo mesh on the CPU: the eager loop


def test_run_solver_miplib2017_on_two_ranks_matches_the_jax_package(world2):
    _, ranks = world2
    log, _ = ranks[0]["run_solver miplib2017"]
    ref = dualip_tpu.run_solver(
        _jax_lp(worker.random_lp(seed=7, sparse=True)),
        dualip_tpu.SolverArgs(max_iter=20, initial_step_size=1e-3, gamma=1e-2, max_step_size=1e-1),
        dualip_tpu.ComputeArgs(host_device="cpu", compute_device_num=4),
        dualip_tpu.ObjectiveArgs(objective_type="miplib2017"))
    assert np.isclose(log[-1], ref.dual_objective, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("compact", [False, True], ids=["plain", "compact"])
def test_mesh_tile_cache_warm_start_is_bit_identical(world2, compact):
    _, ranks = world2
    for r in ranks:
        got = r[("tile cache", compact)]
        assert got["cold_saved"] and got["warm_loaded"]
        assert got["warm"] == got["cold"]
        assert got["cold"] == ranks[0][("tile cache", compact)]["cold"]


@pytest.mark.parametrize("compact", [False, True], ids=["plain", "compact"])
def test_stacked_entry_has_the_jax_packages_bytes(world2, tmp_path, compact):
    """The ranks' stacked entry equals, file for file, the one the JAX
    package's two-device mesh objective writes for the same problem."""
    tmp, ranks = world2
    port = ranks[0][("tile cache", compact)]
    obj = JaxObjective(_jax_args(worker.random_matching(worker.CACHE_MATCHING)), gamma=1e-3, mesh=jax_mesh(2),
                       layout="butterfly", pallas_block_k=128, compact=compact, keep_flat_idx=False,
                       keep_col_tiles=False, plan_cache_dir=str(tmp_path / "plans"),
                       tile_cache_dir=str(tmp_path / "tiles"))
    assert obj.tile_cache_key == port["key"]
    ours, theirs = Path(tmp) / "tiles" / f"butterfly_{port['key']}", tmp_path / "tiles" / f"butterfly_{port['key']}"
    names = sorted(p.name for p in theirs.glob("*.npy"))
    assert names == sorted(p.name for p in ours.glob("*.npy"))
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    m_ours, m_theirs = json.loads((ours / "meta.json").read_text()), json.loads((theirs / "meta.json").read_text())
    assert list(m_ours) == list(m_theirs)
    assert [Path(p).name for p in m_ours.pop("plan_cache_file")] == [Path(p).name for p in m_theirs.pop("plan_cache_file")]
    assert m_ours == m_theirs
    for d, r in enumerate(ranks):  # a warm rank reads its own slice
        np.testing.assert_array_equal(r[("tile cache", compact)]["leaves"]["row_pos"],
                                      np.load(ours / "row_pos.npy")[d])


def test_a_mesh_solve_warm_starts_from_the_streamed_entry(world2, stream):
    _, ranks = world2
    for r in ranks:
        got = r["streamed"]
        assert got["key"] == got["expected_key"] == stream["key"] and got["loaded"]
        np.testing.assert_allclose(got["streamed"], got["direct"], atol=5e-4)
        assert got["streamed"] == ranks[0]["streamed"]["streamed"]


def test_streamed_entry_has_the_jax_packages_bytes(stream, tmp_path):
    key = stream["key"]
    jax_stream_build(stream["mm_dir"], (STREAM_SPEC[1], STREAM_SPEC[0]), _jax_map(stream["args"].projection_map), n_shards=2,
                     cache_dir=tmp_path / "tiles", key=key, plan_cache_dir=tmp_path / "plans", compact=True,
                     pad_cols_to=128)
    ours, theirs = Path(stream["entry"]), tmp_path / "tiles" / f"butterfly_{key}"
    names = sorted(p.name for p in theirs.glob("*.npy"))
    assert names == sorted(p.name for p in ours.glob("*.npy")) and names
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    m_ours, m_theirs = json.loads((ours / "meta.json").read_text()), json.loads((theirs / "meta.json").read_text())
    assert list(m_ours) == list(m_theirs)
    plans = [(Path(a).name, Path(b).name) for a, b in zip(m_ours.pop("plan_cache_file"), m_theirs.pop("plan_cache_file"))]
    assert all(a == b for a, b in plans) and m_ours == m_theirs
    for a, _ in plans:  # the routers' planes are the same
        with np.load(Path(stream["plans"]) / a) as p, np.load(tmp_path / "plans" / a) as q:
            np.testing.assert_array_equal(p["masks_packed"], q["masks_packed"])


def test_a_failing_rank_fails_the_run_without_hanging():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*rank 1 gives up"):
        run_ranks(worker.failing, 2, **RANKS)
    assert time.monotonic() - t0 < 40


def test_compute_device_num_without_a_process_group_raises():
    with pytest.raises(RuntimeError, match="torchrun"):
        dualip_tpu_torch.run_solver(worker.golden_args(), dualip_tpu_torch.SolverArgs(max_iter=2),
                                    dualip_tpu_torch.ComputeArgs(host_device="cpu", compute_device_num=2),
                                    dualip_tpu_torch.ObjectiveArgs())
    with pytest.raises(RuntimeError, match="torchrun"):
        default_mesh(2, device="cpu")


def test_a_mesh_and_another_device_are_refused():
    mesh = EntityMesh(group=None, rank=0, world_size=1, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="differs from the mesh's device"):
        MatchingSolverDualObjectiveFunction(worker.golden_args(), gamma=1e-3, mesh=mesh, device="cuda:0")
    with pytest.raises(TypeError, match="EntityMesh"):
        MIPLIB2017ObjectiveFunction(worker.random_lp(), mesh=object(), device="cpu")
