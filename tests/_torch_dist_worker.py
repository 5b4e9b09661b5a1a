"""Rank bodies of ``tests/test_torch_distributed.py``.

``dualip_tpu_torch.parallel.run_ranks`` runs them in spawned processes, one
per rank, on the CPU with gloo; each process imports this module afresh, so
it imports the port only (no JAX) and returns plain Python and numpy values.
"""

from __future__ import annotations

import contextlib
import types

import numpy as np
import torch
import torch.distributed as dist

from dualip_tpu_torch.objectives.matching import (
    MatchingInputArgs,
    MatchingSolverDualObjectiveFunction,
    MatchingSolverDualObjectiveFunctionDistributed,
    matching_tile_cache_key,
    transpose_tiles,
)
from dualip_tpu_torch.objectives.miplib import MIPLIB2017ObjectiveFunction, MIPLIBInputArgs
from dualip_tpu_torch.optimizers import agd as agd_mod
from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent
from dualip_tpu_torch.parallel import EntityMesh, assemble_global_tiles, local_matching_shard, process_shard_bounds
from dualip_tpu_torch.projections import create_projection_map
from dualip_tpu_torch.projections.base import ProjectionEntry
from dualip_tpu_torch.sparse import csc_from_dense
from dualip_tpu_torch.sparse.bcsc import build_blockcsc, device_put_blockcsc, tiles_values_to_flat
from dualip_tpu_torch.sparse.rowmajor import _slice_bcsc_cols
from dualip_tpu_torch.synthetic import generate_synthetic_matching_input_args
from dualip_tpu_torch.utils import profiling

A_COMPACT = np.array(
    [
        [0.307766110869125, 0.483770735096186, 0.624996477039531, 0.669021712383255, 0.535811153938994],
        [0.257672501029447, 0.812402617651969, 0.882165518123657, 0.204612161964178, 0.710803845431656],
        [0.552322433330119, 0.370320537127554, 0.28035383997485, 0.357524853432551, 0.538348698290065],
        [0.0563831503968686, 0.546558595029637, 0.398487901547924, 0.359475114848465, 0.74897222686559],
        [0.468549283919856, 0.170262051047757, 0.76255108229816, 0.690290528349578, 0.420101450523362],
    ],
    dtype=np.float32,
)

# the golden trace's layouts: keywords and the mesh sizes each runs at
GOLDEN_CASES = {
    "csc": ({}, (2, 4, 8)),
    "use_pallas": ({"use_pallas": True, "pallas_block_k": 8}, (2, 4, 8)),
    "butterfly": ({"layout": "butterfly", "pallas_block_k": 128}, (2, 8)),
    "compact": ({"layout": "butterfly", "pallas_block_k": 128, "compact": True}, (2, 8)),
}
# the random problem's layouts whose rank tiles the tests hold to the JAX package's shards
TILE_CASES = {
    "csc": {},
    "use_pallas": {"use_pallas": True, "pallas_block_k": 128},
    "butterfly": {"layout": "butterfly", "pallas_block_k": 128},
    "compact": {"layout": "butterfly", "pallas_block_k": 128, "compact": True},
}
# the csc layouts whose rank-local tiles the tests hold to the whole build's slice, at 2 and 4 ranks
SHARD_CASES = {
    "csc": {},
    "use_pallas": {"use_pallas": True, "pallas_block_k": 32},
}
RANDOM_MATCHING = (700, 24, 0.08, 3)  # sources, destinations, sparsity, seed
CACHE_MATCHING = (500, 20, 0.08, 5)


def golden_args(b: bool = True) -> MatchingInputArgs:
    return MatchingInputArgs(A=csc_from_dense(A_COMPACT.T), c=csc_from_dense(-A_COMPACT.T),
                             projection_map=create_projection_map("simplex", {"z": 1}, 5),
                             b_vec=np.full(5, 0.7, np.float32) if b else None)


def random_matching(spec=RANDOM_MATCHING) -> MatchingInputArgs:
    ns, nd, sp, seed = spec
    return generate_synthetic_matching_input_args(ns, nd, sp, rng=np.random.default_rng(seed))


def shard_args() -> MatchingInputArgs:
    """301 columns with empty ones among them, 21 that no entry covers (the
    ``__identity__`` entry), in tiles whose K leaves the last ranks' slabs
    padding columns at 2 and 4 ranks."""
    rng = np.random.default_rng(23)
    m, n = 24, 301
    a = ((rng.random((m, n)) < 0.12) * rng.random((m, n))).astype(np.float32)
    a[:, [0, 7, 150, 299]] = 0.0
    pm = {"simplex": ProjectionEntry("simplex", {"z": 1.0}, np.arange(280))}
    return MatchingInputArgs(A=csc_from_dense(a), c=csc_from_dense(-a), projection_map=pm,
                             b_vec=np.full(m, 0.5, np.float32))


def sliced_whole_build(args: MatchingInputArgs, mesh: EntityMesh, use_pallas=False, pallas_block_k=1024):
    """The host tiles a csc mesh rank kept before it built only its own
    columns: the whole problem's tiles (transposed for ``use_pallas``), cut
    to the rank's columns; the specs keep the whole tiles' flat_idx."""
    pad = mesh.world_size * (pallas_block_k if use_pallas else 1)
    whole = build_blockcsc(args.A, args.c, args.projection_map, pad_cols_to=pad)
    return _slice_bcsc_cols(transpose_tiles(whole) if use_pallas else whole, mesh.rank, mesh.world_size)


def _primal_from_the_whole_flat_idx(obj, dual) -> np.ndarray:
    """``calculate(save_primal=True)``'s primal as a csc mesh objective
    scattered it when its specs held the whole tiles' flat_idx: every rank's x
    gathered in rank order and scattered through them."""
    _, _, _, xs = obj._local(obj.bcsc, dual, obj.gamma, want_primal=True)
    axis = 1 if obj.use_pallas else 0
    xs = [torch.cat(obj.mesh.all_gather(x), dim=axis).cpu().numpy() for x in xs]
    return tiles_values_to_flat(obj.bcsc, [x.T if obj.use_pallas else x for x in xs])


def own_columns(mesh: EntityMesh, kw: dict) -> dict:
    """A csc mesh objective built from the rank's own columns: its tiles, its
    specs' (K, L) and flat_idx, the build's shard counters; a solve on it and
    on the same objective holding the whole build's slice instead, and the
    primal at the solve's dual from each (the second scattered as before)."""
    names = ("dualip.build.shard_columns", "dualip.build.shard_slots")
    before = [profiling.counter(n) for n in names]
    obj = MatchingSolverDualObjectiveFunction(shard_args(), gamma=1e-3, mesh=mesh, **kw)
    out = {"leaves": _rank_leaves(obj), "counters": [profiling.counter(n) - b for n, b in zip(names, before)],
           "specs": [(s.entry_key, s.K, s.L) for s in obj.bcsc.specs],
           "flat_idx": [s.flat_idx for s in obj.bcsc.specs]}
    sliced = MatchingSolverDualObjectiveFunction(shard_args(), gamma=1e-3, mesh=mesh, **kw)
    sliced.bcsc = device_put_blockcsc(sliced_whole_build(shard_args(), mesh, **kw), mesh.device, row_sum=True)
    solve = dict(iters=20, initial_step_size=1e-3, max_step_size=1e-1)
    out["solve"], out["solve_sliced"] = _solve(obj, **solve), _solve(sliced, **solve)
    dual = torch.as_tensor(out["solve"][2])
    out["primal"] = np.asarray(obj.calculate(dual, save_primal=True).primal_var)
    out["primal_sliced"] = _primal_from_the_whole_flat_idx(sliced, dual)
    return out


def random_lp(seed=0, m=12, n=40, sparse=False) -> MIPLIBInputArgs:
    """``tests/distributed/test_miplib_sharded.py::_random_lp``'s problem."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    if sparse:
        A[rng.random(size=(m, n)) < 0.6] = 0.0
        A[:, 0] = np.where(A[:, 0] == 0, 0.5, A[:, 0])
    c = rng.normal(size=n).astype(np.float32)
    b = np.abs(rng.normal(size=m)).astype(np.float32) + 0.5
    pm = create_projection_map("box", {"l": 0.0, "u": 1.0}, n)
    eq = np.zeros(m, dtype=bool)
    eq[0] = True
    return MIPLIBInputArgs(A=csc_from_dense(A) if sparse else A, c=c, projection_map=pm, b_vec=b, equality_mask=eq)


def joint_lp():
    """``test_joint_entry_spanning_even_split_snaps_and_solves``'s problem."""
    m, n = 12, 40
    rng = np.random.default_rng(13)
    A = rng.normal(size=(m, n)).astype(np.float32)
    A[rng.random(size=(m, n)) < 0.5] = 0.0
    A[:, 0] = np.where(A[:, 0] == 0, 0.5, A[:, 0])
    c = rng.normal(size=n).astype(np.float32)
    b = np.abs(rng.normal(size=m)).astype(np.float32) + 0.5
    pm = {
        "blk": ProjectionEntry("simplex", {"z": 1.0}, np.arange(3, 8)),
        "blk2": ProjectionEntry("simplex", {"z": 1.0}, np.arange(33, 39)),
        "rest": ProjectionEntry("box", {"l": 0.0, "u": 1.0},
                                np.concatenate([np.arange(0, 3), np.arange(8, 33), np.arange(39, 40)])),
    }
    return A, MIPLIBInputArgs(A=csc_from_dense(A), c=c, projection_map=pm, b_vec=b)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _solve(obj, iters=30, gamma=1e-3, lam0=None, **kw):
    """(dual log, primal or None, final dual) of an AGD solve."""
    m = obj.b_vec.shape[0]
    lam0 = torch.full((m,), 0.1) if lam0 is None else lam0
    res = AcceleratedGradientDescent(max_iter=iters, gamma=gamma, **kw).maximize(obj, lam0)
    x = res.objective_result.primal_var
    return list(res.dual_objective_log), (None if x is None else np.asarray(x)), _np(res.dual_val)


@contextlib.contextmanager
def emulated_capture():
    """``_Graph._capture`` without a card (as ``tests/test_torch_agd_chunks.py``
    emulates it): each replay runs the captured iteration again, collective
    included, on the graph's static buffers.  Yields the list of the captured
    objectives' names."""
    captured = []

    def capture(self):
        captured.append(self.what)
        self.graph = types.SimpleNamespace(replay=self._advance)

    real = agd_mod._Graph._capture
    agd_mod._Graph._capture = capture
    try:
        yield captured
    finally:
        agd_mod._Graph._capture = real


def graph_and_eager(obj, iters=30, gamma=1e-3, lam0=None, **kw) -> dict:
    """One mesh objective solved on the graph path (``_maximize(...,
    graph=True)``, the capture emulated) and in the eager loop, each on a
    solver of its own, with ``save_primal`` (its all-gather runs after the
    loop, outside the graph): (log, final dual, gradient, primal) of each and
    the captures."""
    m = obj.b_vec.shape[0]
    lam0 = torch.full((m,), 0.1) if lam0 is None else lam0
    out = {}
    with emulated_capture() as captured:
        for path in ("graph", "eager"):
            agd = AcceleratedGradientDescent(max_iter=iters, gamma=gamma, save_primal=True, **kw)
            res = agd._maximize(obj, lam0, 0, None, graph=path == "graph")
            r = res.objective_result
            out[path] = (list(res.dual_objective_log), _np(res.dual_val), _np(r.dual_gradient),
                         np.asarray(r.primal_var.cpu() if isinstance(r.primal_var, torch.Tensor) else r.primal_var))
    out["captures"] = captured
    return out


def _sub_meshes(mesh: EntityMesh, sizes) -> dict:
    """One mesh over ranks [0, ws) for each size; every rank takes part in
    each group's creation, in the same order."""
    out = {}
    for ws in sizes:
        group = dist.new_group(list(range(ws)))
        if mesh.rank < ws:
            out[ws] = EntityMesh(group=group, rank=mesh.rank, world_size=ws, device=mesh.device)
    return out


def _rank_leaves(obj) -> dict:
    """The leaves of a rank's shard as numpy: tiles (csc) or the layout."""
    rl = obj.row_layout
    if rl is None:
        return {f"tile{i}_{f}": _np(getattr(t, f)) for i, t in enumerate(obj.bcsc.tiles)
                for f in ("rows", "a", "c", "length", "col_ids")}
    out = {"row_pos": _np(rl.row_pos), "col_offsets": rl.col_offsets, "row_shapes": rl.row_shapes,
           "col_pack": rl.col_pack, "plan_masks": _np(rl.plan.masks)}
    for i, pt in enumerate(rl.col_tiles_T):
        out.update({f"panel{i}_a": _np(pt.a), f"panel{i}_c": _np(pt.c), f"panel{i}_len": _np(pt.length)})
    for i, rt in enumerate(rl.row_tiles):
        out.update({f"rowtile{i}_ids": _np(rt.row_ids), f"rowtile{i}_len": _np(rt.length)})
    return out


def world8(mesh: EntityMesh) -> dict:
    """Eight ranks carry the 8-, 4- and 2-rank cases through sub-groups, the
    widest first: every rank of a group does the same work, and a rank leaves
    when no narrower group holds it, so none waits long in a collective."""
    meshes = _sub_meshes(mesh, (2, 4, 8))
    out = {"golden": {}, "tiles": {}, "lp": {}, "graph": {}, "shard": {}}
    inp = random_matching()
    lam = np.random.default_rng(2).normal(size=12).astype(np.float32)
    for ws in (8, 4, 2):
        if ws not in meshes:
            break
        sub = meshes[ws]
        for name, (kw, sizes) in GOLDEN_CASES.items():
            if ws in sizes:
                obj = MatchingSolverDualObjectiveFunction(golden_args(), gamma=1e-3, mesh=sub, **kw)
                out["golden"][(name, ws)] = _solve(obj, save_primal=True)
                out["graph"][(name, ws)] = graph_and_eager(obj)
        if ws in (2, 8):
            for name, kw in TILE_CASES.items():
                out["tiles"][(name, ws)] = _rank_leaves(
                    MatchingSolverDualObjectiveFunction(inp, gamma=1e-3, mesh=sub, **kw))
            for sparse in (False, True):
                r = MIPLIB2017ObjectiveFunction(random_lp(seed=1, sparse=sparse), mesh=sub).calculate(
                    torch.as_tensor(lam), gamma=1e-2)
                out["lp"][("calculate", sparse, ws)] = (_np(r.dual_gradient), float(r.dual_objective),
                                                        float(r.reg_penalty))
        if ws in (2, 4):
            for name, kw in SHARD_CASES.items():
                out["shard"][(name, ws)] = own_columns(sub, kw)
        if ws == 8:
            A, args = joint_lp()
            lam_j = torch.as_tensor(np.abs(np.random.default_rng(14).normal(size=12)).astype(np.float32))
            obj = MIPLIB2017ObjectiveFunction(args, mesh=sub)
            r = obj.calculate(lam_j, gamma=1e-2, save_primal=True)
            x = torch.as_tensor(np.random.default_rng(13).normal(size=40).astype(np.float32))
            out["lp"]["joint"] = (list(obj.ops._bounds), _np(r.dual_gradient), _np(r.primal_var),
                                  float(r.dual_objective), _np(obj.ops.matvec(x)), _np(obj.ops.rmatvec(lam_j)),
                                  _np(x))
        if ws == 4:
            lp_kw = dict(iters=40, gamma=1e-2, lam0=torch.zeros(12), initial_step_size=1e-3, max_step_size=1e-1)
            obj = MIPLIB2017ObjectiveFunction(random_lp(seed=3, sparse=True), mesh=sub)
            out["lp"]["solve"] = _solve(obj, **lp_kw)
            for sparse in (False, True):
                obj = MIPLIB2017ObjectiveFunction(random_lp(seed=3, sparse=sparse), mesh=sub)
                out["graph"][("lp " + ("coo" if sparse else "dense"), ws)] = graph_and_eager(obj, **lp_kw)
        if ws == 2:
            obj = MatchingSolverDualObjectiveFunctionDistributed(
                golden_args(b=False), b_vec=np.full(5, 0.7, np.float32), gamma=1e-3, host_device="cpu", mesh=sub)
            out["golden"][("distributed wrapper", 2)] = _solve(obj)
            # a rank's own shard (contiguous columns), assembled, in place of the objective's tiles
            obj = MatchingSolverDualObjectiveFunction(golden_args(), gamma=1e-3, mesh=sub)
            local = local_matching_shard(golden_args(), sub.rank, 2)
            obj.bcsc = assemble_global_tiles(build_blockcsc(local.A, local.c, local.projection_map), sub,
                                             global_n=5, global_nnz=25)
            out["golden"][("assembled tiles", 2)] = _solve(obj)
            out["assembled_col_ids"] = [_np(t.col_ids) for t in obj.bcsc.tiles]
            out["shard_bounds"] = process_shard_bounds(5, sub.rank, 2)
            lam_pos = torch.as_tensor(np.abs(np.random.default_rng(6).normal(size=12)).astype(np.float32))
            obj = MIPLIB2017ObjectiveFunction(random_lp(seed=5, sparse=True), use_jacobi_precondition=True, mesh=sub)
            r = obj.calculate(lam_pos, gamma=1e-2)
            out["lp"]["jacobi"] = (_np(r.dual_gradient), obj.calculate_convergence_bound(lam_pos, tol=1e-4))
    return out


def world2(mesh: EntityMesh, tmp: str, stream: dict) -> dict:
    """Two ranks: ``run_solver``, the stacked tile cache cold and warm, and a
    solve that warm-starts from the streamed entry."""
    import dualip_tpu_torch as dt

    out = {}
    solver = dt.SolverArgs(max_iter=30, gamma=1e-3, initial_step_size=1e-5)
    with emulated_capture() as captured:  # a gloo mesh runs the eager loop: nothing is captured
        res = dt.run_solver(golden_args(), solver, dt.ComputeArgs(host_device="cpu", compute_device_num=2),
                            dt.ObjectiveArgs(objective_kwargs={"use_pallas": True, "pallas_block_k": 8}))
    out["run_solver matching"] = (list(res.dual_objective_log), _np(res.dual_val))
    out["gloo captures"] = captured
    lp = dict(solver_args=dt.SolverArgs(max_iter=20, initial_step_size=1e-3, gamma=1e-2, max_step_size=1e-1),
              objective_args=dt.ObjectiveArgs(objective_type="miplib2017"))
    res = dt.run_solver(random_lp(seed=7, sparse=True), compute_args=dt.ComputeArgs(host_device="cpu",
                        compute_device_num=2), **lp)
    out["run_solver miplib2017"] = (list(res.dual_objective_log), _np(res.dual_val))

    inp = random_matching(CACHE_MATCHING)
    for compact in (False, True):
        kw = dict(gamma=1e-3, mesh=mesh, layout="butterfly", pallas_block_k=128, compact=compact,
                  keep_flat_idx=False, keep_col_tiles=False, plan_cache_dir=f"{tmp}/plans",
                  tile_cache_dir=f"{tmp}/tiles")
        cold, cold_spans, _ = _built(lambda: MatchingSolverDualObjectiveFunction(inp, **kw))
        warm, warm_spans, warm_hits = _built(lambda: MatchingSolverDualObjectiveFunction(inp, **kw))
        out[("tile cache", compact)] = {
            "key": cold.tile_cache_key, "cold_saved": "dualip.tile_cache.write" in cold_spans,
            "warm_loaded": warm_hits == 1 and not {"dualip.build.route", "dualip.tile_cache.write"} & warm_spans,
            "cold": _solve(cold, iters=10)[0], "warm": _solve(warm, iters=10)[0], "leaves": _rank_leaves(warm)}

    inp = random_matching(stream["spec"])
    kw = dict(gamma=1e-3, mesh=mesh, layout="butterfly", pallas_block_k=128, compact=True, keep_flat_idx=False,
              keep_col_tiles=False, plan_cache_dir=stream["plans"])
    streamed, streamed_spans, streamed_hits = _built(
        lambda: MatchingSolverDualObjectiveFunction(inp, tile_cache_dir=stream["tiles"], **kw))
    direct = MatchingSolverDualObjectiveFunction(inp, **kw)
    key = matching_tile_cache_key(inp, n_shards=2, pallas_block_k=128, compact=True)
    zero = torch.zeros(inp.b_vec.shape[0])
    out["streamed"] = {
        "key": streamed.tile_cache_key, "expected_key": key,
        "loaded": streamed_hits == 1 and "dualip.build.route" not in streamed_spans,
        "streamed": _solve(streamed, iters=15, lam0=zero, initial_step_size=1e-3, max_step_size=1e-1)[0],
        "direct": _solve(direct, iters=15, lam0=zero, initial_step_size=1e-3, max_step_size=1e-1)[0]}
    return out


def _built(make):
    """``make()``, the names of the store's records its call made, and the
    tile cache's hits it counted."""
    since, hits = profiling.STORE.ids, profiling.counter("dualip.tile_cache.loaded")
    obj = make()
    names = {e.name for e in profiling.STORE.events if e.id > since}
    return obj, names, profiling.counter("dualip.tile_cache.loaded") - hits


def failing(mesh: EntityMesh):
    """Rank 1 raises; rank 0 waits in an all_reduce that rank 1 never joins."""
    if mesh.rank == 1:
        raise ValueError("rank 1 gives up")
    mesh.all_reduce_(torch.ones(3))
    return "unreachable"
