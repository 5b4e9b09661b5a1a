"""The single-process parts of the port's sharded solve, held to the JAX
package's on the CPU: the split utilities and per-rank pipeline
(``parallel/``), rank d's csc tiles and butterfly layout against what the JAX
package places on device d of its 8-device CPU mesh, the general LP's
snapped column cuts, the stacked ``.npy`` writer, and the streamed tile-cache
entry (byte for byte)."""

import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from dualip_tpu.io.streaming_build import stream_build_sharded_cache as jax_stream_build
from dualip_tpu.objectives.matching import (
    MatchingInputArgs as JaxArgs,
    MatchingSolverDualObjectiveFunction as JaxObjective,
)
from dualip_tpu.objectives.miplib import MIPLIB2017ObjectiveFunction as JaxLP, MIPLIBInputArgs as JaxLPArgs
from dualip_tpu.objectives.miplib import _ColShardedSparseOps
from dualip_tpu.parallel import (
    assemble_global_tiles as jax_assemble,
    default_mesh as jax_mesh,
    global_to_local_projection_map as jax_g2l,
    local_matching_shard as jax_local_shard,
    process_shard_bounds as jax_bounds,
    split_tensors_to_devices as jax_split,
)
from dualip_tpu.projections.base import ProjectionEntry as JaxEntry
from dualip_tpu.sparse import build_blockcsc as jax_build_blockcsc, csc_from_arrays as jax_csc_from_arrays
from dualip_tpu.sparse.rowmajor import build_row_layout_sharded as jax_sharded_layout
from dualip_tpu_torch.io import tile_cache
from dualip_tpu_torch.io.streaming_build import stream_build_sharded_cache
from dualip_tpu_torch.objectives.matching import transpose_tiles
from dualip_tpu_torch.objectives.miplib import _ColShardedOps
from dualip_tpu_torch.parallel import (
    EntityMesh,
    assemble_global_tiles,
    global_to_local_projection_map,
    local_matching_shard,
    process_shard_bounds,
    split_tensors_to_devices,
)
from dualip_tpu_torch.projections import create_projection_map
from dualip_tpu_torch.projections.base import ProjectionEntry
from dualip_tpu_torch.sparse.bcsc import build_blockcsc
from dualip_tpu_torch.sparse.rowmajor import _slice_bcsc_cols, build_row_layout_sharded
from dualip_tpu_torch.synthetic import _cache_path, generate_synthetic_matching_input_args

from tests import _torch_dist_worker as worker

torch.set_num_threads(1)


def _jax_map(pm):
    return {k: JaxEntry(e.proj_type, dict(e.proj_params), e.indices) for k, e in pm.items()}


def _jax_csc(M):
    return jax_csc_from_arrays(M.indptr, M.row_indices, M.data, M.shape)


def _jax_args(args):
    return JaxArgs(A=_jax_csc(args.A), c=_jax_csc(args.c), projection_map=_jax_map(args.projection_map),
                   b_vec=args.b_vec, equality_mask=args.equality_mask)


def _mixed_map(n, seed):
    """Entries of several kinds over a shuffled partition of the columns."""
    cols = np.random.default_rng(seed).permutation(n)
    cuts = np.sort(np.random.default_rng(seed + 1).choice(np.arange(1, n), 3, replace=False))
    parts = np.split(cols, cuts)
    kinds = [("simplex", {"z": 1.0}), ("box", {"l": 0.0, "u": 2.0}), ("simplex_eq", {"z": 1.0}), ("identity", {})]
    return {f"e{i}": ProjectionEntry(k, p, sorted(int(c) for c in part)) for i, ((k, p), part) in
            enumerate(zip(kinds, parts))}


def _same_csc(port, jax_m):
    for f in ("indptr", "row_indices", "data"):
        np.testing.assert_array_equal(np.asarray(getattr(port, f)), np.asarray(getattr(jax_m, f)))
    assert tuple(port.shape) == tuple(jax_m.shape)


def _same_map(port, jax_m):
    assert list(port) == list(jax_m)
    for k in port:
        assert port[k].proj_type == jax_m[k].proj_type and dict(port[k].proj_params) == dict(jax_m[k].proj_params)
        assert list(port[k].indices) == list(jax_m[k].indices)


@pytest.mark.parametrize("seed,lo,hi", [(0, 0, 40), (1, 10, 25), (2, 33, 60), (3, 59, 60)])
def test_global_to_local_projection_map_equals_the_jax_packages(seed, lo, hi):
    pm = _mixed_map(60, seed)
    local = list(range(lo, hi))
    _same_map(global_to_local_projection_map(pm, local), jax_g2l(_jax_map(pm), local))


@pytest.mark.parametrize("parts", [0, 1, 3, 8])
def test_split_tensors_to_devices_equals_the_jax_packages(parts):
    args = worker.random_matching()
    ours = split_tensors_to_devices(args.A, args.c, list(range(parts)))
    theirs = jax_split(_jax_csc(args.A), _jax_csc(args.c), list(range(parts)))
    assert ours[2] == theirs[2]
    for got, want in zip(ours[0] + ours[1], theirs[0] + theirs[1]):
        _same_csc(got, want)


@pytest.mark.parametrize("n", [1, 5, 7, 64, 1001])
def test_process_shard_bounds_equals_the_jax_packages(n):
    for pc in (1, 2, 3, 8):
        for pi in range(pc):
            assert process_shard_bounds(n, pi, pc) == jax_bounds(n, pi, pc)
    assert process_shard_bounds(n) == (0, n)  # no process group: one rank of one


@pytest.mark.parametrize("pc", [2, 3, 8])
def test_local_matching_shard_equals_the_jax_packages(pc):
    args = replace(worker.random_matching(), projection_map=_mixed_map(700, pc), equality_mask=np.arange(24) < 2)
    for pi in range(pc):
        ours, theirs = local_matching_shard(args, pi, pc), jax_local_shard(_jax_args(args), pi, pc)
        _same_csc(ours.A, theirs.A)
        _same_csc(ours.c, theirs.c)
        _same_map(ours.projection_map, theirs.projection_map)
        np.testing.assert_array_equal(ours.b_vec, theirs.b_vec)
        np.testing.assert_array_equal(ours.equality_mask, theirs.equality_mask)


def test_assemble_global_tiles_metadata_equals_the_jax_packages():
    args = worker.golden_args()
    local = local_matching_shard(args, 0, 1)
    ours = assemble_global_tiles(build_blockcsc(local.A, local.c, local.projection_map, pad_cols_to=8),
                                 EntityMesh(group=None, rank=0, world_size=1, device=torch.device("cpu")),
                                 col_offset=7, global_n=12, global_nnz=123)
    jl = jax_local_shard(_jax_args(args), 0, 1)
    theirs = jax_assemble(jax_build_blockcsc(jl.A, jl.c, jl.projection_map, pad_cols_to=8), jax_mesh(8),
                          col_offset=7, global_n=12, global_nnz=123)
    assert (ours.n, ours.nnz, ours.m) == (theirs.n, theirs.nnz, theirs.m) == (12, 123, 5)
    assert all(s.flat_idx is None for s in ours.specs)
    assert [(s.entry_key, s.K, s.L) for s in ours.specs] == [(s.entry_key, s.K, s.L) for s in theirs.specs]
    for t, u in zip(ours.tiles, theirs.tiles):
        for f in ("rows", "a", "c", "length", "col_ids"):
            np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(u, f)))
    assert ours.row_sum is not None  # serves the csc mesh path as the JAX tiles do


def _jax_shard(arr, mesh, d):
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return by_dev[mesh.devices.flat[d]]


@pytest.mark.parametrize("use_pallas", [False, True], ids=["csc", "use_pallas"])
@pytest.mark.parametrize("ws", [2, 4, 8])
def test_rank_d_csc_tiles_equal_the_jax_packages_shard_d(use_pallas, ws):
    """The host build, padded as the mesh objective pads it, sliced to rank d
    (``_slice_bcsc_cols``; (L, K) tiles on their K axis)."""
    args = replace(worker.random_matching(), projection_map=_mixed_map(700, 7))
    block_k = 128
    mesh = jax_mesh(ws)
    obj = JaxObjective(_jax_args(args), gamma=1e-3, mesh=mesh, use_pallas=use_pallas, pallas_block_k=block_k)
    bcsc = build_blockcsc(args.A, args.c, args.projection_map, pad_cols_to=ws * (block_k if use_pallas else 1))
    if use_pallas:
        bcsc = transpose_tiles(bcsc)
    for d in range(ws):
        mine = _slice_bcsc_cols(bcsc, d, ws)
        assert len(mine.tiles) == len(obj.bcsc.tiles)
        for t, u in zip(mine.tiles, obj.bcsc.tiles):
            for f in ("rows", "a", "c", "length", "col_ids"):
                np.testing.assert_array_equal(getattr(t, f), _jax_shard(getattr(u, f), mesh, d), err_msg=f"rank {d} {f}")


def _host_layout_leaves(rl):
    out = {"row_pos": rl.row_pos.numpy(), "masks": rl.plan.masks.numpy()}
    for i, pt in enumerate(rl.col_tiles_T):
        out.update({f"p{i}a": pt.a.numpy(), f"p{i}c": pt.c.numpy(), f"p{i}l": pt.length.numpy()})
    for i, rt in enumerate(rl.row_tiles):
        out.update({f"r{i}ids": rt.row_ids.numpy(), f"r{i}l": rt.length.numpy()})
    return out


@pytest.mark.parametrize("local_range", [None, (1, 3)], ids=["all", "local_range"])
@pytest.mark.parametrize("compact", [False, True], ids=["plain", "compact"])
def test_build_row_layout_sharded_shard_d_equals_the_jax_packages_leaf_d(compact, local_range):
    args = worker.random_matching()
    ws = 4
    kw = dict(pad_cols_to=ws * 128, keep_flat_idx=False, bucketing="exact" if compact else "pow2")
    ours = build_row_layout_sharded(build_blockcsc(args.A, args.c, args.projection_map, **kw), ws,
                                    local_range=local_range, compact=compact)
    ja = _jax_args(args)
    theirs = jax_sharded_layout(jax_build_blockcsc(ja.A, ja.c, ja.projection_map, **kw), ws, compact=compact)
    lo, hi = local_range or (0, ws)
    assert len(ours) == hi - lo
    for d, rl in zip(range(lo, hi), ours):
        assert rl.col_offsets == theirs.col_offsets and rl.row_shapes == theirs.row_shapes
        assert rl.col_pack == theirs.col_pack
        want = {"row_pos": theirs.row_pos, "masks": theirs.plan.masks}
        for i, pt in enumerate(theirs.col_tiles_T):
            want.update({f"p{i}a": pt.a, f"p{i}c": pt.c, f"p{i}l": pt.length})
        for i, rt in enumerate(theirs.row_tiles):
            want.update({f"r{i}ids": rt.row_ids, f"r{i}l": rt.length})
        got = _host_layout_leaves(rl)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], np.asarray(v)[d], err_msg=f"shard {d} {k}")


SNAP_CASES = [
    (40, 8, []),
    (40, 8, [(4, 6)]),
    (40, 8, [(13, 16)]),
    (40, 8, [(0, 30)]),
    (40, 8, [(3, 8), (33, 39)]),
    (101, 7, [(10, 25), (40, 41), (60, 99)]),
    (12, 5, [(2, 11)]),
]


@pytest.mark.parametrize("n,S,atoms", SNAP_CASES)
def test_snap_bounds_equal_the_jax_packages(n, S, atoms):
    ours = _ColShardedOps._snap_bounds(n, S, atoms)
    np.testing.assert_array_equal(ours, _ColShardedSparseOps._snap_bounds(n, S, atoms))
    assert ours[0] == 0 and ours[-1] == n and (np.diff(ours) >= 0).all()
    assert not any(lo < b < hi for b in ours for lo, hi in atoms)


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("problem", ["joint", "box"])
def test_column_cuts_equal_the_jax_packages(problem, S):
    """The cuts the sharded LP takes, a joint entry spanning the even split
    among them (``tests/distributed/test_miplib_sharded.py:92,136``)."""
    args = worker.joint_lp()[1] if problem == "joint" else worker.random_lp(seed=1, sparse=True)
    ja = JaxLP(JaxLPArgs(A=_jax_csc(args.A), c=args.c, projection_map=_jax_map(args.projection_map),
                         b_vec=args.b_vec, equality_mask=args.equality_mask), mesh=jax_mesh(S))
    np.testing.assert_array_equal(_ColShardedOps.shard_bounds(args.projection_map, 40, S), ja.ops._bounds)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, "bfloat16"])
def test_stacked_npy_has_the_bytes_of_np_save(tmp_path, dtype):
    """A stacked leaf written slice by slice has the bytes ``np.save`` (the
    JAX package's writer) gives the whole stack; bfloat16 as its ``<V2``."""
    rng = np.random.default_rng(0)
    parts = [rng.normal(size=(3, 5)).astype(np.float32) for _ in range(4)]
    bf16 = dtype == "bfloat16"
    if bf16:
        jax_parts = [p.astype(ml_dtypes.bfloat16) for p in parts]
        parts = [torch.from_numpy(p).to(torch.bfloat16).view(torch.int16).numpy() for p in parts]
    else:
        parts = jax_parts = [p.astype(dtype) for p in parts]
    path = tmp_path / "leaf.npy"
    tile_cache._create_stacked(path, (4, 3, 5), parts[0].dtype, bf16)
    for i in (2, 0, 3, 1):
        tile_cache._write_slice(path, i, parts[i])
    np.save(tmp_path / "want.npy", np.stack(jax_parts))
    assert path.read_bytes() == (tmp_path / "want.npy").read_bytes()


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_entry_equals_the_jax_packages_byte_for_byte(tmp_path, monkeypatch, compact, dtype):
    ns, nd, sp, seed = 1200, 24, 0.07, 4
    monkeypatch.setenv("DUALIP_GEN_MEMMAP", "1")
    args = generate_synthetic_matching_input_args(ns, nd, sp, seed=seed, cache_dir=str(tmp_path))
    mm_dir = _cache_path(str(tmp_path), ns, nd, sp, np.float32, (seed, "numpy")).with_suffix(".mm")
    kw = dict(shape=(nd, ns), n_shards=3, key="k", compact=compact, pad_cols_to=128)
    ours = stream_build_sharded_cache(mm_dir, projection_map=args.projection_map, cache_dir=tmp_path / "ours",
                                      plan_cache_dir=tmp_path / "plans_ours", dtype=dtype, **kw)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    theirs = jax_stream_build(mm_dir, projection_map=_jax_map(args.projection_map), cache_dir=tmp_path / "theirs",
                              plan_cache_dir=tmp_path / "plans_theirs", dtype=jdt, **kw)
    names = sorted(p.name for p in Path(theirs).glob("*.npy"))
    assert names and names == sorted(p.name for p in Path(ours).glob("*.npy"))
    for name in names:
        assert (Path(ours) / name).read_bytes() == (Path(theirs) / name).read_bytes(), name
    m_ours, m_theirs = (json.loads((Path(p) / "meta.json").read_text()) for p in (ours, theirs))
    assert list(m_ours) == list(m_theirs)
    assert [Path(p).name for p in m_ours.pop("plan_cache_file")] == [Path(p).name for p in m_theirs.pop("plan_cache_file")]
    assert m_ours == m_theirs
    again = stream_build_sharded_cache(mm_dir, projection_map=args.projection_map, cache_dir=tmp_path / "ours",
                                       plan_cache_dir=tmp_path / "plans_ours", dtype=dtype, **kw)
    assert again == ours  # a hit: nothing rebuilt
