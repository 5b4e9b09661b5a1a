"""Device-ready butterfly-layout cache (``dualip_tpu/io/tile_cache.py``).

Building the butterfly layout is O(nnz) host work that gives the same arrays
every time: the tile fill, the row argsort, the panel transposes.  This module
keeps those arrays once, in their device-ready form (panel-form a/c/length,
row-tile ids/lengths, ``row_pos``, the tiles' specs), as plain ``.npy`` files
and one ``meta.json``; a warm start reads them memory-mapped and places each
on the device once.  The Benes plan stays in its own cache
(``plan_cache_dir``); ``meta.json`` names its file, and a hit packs the plan
straight from that file's bit-planes (``ops/butterfly.py::pack_plan_from_planes``,
which on a CUDA device also builds the K5/K7 source index).

The key and the bytes are the JAX package's: for the same problem and options
both packages compute the same key, and an entry written by either loads in
the other.  Bfloat16 panels are written as the JAX package writes them (the
bf16 bits under the ``.npy`` type ``<V2``) and read back through a 16-bit
view.

Scope: the ``layout="butterfly"`` objective with ``keep_col_tiles=False``
and ``keep_flat_idx=False``, on one device or sharded over a mesh.  A sharded
solve's entry is stacked: every leaf carries a leading shard axis, and
``meta.json`` names one plan file per shard, as in the JAX package.  The
ranks write it together (``save_sharded_butterfly_state``), and a rank that
loads it reads only its own slice (``load_butterfly_state(..., shard=)``).
Not pickle: arrays are raw ``.npy`` and the metadata JSON, so a cache entry
cannot run code.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from dualip_tpu_torch.sparse.bcsc import BlockCSC, TileSpec, is_bfloat16
from dualip_tpu_torch.utils import profiling

CACHE_VERSION = 1


def _dtype_name(dtype) -> str:
    """The numpy name of a tile dtype in any of the port's spellings."""
    if is_bfloat16(dtype):
        return "bfloat16"
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def compute_cache_key(A, C, projection_map, pad: int, dtype, explicit: Optional[str], extra: str = "") -> str:
    """Cache key of a (problem, layout options) pair.

    ``explicit`` (the caller's own name for the problem, e.g. the generator's
    cache key) skips hashing the problem's arrays and folds in only each
    projection entry's size; without it the key hashes ``indptr``,
    ``row_indices``, ``A.data`` and ``C.data`` and each entry's indices.
    ``pad`` and the shape enter as Python ints, as the JAX package's
    constructors give them."""
    h = hashlib.sha1()
    if explicit is not None:
        h.update(explicit.encode())

        def idx_id(e):
            return len(e.indices)
    else:
        for arr in (A.indptr, A.row_indices, A.data, C.data):
            h.update(np.ascontiguousarray(arr).tobytes())

        def idx_id(e):  # membership matters, not only the size
            return hashlib.sha1(np.ascontiguousarray(np.asarray(e.indices)).tobytes()).hexdigest()

    pm = sorted(
        (k, e.proj_type, tuple(sorted(dict(e.proj_params).items())), idx_id(e)) for k, e in projection_map.items()
    )
    shape = tuple(int(x) for x in A.shape)
    h.update(repr((CACHE_VERSION, pm, int(pad), _dtype_name(dtype), shape, extra)).encode())
    return h.hexdigest()[:20]


def _host(t: torch.Tensor, bf16: bool = False) -> np.ndarray:
    """A leaf of the placed layout copied back to the host; ``bf16``: its
    values as bfloat16 bits (int16)."""
    t = t.detach()
    return (t.to(torch.bfloat16).view(torch.int16) if bf16 else t).contiguous().cpu().numpy()


def _save(path: Path, arr: np.ndarray, bf16: bool) -> None:
    """``np.save``; ``bf16``: the bits under the type ``<V2``, the bytes
    ``np.save`` writes for the JAX package's bfloat16 arrays."""
    if not bf16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())


def _create_stacked(path: Path, shape: tuple, dtype, bf16: bool) -> None:
    """An ``.npy`` of ``shape`` filled with zeros, its header as ``np.save``
    (or ``open_memmap``) writes it for an array of ``dtype``; ``bf16``: the
    JAX package's ``<V2`` header."""
    descr = "<V2" if bf16 else np.lib.format.dtype_to_descr(np.dtype(dtype))
    itemsize = 2 if bf16 else np.dtype(dtype).itemsize
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {"descr": descr, "fortran_order": False, "shape": tuple(shape)})
        f.truncate(f.tell() + int(np.prod(shape)) * itemsize)


def _write_slice(path: Path, index: int, arr: np.ndarray) -> None:
    """``arr`` into slice ``[index]`` of the stacked ``.npy`` at ``path``, in
    place (a ``V2`` file takes bfloat16 bits as int16)."""
    mm = np.load(path, mmap_mode="r+")
    if mm.dtype.kind == "V":
        mm = mm.view(np.int16)
    mm[index] = arr
    mm.flush()
    del mm


def _leaves(bcsc, rl) -> dict:
    """file name -> (host array, written as bfloat16) of a placed layout."""
    bf16 = bcsc.value_dtype == torch.bfloat16
    leaves = {}
    for i, pt in enumerate(rl.col_tiles_T):
        leaves[f"panel{i}_a"] = (_host(pt.a, bf16), bf16)
        leaves[f"panel{i}_c"] = (_host(pt.c, bf16), bf16)
        leaves[f"panel{i}_len"] = (_host(pt.length), False)
    for i, rt in enumerate(rl.row_tiles):
        leaves[f"rowtile{i}_ids"] = (_host(rt.row_ids), False)
        leaves[f"rowtile{i}_len"] = (_host(rt.length), False)
    leaves["row_pos"] = (_host(rl.row_pos), False)
    return leaves


def _meta(bcsc, rl, n_shards: int, plan_cache_file) -> dict:
    """``meta.json`` with the JAX package's keys in its order."""
    return {
        "version": CACHE_VERSION,
        "m": bcsc.m,
        "n": bcsc.n,
        "nnz": bcsc.nnz,
        "n_shards": n_shards,
        "plan_cache_file": str(plan_cache_file) if n_shards == 1 else [str(p) for p in plan_cache_file],
        "col_offsets": list(rl.col_offsets),
        "row_shapes": [list(s) for s in rl.row_shapes],
        "col_pack": [list(p) for p in rl.col_pack] if rl.col_pack is not None else None,
        "specs": [
            {"entry_key": s.entry_key, "proj_type": s.proj_type,
             "proj_params": [[k, v] for k, v in s.proj_params], "K": s.K, "L": s.L}
            for s in bcsc.specs
        ],
    }


def _fresh_tmp(d: Path) -> Path:
    tmp = d.with_name(d.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    return tmp


def _publish(tmp: Path, d: Path, meta: dict) -> None:
    """``meta.json`` last, then one atomic rename; a process that lost the
    race keeps the winner's entry."""
    (tmp / "meta.json").write_text(json.dumps(meta))
    if d.exists():
        shutil.rmtree(tmp)
        return
    try:
        tmp.replace(d)
    except OSError:  # another process published between the check and the rename
        shutil.rmtree(tmp, ignore_errors=True)


@profiling.timed("dualip.tile_cache.save")
def save_butterfly_state(cache_dir, key: str, bcsc, rl, plan_cache_file, n_shards: int = 1) -> None:
    """Write the device-ready butterfly state of ``bcsc`` (its specs and sizes)
    and ``rl`` under ``cache_dir/butterfly_<key>``, published by one atomic
    rename.  The leaves are copied back from ``rl``'s device first, as the JAX
    package does.  The save is the span ``dualip.tile_cache.save`` of
    ``utils/profiling.py``, the copy and the write its spans
    ``dualip.tile_cache.copy`` and ``dualip.tile_cache.write``.  One device
    only: a sharded solve's ranks write the stacked entry together
    (``save_sharded_butterfly_state``)."""
    if n_shards > 1:
        raise ValueError("a stacked entry (n_shards > 1) is written by all ranks together: "
                         "save_sharded_butterfly_state(cache_dir, key, bcsc, rl, mesh)")
    with profiling.span("dualip.tile_cache.copy", always=True):
        leaves = _leaves(bcsc, rl)
    with profiling.span("dualip.tile_cache.write", always=True):
        d = Path(cache_dir) / f"butterfly_{key}"
        tmp = _fresh_tmp(d)
        for name, (arr, as_bf16) in leaves.items():
            _save(tmp / f"{name}.npy", arr, as_bf16)
        _publish(tmp, d, _meta(bcsc, rl, 1, plan_cache_file))


@profiling.timed("dualip.tile_cache.save")
def save_sharded_butterfly_state(cache_dir, key: str, bcsc, rl, mesh) -> None:
    """The stacked entry of a sharded solve, written by every rank of
    ``mesh`` together (a collective): rank 0 preallocates each stacked
    ``.npy``, each rank writes its layout ``rl`` into its slice ``[rank]``
    after a barrier, and rank 0 publishes ``meta.json`` (one plan file per
    shard) by one atomic rename.  This rank's copy back and write are the
    spans ``dualip.tile_cache.copy`` and ``dualip.tile_cache.write``."""
    plan_files = mesh.all_gather_object(rl.plan_cache_path)
    if any(p is None for p in plan_files):
        raise ValueError(f"a stacked entry needs one plan-cache file per shard (got {plan_files!r})")
    with profiling.span("dualip.tile_cache.copy", always=True):
        leaves = _leaves(bcsc, rl)
    with profiling.span("dualip.tile_cache.write", always=True):
        d = Path(cache_dir) / f"butterfly_{key}"
        tmp = d.with_name(d.name + ".tmp")
        if mesh.rank == 0:
            tmp = _fresh_tmp(d)
            for name, (arr, as_bf16) in leaves.items():
                _create_stacked(tmp / f"{name}.npy", (mesh.world_size,) + arr.shape, arr.dtype, as_bf16)
        mesh.barrier()
        for name, (arr, _) in leaves.items():
            _write_slice(tmp / f"{name}.npy", mesh.rank, arr)
        mesh.barrier()
        if mesh.rank == 0:
            _publish(tmp, d, _meta(bcsc, rl, mesh.world_size, plan_files))
        mesh.barrier()


def _load_leaf(path: Path, device: torch.device, index: Optional[int] = None) -> torch.Tensor:
    """One ``.npy`` leaf (its slice ``[index]`` when given), read
    memory-mapped and copied to ``device`` once (no tensor stays aliased to
    the file); ``<V2`` leaves are bfloat16."""
    arr = np.load(path, mmap_mode="r")
    bf16 = arr.dtype.kind == "V" or arr.dtype.name == "bfloat16"
    if bf16:
        arr = arr.view(np.int16)
    if index is not None:
        arr = arr[index]
    with warnings.catch_warnings():  # a read-only mapping: copied right below
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    t = t.to(device, copy=True)
    return t.view(torch.bfloat16) if bf16 else t


@profiling.timed("dualip.tile_cache.load")
def load_butterfly_state(cache_dir, key: str, device, shard: Optional[tuple] = None):
    """``(bcsc, row_layout)`` from the entry ``key``, or ``None`` on a miss (no
    entry, another version, or a plan file gone).  ``bcsc`` has no tiles,
    only specs and sizes, as the butterfly objective keeps it with
    ``keep_col_tiles=False``.  On a CUDA device the plan is packed for the
    kernels, source index included; on the CPU it is the plain plan.

    ``shard=(index, count)``: the slice ``[index]`` of a stacked entry of
    ``count`` shards and shard ``index``'s plan; only that slice is read.

    The lookup is the span ``dualip.tile_cache.load``; a hit counts one in
    ``dualip.tile_cache.loaded`` (``utils/profiling.py``)."""
    from dualip_tpu_torch.ops.butterfly import benes_plan_from_numpy, pack_plan_from_planes
    from dualip_tpu_torch.sparse.rowmajor import PanelTile, RowLayout, RowTile

    device = torch.device(device)
    d = Path(cache_dir) / f"butterfly_{key}"
    meta_path = d / "meta.json"
    if not meta_path.exists():
        return None
    meta = json.loads(meta_path.read_text())
    if meta.get("version") != CACHE_VERSION:
        return None
    n_shards = int(meta.get("n_shards", 1))
    if (shard[1] if shard is not None else 1) != n_shards:
        raise ValueError(f"the entry {key} holds {n_shards} shard(s); loaded as shard={shard!r}")
    index = shard[0] if shard is not None and n_shards > 1 else None
    plan_file = Path(meta["plan_cache_file"][index] if index is not None else meta["plan_cache_file"])
    if not plan_file.exists():
        return None

    with np.load(plan_file) as pd:
        planes = np.asarray(pd["masks_packed"]).view(np.uint8)
        dists = tuple(int(x) for x in pd["dists"])
        n_in, n_out = int(pd["n_in"]), int(pd["n_out"])
    if device.type == "cuda":
        plan = pack_plan_from_planes(planes, dists, n_in, n_out, device=device)
    else:
        masks = np.unpackbits(planes, axis=0, count=len(dists), bitorder="little")
        plan = benes_plan_from_numpy(dists, masks, n_in, n_out, device=device)
    del planes

    specs = [
        TileSpec(entry_key=s["entry_key"], proj_type=s["proj_type"],
                 proj_params=tuple((k, v) for k, v in s["proj_params"]), K=s["K"], L=s["L"])
        for s in meta["specs"]
    ]
    def leaf(name):
        return _load_leaf(d / f"{name}.npy", device, index)

    col_tiles_T = [
        PanelTile(a=leaf(f"panel{i}_a"), c=leaf(f"panel{i}_c"), length=leaf(f"panel{i}_len"))
        for i in range(len(specs))
    ]
    row_shapes = tuple(tuple(s) for s in meta["row_shapes"])
    row_tiles = [
        RowTile(a=None, c=None, row_ids=leaf(f"rowtile{i}_ids"), axidx=None, length=leaf(f"rowtile{i}_len"))
        for i in range(len(row_shapes))
    ]
    col_pack = meta.get("col_pack")
    rl = RowLayout(
        row_tiles=row_tiles,
        zidx=None,
        row_pos=leaf("row_pos"),
        plan=plan,
        col_tiles_T=col_tiles_T,
        use_cuda_kernel=device.type == "cuda",
        col_offsets=tuple(meta["col_offsets"]),
        row_shapes=row_shapes,
        col_pack=tuple(tuple(p) for p in col_pack) if col_pack is not None else None,
        plan_cache_path=str(plan_file),
    )
    value_dtype = torch.bfloat16 if col_tiles_T and col_tiles_T[0].a.dtype == torch.bfloat16 else None
    bcsc = BlockCSC(tiles=[], specs=specs, m=meta["m"], n=meta["n"], nnz=meta["nnz"], value_dtype=value_dtype)
    profiling.count("dualip.tile_cache.loaded")
    return bcsc, rl
