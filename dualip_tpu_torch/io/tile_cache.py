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

Scope: the single-device ``layout="butterfly"`` objective with
``keep_col_tiles=False`` and ``keep_flat_idx=False``.  The stacked mesh entry
(``n_shards > 1``) belongs to the distributed slice.  Not pickle: arrays are
raw ``.npy`` and the metadata JSON, so a cache entry cannot run code.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import time
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from dualip_tpu_torch.sparse.bcsc import BlockCSC, TileSpec, is_bfloat16

CACHE_VERSION = 1


def _distributed(what: str):
    raise NotImplementedError(f"{what} belongs to the distributed slice of the port, not yet ported")


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


def save_butterfly_state(cache_dir, key: str, bcsc, rl, plan_cache_file, n_shards: int = 1) -> dict:
    """Write the device-ready butterfly state of ``bcsc`` (its specs and sizes)
    and ``rl`` under ``cache_dir/butterfly_<key>``, published by one atomic
    rename (a process that lost the race keeps the winner's entry).  The
    leaves are copied back from ``rl``'s device first, as the JAX package
    does.  Returns the seconds of the copy and of the write,
    ``{"copy_s": ..., "write_s": ...}``."""
    if n_shards > 1:
        _distributed("the stacked mesh tile cache (n_shards > 1)")
    bf16 = bcsc.value_dtype == torch.bfloat16
    t0 = time.perf_counter()
    leaves = {}  # file name -> (host array, written as bfloat16)
    for i, pt in enumerate(rl.col_tiles_T):
        leaves[f"panel{i}_a"] = (_host(pt.a, bf16), bf16)
        leaves[f"panel{i}_c"] = (_host(pt.c, bf16), bf16)
        leaves[f"panel{i}_len"] = (_host(pt.length), False)
    for i, rt in enumerate(rl.row_tiles):
        leaves[f"rowtile{i}_ids"] = (_host(rt.row_ids), False)
        leaves[f"rowtile{i}_len"] = (_host(rt.length), False)
    leaves["row_pos"] = (_host(rl.row_pos), False)
    t1 = time.perf_counter()
    d = Path(cache_dir) / f"butterfly_{key}"
    tmp = d.with_name(d.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    meta = {
        "version": CACHE_VERSION,
        "m": bcsc.m,
        "n": bcsc.n,
        "nnz": bcsc.nnz,
        "n_shards": n_shards,
        "plan_cache_file": str(plan_cache_file),
        "col_offsets": list(rl.col_offsets),
        "row_shapes": [list(s) for s in rl.row_shapes],
        "col_pack": [list(p) for p in rl.col_pack] if rl.col_pack is not None else None,
        "specs": [
            {"entry_key": s.entry_key, "proj_type": s.proj_type,
             "proj_params": [[k, v] for k, v in s.proj_params], "K": s.K, "L": s.L}
            for s in bcsc.specs
        ],
    }
    for name, (arr, as_bf16) in leaves.items():
        _save(tmp / f"{name}.npy", arr, as_bf16)
    (tmp / "meta.json").write_text(json.dumps(meta))
    if d.exists():
        shutil.rmtree(tmp)
    else:
        try:
            tmp.replace(d)
        except OSError:  # another process published between the check and the rename
            shutil.rmtree(tmp, ignore_errors=True)
    return {"copy_s": t1 - t0, "write_s": time.perf_counter() - t1}


def _load_leaf(path: Path, device: torch.device) -> torch.Tensor:
    """One ``.npy`` leaf, read memory-mapped and copied to ``device`` once
    (no tensor stays aliased to the file); ``<V2`` leaves are bfloat16."""
    arr = np.load(path, mmap_mode="r")
    bf16 = arr.dtype.kind == "V" or arr.dtype.name == "bfloat16"
    if bf16:
        arr = arr.view(np.int16)
    with warnings.catch_warnings():  # a read-only mapping: copied right below
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    t = t.to(device, copy=True)
    return t.view(torch.bfloat16) if bf16 else t


def load_butterfly_state(cache_dir, key: str, device):
    """``(bcsc, row_layout)`` from the entry ``key``, or ``None`` on a miss (no
    entry, another version, or its plan file gone).  ``bcsc`` has no tiles,
    only specs and sizes, as the butterfly objective keeps it with
    ``keep_col_tiles=False``.  On a CUDA device the plan is packed for the
    kernels, source index included; on the CPU it is the plain plan."""
    from dualip_tpu_torch.ops.butterfly import benes_plan_from_numpy, pack_plan_from_planes
    from dualip_tpu_torch.sparse.rowmajor import PanelTile, RowLayout, RowTile

    t0 = time.perf_counter()
    device = torch.device(device)
    d = Path(cache_dir) / f"butterfly_{key}"
    meta_path = d / "meta.json"
    if not meta_path.exists():
        return None
    meta = json.loads(meta_path.read_text())
    if meta.get("version") != CACHE_VERSION:
        return None
    if int(meta.get("n_shards", 1)) > 1 or isinstance(meta["plan_cache_file"], list):
        _distributed("the stacked mesh tile cache (n_shards > 1)")
    plan_file = Path(meta["plan_cache_file"])
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
    col_tiles_T = [
        PanelTile(a=_load_leaf(d / f"panel{i}_a.npy", device), c=_load_leaf(d / f"panel{i}_c.npy", device),
                  length=_load_leaf(d / f"panel{i}_len.npy", device))
        for i in range(len(specs))
    ]
    row_shapes = tuple(tuple(s) for s in meta["row_shapes"])
    row_tiles = [
        RowTile(a=None, c=None, row_ids=_load_leaf(d / f"rowtile{i}_ids.npy", device), axidx=None,
                length=_load_leaf(d / f"rowtile{i}_len.npy", device))
        for i in range(len(row_shapes))
    ]
    col_pack = meta.get("col_pack")
    rl = RowLayout(
        row_tiles=row_tiles,
        zidx=None,
        row_pos=_load_leaf(d / "row_pos.npy", device),
        plan=plan,
        col_tiles_T=col_tiles_T,
        use_cuda_kernel=device.type == "cuda",
        col_offsets=tuple(meta["col_offsets"]),
        row_shapes=row_shapes,
        col_pack=tuple(tuple(p) for p in col_pack) if col_pack is not None else None,
        plan_cache_path=str(plan_file),
        build_seconds={"route": 0.0, "total": time.perf_counter() - t0},
    )
    value_dtype = torch.bfloat16 if col_tiles_T and col_tiles_T[0].a.dtype == torch.bfloat16 else None
    bcsc = BlockCSC(tiles=[], specs=specs, m=meta["m"], n=meta["n"], nnz=meta["nnz"], value_dtype=value_dtype)
    return bcsc, rl
