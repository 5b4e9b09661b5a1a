"""Synthetic matching-LP generator (``benchmark/generate_synthetic_data.py``).

Lognormal destination breadth/scale/value and source affinity, Poisson
per-destination degree, ``c = min(v_j u_i eps, 0.5)``, ``a = s_j c``, and
budgets ``b = U(0.5, 1) x`` the greedy per-source best-edge load.

``DUALIP_GEN_BACKEND`` picks the generator: ``numpy`` (the default; the same
seed gives the benchmark generator's numpy arrays), ``native`` (the C++
generator of ``native/dualip_native.cc``, multithreaded, another random
stream; numpy runs when the library is unavailable) or ``native-stream``
(the C++ generator writing the memmap tier directly, O(sources) memory).

With a ``seed`` (and no ``rng``) and a cache directory (``cache_dir``, else
``DUALIP_BENCH_CACHE``; without either nothing touches the disk) the arrays
are cached there, keyed by the arguments and the backend: a ``.npz`` file, or above
``DUALIP_GEN_MEMMAP_THRESHOLD`` bytes (4 GiB; ``DUALIP_GEN_MEMMAP=1``/``0``
forces it) a ``.mm/`` directory of ``.npy`` files loaded memory-mapped, so the
edge arrays stay on disk until the tile fill reads them.  Path and layout
are the benchmark generator's: an entry written by either package loads in
the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from dualip_tpu_torch.objectives.matching import MatchingInputArgs
from dualip_tpu_torch.projections import create_projection_map
from dualip_tpu_torch.sparse import csc_from_arrays


def _generate_matching_numpy(
    num_sources: int,
    num_destinations: int,
    target_sparsity: float,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Return (ccol_indices, row_indices, a_values, c_values, b_vec)."""
    if rng is None:
        rng = np.random.default_rng()

    n_src, n_dst = num_sources, num_destinations

    mu_p, sigma_p = 0.0, 1.0
    mu_s, sigma_s = 0.0, 1.0
    mu_v, sigma_v = -4.0, 0.75
    mu_u, sigma_u = 0.0, 0.5
    sigma_eps = 0.5
    c_max = 0.5

    avg_degree_per_source = target_sparsity * n_dst

    Z = rng.lognormal(mean=mu_p, sigma=sigma_p, size=n_dst)
    z_sum = Z.sum()
    if z_sum == 0:
        Z[:] = 1.0
        z_sum = float(n_dst)
    p = Z / z_sum * avg_degree_per_source

    s = rng.lognormal(mean=mu_s, sigma=sigma_s, size=n_dst)
    v = rng.lognormal(mean=mu_v, sigma=sigma_v, size=n_dst)
    u = rng.lognormal(mean=mu_u, sigma=sigma_u, size=n_src)

    K = np.minimum(rng.poisson(p * n_src), n_src)
    total = int(K.sum())
    if total == 0:
        raise ValueError("No edges generated; increase target_sparsity.")

    dest_ids = np.repeat(np.arange(n_dst, dtype=np.int64), K)
    source_ids = rng.integers(0, n_src, size=total, dtype=np.int64)

    # dedupe (dest, source) pairs
    key = np.unique(dest_ids * np.int64(n_src) + source_ids)
    dest_ids = (key // n_src).astype(np.int64)
    source_ids = (key % n_src).astype(np.int64)
    total = key.shape[0]
    del key

    eps_ij = rng.lognormal(mean=0.0, sigma=sigma_eps, size=total)
    c_values = np.minimum(v[dest_ids] * u[source_ids] * eps_ij, c_max)
    a_values = s[dest_ids] * c_values
    del eps_ij

    # CSC layout: sort by source (column), stable so rows stay sorted per column
    order = np.lexsort((dest_ids, source_ids))
    source_sorted = source_ids[order]
    row_indices = dest_ids[order]
    a_sorted = a_values[order]
    c_sorted = c_values[order]
    del order, dest_ids, source_ids, a_values, c_values

    counts = np.bincount(source_sorted, minlength=n_src)
    ccol_indices = np.zeros(n_src + 1, dtype=np.int64)
    np.cumsum(counts, out=ccol_indices[1:])

    # greedy per-source best-edge load (segmented argmax over columns)
    greedy_loads = np.zeros(n_dst, dtype=np.float64)
    nonempty = counts > 0
    if nonempty.any():
        seg_max = np.maximum.reduceat(a_sorted, ccol_indices[:-1][nonempty])
        col_of = np.repeat(np.arange(n_src), counts)
        is_max = a_sorted == seg_max[np.searchsorted(np.flatnonzero(nonempty), col_of)]
        cand = np.flatnonzero(is_max)
        _, first_idx = np.unique(col_of[cand], return_index=True)
        best_pos = cand[first_idx]
        np.add.at(greedy_loads, row_indices[best_pos], a_sorted[best_pos])

    rho = rng.uniform(0.5, 1.0, size=n_dst)
    b_vec = rho * (greedy_loads + 1e-8)

    return ccol_indices, row_indices, a_sorted, c_sorted, b_vec


_KEYS = ("ccol", "rows", "a", "c", "b")


def _cache_path(cache_dir, num_sources, num_destinations, target_sparsity, dtype, seed) -> Path:
    """The benchmark generator's cache file for these arguments (``seed`` is
    ``(seed, backend)`` there; JSON writes the tuple as a list)."""
    meta = json.dumps(
        {"s": num_sources, "d": num_destinations, "sp": target_sparsity, "dt": str(np.dtype(dtype)),
         "seed": seed, "v": 1},
        sort_keys=True,
    )
    h = hashlib.sha1(meta.encode()).hexdigest()[:16]
    return Path(cache_dir) / f"matching_{num_sources}x{num_destinations}_{h}.npz"


def _load_cached(path: Path, mm_dir: Path):
    """The cached arrays, memmapped from the ``.mm/`` tier or read from the
    ``.npz``; ``None`` on a miss or an entry another process is still writing."""
    if mm_dir.is_dir() and (mm_dir / "b.npy").exists():
        return tuple(np.load(mm_dir / f"{k}.npy", mmap_mode="r") for k in _KEYS)
    if path.exists():
        try:
            with np.load(path) as data:
                return tuple(data[k] for k in _KEYS)
        except (OSError, ValueError, EOFError, KeyError, zipfile.BadZipFile):
            return None
    return None


def _save_cached(arrays, path: Path, mm_dir: Path, use_memmap: bool, dtype):
    """Write the entry (each file published by an atomic rename, ``b.npy``
    of the memmap tier last: its presence marks the entry complete) and return
    the arrays the caller goes on with: memmapped from the files just written
    on the memmap tier, so the in-memory copies can go."""
    tmp_tag = f".{os.getpid()}.tmp"
    if use_memmap:
        mm_dir.mkdir(parents=True, exist_ok=True)
        for k, arr in zip(_KEYS, arrays):
            # values in the requested dtype (the key holds it): warm loads stay mapped
            if k in ("a", "c", "b"):
                arr = np.asarray(arr, dtype=dtype)
            tmp = mm_dir / f"{k}{tmp_tag}.npy"
            np.save(tmp, arr)
            os.replace(tmp, mm_dir / f"{k}.npy")
        return tuple(np.load(mm_dir / f"{k}.npy", mmap_mode="r") for k in _KEYS)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + tmp_tag + ".npz")
    np.savez(tmp, **dict(zip(_KEYS, arrays)))
    os.replace(tmp, path)
    return arrays


def generate_synthetic_matching_input_args(
    num_sources: int,
    num_destinations: int,
    target_sparsity: float,
    dtype=np.float32,
    seed: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
    cache_dir=None,
) -> MatchingInputArgs:
    """MatchingInputArgs with ``c`` negated for minimization and one simplex
    ``z = 1`` projection entry over all sources (columns).  A ``seed``
    without ``rng`` reads and writes the disk cache when a cache directory
    is named (module docstring)."""
    cache_dir = cache_dir or os.environ.get("DUALIP_BENCH_CACHE")
    use_cache = seed is not None and rng is None and cache_dir is not None
    backend = os.environ.get("DUALIP_GEN_BACKEND", "numpy")
    if backend not in ("numpy", "native", "native-stream"):
        raise ValueError(f"DUALIP_GEN_BACKEND={backend!r} (expected numpy, native or native-stream)")
    if backend == "native-stream" and not use_cache:
        raise ValueError("DUALIP_GEN_BACKEND=native-stream writes the memmap cache tier: "
                         "give a seed and a cache_dir (or DUALIP_BENCH_CACHE)")
    est_bytes = int(num_sources * num_destinations * target_sparsity) * 24
    mm_env = os.environ.get("DUALIP_GEN_MEMMAP")
    use_memmap = mm_env == "1" or (
        mm_env != "0" and est_bytes > int(os.environ.get("DUALIP_GEN_MEMMAP_THRESHOLD", 4 << 30)))

    arrays = None
    if use_cache:
        path = _cache_path(cache_dir, num_sources, num_destinations, target_sparsity, dtype, (seed, backend))
        mm_dir = path.with_suffix(".mm")
        arrays = _load_cached(path, mm_dir)
        if arrays is None and backend == "native-stream":
            # writes the memmap tier itself; the key's backend tag keeps its stream apart
            from dualip_tpu_torch.io.native_loader import generate_matching_stream_native

            arrays = generate_matching_stream_native(
                num_sources, num_destinations, target_sparsity, seed=seed, mm_dir=mm_dir, dtype=dtype)

    if arrays is None:
        if backend == "native" and rng is None:
            from dualip_tpu_torch.io.native_loader import generate_matching_native

            arrays = generate_matching_native(num_sources, num_destinations, target_sparsity, seed=seed or 0)
        if arrays is None:
            if rng is None:
                rng = np.random.default_rng(seed)
            arrays = _generate_matching_numpy(num_sources, num_destinations, target_sparsity, rng)
        if use_cache:
            arrays = _save_cached(arrays, path, mm_dir, use_memmap, dtype)

    ccol, rows, a, c, b = arrays
    shape = (num_destinations, num_sources)
    # memmapped arrays stay on disk: no astype copy when the dtype already matches
    A = csc_from_arrays(ccol, rows, a if a.dtype == np.dtype(dtype) else a.astype(dtype), shape)
    C = csc_from_arrays(ccol, rows, (-c).astype(dtype), shape)
    projection_map = create_projection_map("simplex", {"z": 1.0}, num_sources)
    return MatchingInputArgs(
        A=A, c=C, projection_map=projection_map, b_vec=b.astype(dtype), equality_mask=None
    )
