"""ctypes binding of the native C++ data plane (``native/dualip_native.cc``).

The port's own counterpart of ``dualip_tpu/io/native_loader.py``: the
synthetic generator, buffered (``generate_matching_native``) and streaming
into memmapped ``.npy`` files (``generate_matching_stream_native``), the
parallel tile fill (``fill_tile_native``) and the Benes routers
(``benes_route_native``, ``benes_route_packed_native``).  Each returns what
the JAX package's binding returns at equal arguments, bit for bit.

The shared library is built with the system ``g++`` at first use into the
port's build directory (``build/dualip_tpu_torch`` at the repository root; its
file name carries a hash of the source).  When the library cannot be built or
loaded every function returns ``None`` and its caller runs the numpy path
instead (the numpy router of ``ops/butterfly.py`` is O(N log^2 N), practical
for small N only).  ``DUALIP_DISABLE_NATIVE=1`` turns the native path off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
from numpy.lib.format import open_memmap

from dualip_tpu_torch.ops._build import BUILD_DIR

_SRC = Path(__file__).resolve().parents[2] / "native" / "dualip_native.cc"
_ABI_VERSION = 5

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _so_path() -> Path:
    digest = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libdualip_native-{digest}.so"


def _compile(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
           str(_SRC), "-o", str(tmp)]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:  # no compiler
        print(f"dualip native build unavailable: {e}")
        return False
    if done.returncode != 0:
        print(f"dualip native build failed:\n{done.stderr[-1000:]}")
        return False
    os.replace(tmp, out)
    return True


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes and restype of every entry point the port calls."""
    i64, vp, cint = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
    table = {
        "dualip_gen_create": (vp, [i64, i64, ctypes.c_double, ctypes.c_uint64, cint]),
        "dualip_gen_nnz": (i64, [vp]),
        "dualip_gen_export": (None, [vp] * 6),
        "dualip_gen_free": (None, [vp]),
        "dualip_gen_stream_create": (vp, [i64, i64, ctypes.c_double, ctypes.c_uint64, cint]),
        "dualip_gen_stream_count": (i64, [vp, vp]),
        "dualip_gen_stream_fill": (None, [vp] * 6 + [i64]),
        "dualip_gen_stream_free": (None, [vp]),
        "dualip_fill_tile": (None, [vp] * 5 + [i64, i64] + [vp] * 6 + [cint]),
        "dualip_benes_route": (None, [i64, vp, vp, cint, cint]),
        "dualip_benes_route_packed": (None, [i64, vp, vp, cint, cint]),
    }
    for name, (restype, argtypes) in table.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def load_native() -> Optional[ctypes.CDLL]:
    """The native library (built if needed), or ``None`` if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("DUALIP_DISABLE_NATIVE") == "1" or not _SRC.exists():
            return None
        so = _so_path()
        if not so.exists() and not _compile(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
            _declare(lib)
            if lib.dualip_native_abi_version() != _ABI_VERSION:
                return None
        except (OSError, AttributeError) as e:
            print(f"dualip native library rejected: {e}")
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_native() is not None


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def generate_matching_native(
    num_sources: int, num_destinations: int, target_sparsity: float, seed: int, threads: int = 0,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """``(indptr, rows, a, c, b)`` from the native generator (int64, int32 and
    float64 arrays), or ``None``.  The numpy generator's model with another
    deterministic random stream: values differ from it at equal seeds."""
    lib = load_native()
    if lib is None:
        return None
    h = lib.dualip_gen_create(num_sources, num_destinations, target_sparsity, seed, threads)
    try:
        nnz = lib.dualip_gen_nnz(h)
        indptr = np.empty(num_sources + 1, dtype=np.int64)
        rows = np.empty(nnz, dtype=np.int32)
        a = np.empty(nnz, dtype=np.float64)
        c = np.empty(nnz, dtype=np.float64)
        b = np.empty(num_destinations, dtype=np.float64)
        lib.dualip_gen_export(h, _ptr(indptr), _ptr(rows), _ptr(a), _ptr(c), _ptr(b))
    finally:
        lib.dualip_gen_free(h)
    return indptr, rows, a, c, b


def generate_matching_stream_native(
    num_sources: int,
    num_destinations: int,
    target_sparsity: float,
    seed: int,
    mm_dir,
    dtype=np.float32,
    threads: int = 0,
    batch_edges: int = 1 << 25,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Generate straight into the memmap cache directory ``mm_dir``
    (``ccol.npy``, ``rows.npy``, ``a.npy``, ``c.npy``, ``b.npy``) with
    O(num_sources) resident memory at any nnz: one pass counts each column,
    a second fills rows, a and c in ascending column order.  Values land in
    float32 (the only ``dtype`` it takes).  Another random stream than both
    other generators; deterministic per seed at any thread count.  Returns the
    arrays memmapped read-only, or ``None``."""
    lib = load_native()
    if lib is None or np.dtype(dtype) != np.float32:
        return None
    mm_dir = Path(mm_dir)
    mm_dir.mkdir(parents=True, exist_ok=True)
    h = lib.dualip_gen_stream_create(num_sources, num_destinations, target_sparsity, seed, threads)
    try:
        ccol = open_memmap(mm_dir / "ccol.npy", mode="w+", dtype=np.int64, shape=(num_sources + 1,))
        nnz = lib.dualip_gen_stream_count(h, _ptr(ccol))
        np.cumsum(ccol, out=ccol)
        rows = open_memmap(mm_dir / "rows.npy", mode="w+", dtype=np.int32, shape=(nnz,))
        a = open_memmap(mm_dir / "a.npy", mode="w+", dtype=np.float32, shape=(nnz,))
        c = open_memmap(mm_dir / "c.npy", mode="w+", dtype=np.float32, shape=(nnz,))
        b64 = np.empty(num_destinations, dtype=np.float64)
        lib.dualip_gen_stream_fill(h, _ptr(ccol), _ptr(rows), _ptr(a), _ptr(c), _ptr(b64), batch_edges)
        for arr in (ccol, rows, a, c):
            arr.flush()
        del ccol, rows, a, c
        np.save(mm_dir / "b.npy", b64.astype(dtype))
    finally:
        lib.dualip_gen_stream_free(h)
    return tuple(np.load(mm_dir / f"{k}.npy", mmap_mode="r") for k in ("ccol", "rows", "a", "c", "b"))


def fill_tile_native(
    indptr: np.ndarray,
    row_indices: np.ndarray,
    a_data: np.ndarray,
    c_data: np.ndarray,
    cols: np.ndarray,
    K: int,
    L: int,
    keep_flat_idx: bool,
    threads: int = 0,
):
    """Fill one ``(K, L)`` tile from the CSC arrays, columns ``cols`` in
    order, in parallel: ``(rows, a, c, length, col_ids, flat_idx)`` as int32,
    float32, float32, int32, int32 and int64 (``None`` without
    ``keep_flat_idx``), the numpy fill's arrays element for element; or
    ``None``."""
    lib = load_native()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    row_indices = np.ascontiguousarray(row_indices, dtype=np.int32)
    a_data = np.ascontiguousarray(a_data, dtype=np.float32)
    c_data = np.ascontiguousarray(c_data, dtype=np.float32)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    if cols.size > K or (cols.size and (cols.min() < 0 or cols.max() >= indptr.size - 1)):
        raise ValueError(f"fill_tile_native: {cols.size} columns for K={K}, or a column outside the matrix")
    if cols.size and int((indptr[cols + 1] - indptr[cols]).max()) > L:
        raise ValueError(f"fill_tile_native: a column holds more than L={L} nonzeros")

    rows_out = np.zeros((K, L), dtype=np.int32)
    a_out = np.zeros((K, L), dtype=np.float32)
    c_out = np.zeros((K, L), dtype=np.float32)
    length = np.zeros(K, dtype=np.int32)
    col_ids = np.full(K, -1, dtype=np.int32)
    flat_idx = np.full((K, L), -1, dtype=np.int64) if keep_flat_idx else None
    lib.dualip_fill_tile(
        _ptr(indptr), _ptr(row_indices), _ptr(a_data), _ptr(c_data), _ptr(cols), len(cols), L,
        _ptr(rows_out), _ptr(a_out), _ptr(c_out), _ptr(length), _ptr(col_ids),
        _ptr(flat_idx) if flat_idx is not None else None, threads,
    )
    return rows_out, a_out, c_out, length, col_ids, flat_idx


def benes_route_native(src: np.ndarray, threads: int = 0, block_log2: int = 0) -> Optional[np.ndarray]:
    """(2n-1, N) int8 Benes stage masks for the completed bijection ``src`` on
    N = 2^n slots (``src[i]`` = input slot feeding output slot i), or ``None``.
    Bit for bit the masks of the numpy router."""
    lib = load_native()
    if lib is None:
        return None
    N = int(src.size)
    n = N.bit_length() - 1
    src = np.ascontiguousarray(src, dtype=np.int32)
    masks = np.empty((2 * n - 1, N), dtype=np.int8)
    lib.dualip_benes_route(N, _ptr(src), _ptr(masks), threads, block_log2)
    return masks


def benes_route_packed_native(src: np.ndarray, threads: int = 0, block_log2: int = 0) -> Optional[np.ndarray]:
    """(ceil((2n-1)/8), N) uint8 stage bit-planes for ``src``: the packed form
    of ``benes_route_native`` without the unpacked masks in between."""
    lib = load_native()
    if lib is None:
        return None
    N = int(src.size)
    n = N.bit_length() - 1
    src = np.ascontiguousarray(src, dtype=np.int32)
    planes = np.zeros(((2 * n - 1 + 7) // 8, N), dtype=np.uint8)
    lib.dualip_benes_route_packed(N, _ptr(src), _ptr(planes), threads, block_log2)
    return planes
