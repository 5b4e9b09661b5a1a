"""ctypes binding of the native Benes routers (``native/dualip_native.cc``).

The port's own counterpart of ``dualip_tpu/io/native_loader.py``, with the two
router entry points only: ``benes_route_native`` and
``benes_route_packed_native``.  The shared library is built with the system
``g++`` at first use into the port's build directory (``build/dualip_tpu_torch``
at the repository root; its file name carries a hash of the source).  When the
library cannot be built or loaded both functions return ``None`` and the numpy
router of ``ops/butterfly.py`` runs instead; that one is O(N log^2 N) and only
practical for small N.  ``DUALIP_DISABLE_NATIVE=1`` turns the native path off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

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
            for fn in (lib.dualip_benes_route, lib.dualip_benes_route_packed):
                fn.restype = None
                fn.argtypes = [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
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
