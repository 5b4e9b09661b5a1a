"""Device marks: the one-thread kernel of ``csrc/marks.cu`` that stores the
card's global nanosecond timer into a table of four points a row, at the row
a device slot counter names (the point that ends an iteration advances it).
``utils/profiling.py::IterationMarks`` places four of them in every AGD
iteration; a CUDA graph captures each as one kernel node.  The kernel has no
TPU counterpart and no plain version: on the CPU there are no marks."""

from __future__ import annotations

import ctypes
import functools

import torch

from dualip_tpu_torch.ops import _build
from dualip_tpu_torch.utils import profiling


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("marks").dualip_stamp
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stamp(table: torch.Tensor, slot: torch.Tensor, point: int, advance: bool) -> None:
    """Store the card's timer at ``table[slot % rows, point]`` of the
    ``(rows, 4)`` int64 ``table``; ``advance`` adds one to the int64 ``slot``
    after.  Counts one in ``dualip.ops.stamp.enqueued``."""
    if table.device.type != "cuda" or slot.device != table.device:
        raise ValueError(f"stamp runs on one CUDA device (table on {table.device}, slot on {slot.device})")
    if table.dtype != torch.int64 or slot.dtype != torch.int64 or table.dim() != 2 or table.shape[1] != 4:
        raise TypeError("stamp takes a (rows, 4) int64 table and an int64 slot")
    with torch.cuda.device(table.device):
        rc = _kernel()(table.data_ptr(), slot.data_ptr(), int(point), table.shape[0], int(advance),
                       torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stamp: CUDA error {rc} at launch (point={point}, rows={table.shape[0]})")
    profiling.count("dualip.ops.stamp.enqueued")
