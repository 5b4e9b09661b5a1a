"""Row segment-sum of a tile's ``a*x`` in a fixed order.

    out[r] += sum of vals[slot] over the tile's valid slots whose row is r

The JAX package leaves this to XLA's ``segment_sum`` (outside any Pallas
kernel), which repeats itself.  On CUDA the library route, ``index_add_``, adds
with float atomics in an order that changes from run to run, so a solve did
not repeat itself, and torch's deterministic ``index_add_`` is far too slow for
the hot path.  ``segment_sum_rows`` therefore launches the hand-written kernel
of ``csrc/segment_sum.cu`` on CUDA tensors (one warp per row, a fixed order,
no atomics) with the tile's static ``RowOrder`` (``sparse/bcsc.py``), and runs
the plain version, ``index_add_``, on CPU tensors, where it adds in a fixed
order.  This kernel has no TPU counterpart.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dualip_tpu_torch.ops import _build


def segment_sum_rows_reference(out: torch.Tensor, vals: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The plain version: ``out.index_add_(0, rows, vals)`` over every slot
    (padding slots hold zeros)."""
    return out.index_add_(0, rows.reshape(-1), vals.reshape(-1))


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("segment_sum").dualip_segment_sum
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def segment_sum_rows(out: torch.Tensor, vals: torch.Tensor, rows: torch.Tensor, row_order=None) -> torch.Tensor:
    """Add the row sums of ``vals`` onto ``out`` (m,), in place, and return it.

    ``rows`` gives each slot's row (same shape as ``vals``); ``row_order`` is
    the tile's ``RowOrder(order, ptr)``.  On CUDA tensors the kernel runs (it
    needs ``row_order``, float32 values and a float32 ``out``) or the call
    raises; on CPU tensors the plain version runs.  Counts launches in
    ``segment_sum_rows.launches``."""
    dev = out.device
    if vals.device != dev:
        raise ValueError(f"vals on {vals.device}, out on {dev}")
    if dev.type == "cpu":
        return segment_sum_rows_reference(out, vals, rows)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum_rows runs on cuda or cpu tensors, got {dev}")
    if row_order is None:
        raise ValueError("segment_sum_rows on CUDA needs the tile's RowOrder (device_put_blockcsc(row_orders=True))")
    order, ptr = row_order
    if out.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError("the segment-sum kernel takes float32 values and a float32 out")
    if order.dtype != torch.int32 or ptr.dtype != torch.int64:
        raise TypeError("RowOrder must hold an int32 order and an int64 ptr")
    if tuple(ptr.shape) != (out.shape[0] + 1,):
        raise ValueError(f"ptr must be ({out.shape[0] + 1},), got {tuple(ptr.shape)}")
    if order.device != dev or ptr.device != dev:
        raise ValueError("RowOrder must be on the tensors' device")
    if not all(t.is_contiguous() for t in (out, vals, order, ptr)):
        raise ValueError("the segment-sum kernel takes contiguous tensors")
    with torch.cuda.device(dev):
        rc = _kernel()(
            vals.data_ptr(), order.data_ptr(), ptr.data_ptr(), out.data_ptr(), out.shape[0],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"segment_sum_rows: CUDA error {rc} at launch (m={out.shape[0]}, slots={order.numel()})")
    segment_sum_rows.launches += 1
    return out


segment_sum_rows.launches = 0
