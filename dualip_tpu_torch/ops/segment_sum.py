"""Row segment-sum of the tiles' ``a*x`` in a fixed order.

    out[r] += sum of vals[slot] over the valid slots whose row is r

The JAX package leaves this to XLA's ``segment_sum`` (outside any Pallas
kernel), which repeats itself.  On CUDA the library route, ``index_add_``, adds
with float atomics in an order that changes from run to run, so a solve did
not repeat itself, and torch's deterministic ``index_add_`` is far too slow for
the hot path.  ``segment_sum_rows`` therefore launches the hand-written kernel
of ``csrc/segment_sum.cu`` on CUDA tensors (every tile in one call, over
L2-sized column windows, a fixed order, no atomics) with the tiles' static
``RowSumPlan`` (``sparse/bcsc.py``), and runs the plain version on CPU tensors.
This kernel has no TPU counterpart.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dualip_tpu_torch.ops import _build
from dualip_tpu_torch.sparse.bcsc import RowSumPlan

_PLAN_INDEX = ("order", "seg_ptr", "item_ptr", "row_ptr", "row_segs")


def segment_sum_rows_reference(out: torch.Tensor, vals: torch.Tensor, plan: RowSumPlan) -> torch.Tensor:
    """The plain version, in the kernel's two steps and its order of additions,
    in ``out``'s dtype; on any device it repeats itself, and in float32 it
    gives the kernel's bits.  Each segment: lane t of 32 adds entries t,
    t + 32, ... in turn (a lane past the segment's end adds +0, which changes
    nothing), then the 32 sums meet in the kernel's shuffle tree.  Each row:
    its segments' sums added from zero in window order, the result added
    onto ``out``."""
    v = vals.reshape(-1).index_select(0, plan.order.long()).to(out.dtype)
    n_seg = plan.seg_row.numel()
    if n_seg == 0:
        return out
    seg_ptr = plan.seg_ptr.long()
    start, end = seg_ptr[:-1, None], seg_ptr[1:, None]
    j = start + torch.arange(32, device=v.device)
    acc = torch.zeros(n_seg, 32, dtype=out.dtype, device=out.device)
    for _ in range(-(-int((end - start).max()) // 32)):
        acc += torch.where(j < end, v[j.clamp(max=v.numel() - 1)], 0)
        j += 32
    for w in (16, 8, 4, 2, 1):
        acc = acc[:, :w] + acc[:, w:2 * w]
    partial = acc[:, 0]
    row_ptr = plan.row_ptr.long()
    first, count = row_ptr[:-1], torch.diff(row_ptr)
    seg = partial[plan.row_segs.long()]
    rsum = torch.zeros_like(out)
    for k in range(int(count.max())):
        rsum = torch.where(count > k, rsum + seg[(first + k).clamp(max=n_seg - 1)], rsum)
    return out.copy_(torch.where(count > 0, out + rsum, out))


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("segment_sum").dualip_segment_sum
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def segment_sum_rows(out: torch.Tensor, vals: torch.Tensor, plan: RowSumPlan) -> torch.Tensor:
    """Add the row sums of ``vals`` onto ``out`` (m,), in place, and return it.

    ``vals`` holds every tile's values end to end (``plan.slots`` of them,
    tile i from ``plan.offsets[i]``; padding slots are never read).  On CUDA
    tensors the kernel runs (float32 values and ``out``, the plan's int32
    index arrays on the same card) or the call raises; on CPU tensors the plain
    version runs.  One call launches the kernel's two passes and counts one in
    ``segment_sum_rows.launches``."""
    dev = out.device
    if vals.device != dev:
        raise ValueError(f"vals on {vals.device}, out on {dev}")
    if vals.numel() != plan.slots:
        raise ValueError(f"vals holds {vals.numel()} slots, the plan {plan.slots}")
    if tuple(plan.row_ptr.shape) != (out.shape[0] + 1,):
        raise ValueError(f"the plan is for {plan.row_ptr.shape[0] - 1} rows, out has {out.shape[0]}")
    if dev.type == "cpu":
        return segment_sum_rows_reference(out, vals, plan)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum_rows runs on cuda or cpu tensors, got {dev}")
    if out.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError("the segment-sum kernel takes float32 values and a float32 out")
    index = [getattr(plan, f) for f in _PLAN_INDEX]
    if any(t.device != dev or t.dtype != torch.int32 or not t.is_contiguous() for t in index):
        raise ValueError("the plan's index arrays must be contiguous int32 tensors on the tensors' device")
    if not (out.is_contiguous() and vals.is_contiguous()):
        raise ValueError("the segment-sum kernel takes contiguous tensors")
    n_items = plan.item_ptr.numel() - 1
    if n_items == 0:  # no valid slot: nothing to add
        return out
    partial = torch.empty(plan.seg_row.numel(), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _kernel()(
            vals.data_ptr(), *(t.data_ptr() for t in index), partial.data_ptr(), out.data_ptr(),
            n_items, out.shape[0], torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"segment_sum_rows: CUDA error {rc} at launch (m={out.shape[0]}, slots={plan.order.numel()})")
    segment_sum_rows.launches += 1
    return out


segment_sum_rows.launches = 0
