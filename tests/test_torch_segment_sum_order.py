"""The segment-sum's plain version adds in the kernel's order
(``csrc/segment_sum.cu``): held bit for bit to a scalar float32 emulation of
the kernel's lanes, shuffle tree and row pass, in float32 and float64."""

import numpy as np
import pytest
import torch

from dualip_tpu_torch.ops.segment_sum import segment_sum_rows_reference
from dualip_tpu_torch.sparse.bcsc import build_row_sum_plan

torch.set_num_threads(1)


def _emulate(out, vals, plan, dtype):
    """``window_sums`` then ``add_rows`` of the kernel, one scalar at a time."""
    v = vals.astype(dtype)
    partial = np.zeros(plan.seg_row.size, dtype)
    for s in range(plan.seg_row.size):
        lanes = [dtype(0)] * 32
        for t in range(32):
            for j in range(int(plan.seg_ptr[s]) + t, int(plan.seg_ptr[s + 1]), 32):
                lanes[t] = dtype(lanes[t] + v[plan.order[j]])
        for off in (16, 8, 4, 2, 1):  # __shfl_down_sync: a lane past 31 reads its own value
            lanes = [dtype(lanes[t] + lanes[t + off if t + off < 32 else t]) for t in range(32)]
        partial[s] = lanes[0]
    out = out.astype(dtype).copy()
    for r in range(out.size):
        q0, q1 = int(plan.row_ptr[r]), int(plan.row_ptr[r + 1])
        if q0 == q1:
            continue
        acc = dtype(0)
        for q in range(q0, q1):
            acc = dtype(acc + partial[plan.row_segs[q]])
        out[r] = dtype(out[r] + acc)
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["fp32", "fp64"])
@pytest.mark.parametrize("case", ["heavy-rows", "tiny-windows", "empty-rows"])
def test_plain_version_adds_in_the_kernels_order(case, dtype):
    rng = np.random.default_rng(11)
    m, K, L, window = {"heavy-rows": (3, 1500, 4, 16 << 20),  # segments of up to SEG_MAX slots
                       "tiny-windows": (40, 300, 5, 256),
                       "empty-rows": (500, 60, 3, 1 << 20)}[case]
    length = rng.integers(0, L + 1, size=K).astype(np.int32)
    valid = np.arange(L)[None, :] < length[:, None]
    rows = np.where(valid, rng.integers(0, m, size=(K, L)), 0).astype(np.int32)
    # magnitudes over six decades, so that the order of the additions shows in the bits
    vals = np.where(valid, rng.normal(size=(K, L)) * 10.0 ** rng.integers(-3, 3, size=(K, L)), 0).astype(np.float32)
    plan = build_row_sum_plan([rows], [length], m, False, window_bytes=window)
    start = rng.normal(size=m).astype(dtype)
    want = _emulate(start, vals.reshape(-1), plan, dtype)
    tplan = plan._replace(**{f: torch.from_numpy(getattr(plan, f))
                             for f in ("order", "seg_ptr", "seg_row", "item_ptr", "row_ptr", "row_segs")})
    got = segment_sum_rows_reference(torch.from_numpy(start.copy()), torch.from_numpy(vals.reshape(-1)), tplan)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "heavy-rows":
        assert np.diff(plan.seg_ptr).max() > 32 * 8  # many lanes' turns in one segment
    if case == "empty-rows":
        assert (np.diff(plan.row_ptr) == 0).any()
