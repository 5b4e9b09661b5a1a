"""The fixed-order row segment-sum: its windowed plan (each valid slot once;
within a window the stable argsort by row; the window cap kept), its plain
version against ``jax.ops.segment_sum`` (fp32, atol 1e-5 of the largest row
sum), and the csc objective's use of it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dualip_tpu_torch.objectives.matching import MatchingInputArgs, MatchingSolverDualObjectiveFunction
from dualip_tpu_torch.ops.segment_sum import segment_sum_rows, segment_sum_rows_reference
from dualip_tpu_torch.projections import create_projection_map
from dualip_tpu_torch.sparse import csc_from_dense
from dualip_tpu_torch.sparse.bcsc import SEG_MAX, build_row_sum_plan
from dualip_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _tile(seed, m, K, L):
    rng = np.random.default_rng(seed)
    length = rng.integers(0, L + 1, size=K).astype(np.int32)
    rows = rng.integers(0, m, size=(K, L)).astype(np.int32)
    valid = np.arange(L)[None, :] < length[:, None]
    rows = np.where(valid, rows, 0).astype(np.int32)  # padding slots hold row 0, as the tiles do
    vals = np.where(valid, rng.normal(size=(K, L)), 0).astype(np.float32)
    return rows, length, valid, vals


def _tiles(m, transposed, shapes=((257, 6), (40, 1), (123, 3))):
    """Three tiles, (K, L) or (L, K), with their values laid end to end."""
    rows, lengths, valids, vals = [], [], [], []
    for i, (K, L) in enumerate(shapes):
        r, n, v, x = _tile(m + i, m, K, L)
        if transposed:
            r, v, x = (np.ascontiguousarray(t.T) for t in (r, v, x))
        rows.append(r), lengths.append(n), valids.append(v), vals.append(x)
    flat = lambda ts: np.concatenate([t.reshape(-1) for t in ts])  # noqa: E731
    return rows, lengths, flat(valids), flat(vals), flat(rows)


def _torch_plan(plan):
    return plan._replace(**{f: torch.from_numpy(getattr(plan, f))
                            for f in ("order", "seg_ptr", "seg_row", "item_ptr", "row_ptr", "row_segs")})


@pytest.mark.parametrize("window_bytes", [16 << 20, 64], ids=["default-window", "tiny-window"])
@pytest.mark.parametrize("transposed", [False, True], ids=["KL", "LK"])
@pytest.mark.parametrize("m", [7, 300, 70_000], ids=["m7", "m300", "m70000-int32-keys"])
def test_row_order_is_the_stable_argsort_of_the_valid_slots(m, transposed, window_bytes):
    rows, lengths, valid, _, row_of = _tiles(m, transposed)
    plan = build_row_sum_plan(rows, lengths, m, transposed, window_bytes=window_bytes)
    assert plan.slots == valid.size and plan.order.dtype == np.int32
    # every valid slot exactly once
    np.testing.assert_array_equal(np.sort(plan.order), np.flatnonzero(valid))
    # windows: the tiles' columns in order, each within the cap unless one column is wider
    shapes = [(r.shape[0], r.shape[1]) if transposed else (r.shape[1], r.shape[0]) for r in rows]
    pieces = [p for w in plan.windows for p in w]
    assert [(i, k0) for i, k0, _ in pieces] == sorted((i, k0) for i, k0, _ in pieces)
    for i, (L, K) in enumerate(shapes):
        mine = [(k0, k1) for j, k0, k1 in pieces if j == i]
        assert mine[0][0] == 0 and mine[-1][1] == K and all(a[1] == b[0] for a, b in zip(mine, mine[1:]))
    cap = window_bytes // 4
    for w in plan.windows:
        footprint = sum(shapes[i][0] * (k1 - k0) for i, k0, k1 in w)
        assert footprint <= cap or (len(w) == 1 and w[0][2] - w[0][1] == 1)
    if window_bytes == 64:
        assert len(plan.windows) > 10
    # within a window: the window's valid slots (ascending) stable-sorted by row
    start = 0
    for w in plan.windows:
        mask = np.zeros(valid.size, bool)
        for i, k0, k1 in w:
            L, K = shapes[i]
            cols = np.arange(k0, k1)
            idx = (np.arange(L)[:, None] * K + cols[None, :]) if transposed else (cols[:, None] * L + np.arange(L)[None, :])
            mask[plan.offsets[i] + idx.reshape(-1)] = True
        slots = np.flatnonzero(mask & valid)
        want = slots[np.argsort(row_of[slots], kind="stable")]
        np.testing.assert_array_equal(plan.order[start:start + slots.size], want)
        start += slots.size
    assert start == plan.order.size
    # segments: one row each, in order; rows' segments in window order; items cover them
    seg_ptr = plan.seg_ptr.astype(np.int64)
    assert seg_ptr[0] == 0 and seg_ptr[-1] == plan.order.size and (np.diff(seg_ptr) > 0).all()
    assert (np.diff(seg_ptr) <= SEG_MAX).all()
    for s in range(plan.seg_row.size):
        assert (row_of[plan.order[seg_ptr[s]:seg_ptr[s + 1]]] == plan.seg_row[s]).all()
    assert plan.item_ptr[0] == 0 and plan.item_ptr[-1] == plan.seg_row.size and (np.diff(plan.item_ptr) > 0).all()
    for r in (0, m // 2, m - 1):
        segs = plan.row_segs[plan.row_ptr[r]:plan.row_ptr[r + 1]]
        assert (np.diff(segs) > 0).all() and (plan.seg_row[segs] == r).all()
        assert plan.row_ptr[r + 1] - plan.row_ptr[r] == (plan.seg_row == r).sum()


def test_heavy_rows_are_cut_into_segments():
    rows, lengths, valid, vals, row_of = _tiles(3, True, shapes=((8192, 6),))
    plan = build_row_sum_plan(rows, lengths, 3, transposed=True)
    assert len(plan.windows) == 1 and (np.diff(plan.seg_ptr) <= SEG_MAX).all()
    assert plan.seg_row.size > 3  # ~8000 slots per row, at most SEG_MAX a segment
    got = segment_sum_rows_reference(torch.zeros(3), torch.from_numpy(vals), _torch_plan(plan))
    want = np.bincount(row_of[valid], weights=vals[valid].astype(np.float64), minlength=3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(vals).sum())


@pytest.mark.parametrize("window_bytes", [16 << 20, 256], ids=["default-window", "tiny-window"])
@pytest.mark.parametrize("m", [7, 300])
def test_plain_version_matches_jax_segment_sum(m, window_bytes):
    rows, lengths, valid, vals, row_of = _tiles(m, True, shapes=((500, 8), (64, 2)))
    start = np.random.default_rng(m).normal(size=m).astype(np.float32)
    ref = jnp.asarray(start) + jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(row_of), num_segments=m)
    plan = _torch_plan(build_row_sum_plan(rows, lengths, m, transposed=True, window_bytes=window_bytes))
    got = segment_sum_rows_reference(torch.from_numpy(start.copy()), torch.from_numpy(vals), plan)
    scale = max(1.0, np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5 * scale)
    # the wrapper takes the plain version on CPU tensors and counts nothing
    out = torch.from_numpy(start.copy())
    same = segment_sum_rows(out, torch.from_numpy(vals), plan)
    assert same is out and torch.equal(out, got) and profiling.counter("dualip.ops.segment_sum_rows.enqueued") == 0
    # padding slots are never read
    junk = torch.from_numpy(np.where(valid, vals, np.float32(1e30)))
    assert torch.equal(segment_sum_rows(torch.from_numpy(start.copy()), junk, plan), got)


def test_wrapper_rejects_mixed_devices():
    plan = _torch_plan(build_row_sum_plan([np.zeros((2, 2), np.int32)], [np.full(2, 2, np.int32)], 3))
    with pytest.raises(ValueError, match="vals on"):
        segment_sum_rows(torch.zeros(3), torch.zeros(4, device="meta"), plan)
    with pytest.raises(ValueError, match="slots"):
        segment_sum_rows(torch.zeros(3), torch.zeros(5), plan)
    with pytest.raises(ValueError, match="rows"):
        segment_sum_rows(torch.zeros(4), torch.zeros(4), plan)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_csc_objective_carries_row_orders_and_repeats_itself(use_pallas):
    rng = np.random.default_rng(2)
    m, n = 24, 400
    dense = np.abs(rng.normal(size=(m, n))).astype(np.float32)
    dense[rng.random(size=(m, n)) < 0.7] = 0.0
    dense[0] = np.where(dense[0] == 0, 0.1, dense[0])
    obj = MatchingSolverDualObjectiveFunction(
        MatchingInputArgs(A=csc_from_dense(dense), c=csc_from_dense(-dense),
                          projection_map=create_projection_map("simplex", {"z": 1}, n), b_vec=np.ones(m, np.float32)),
        gamma=1e-2, device="cpu", use_pallas=use_pallas, pallas_block_k=64,
    )
    plan = obj.bcsc.row_sum
    tiles = obj.bcsc.tiles
    assert obj.bcsc.transposed == use_pallas
    want = build_row_sum_plan([t.rows.numpy() for t in tiles], [t.length.numpy() for t in tiles], m, use_pallas)
    for f in ("order", "seg_ptr", "seg_row", "item_ptr", "row_ptr", "row_segs"):
        np.testing.assert_array_equal(getattr(plan, f).numpy(), getattr(want, f))
    assert plan.slots == sum(t.a.numel() for t in tiles) and plan.offsets == want.offsets
    assert plan.order.numel() == sum(int(t.length.sum()) for t in tiles) == int((dense != 0).sum())
    lam = np.abs(rng.normal(size=m)).astype(np.float32)
    r1, r2 = obj.calculate(lam), obj.calculate(lam)
    assert torch.equal(r1.dual_gradient, r2.dual_gradient) and float(r1.dual_objective) == float(r2.dual_objective)
    # the layouts that never segment-sum carry no plan
    bfly = MatchingSolverDualObjectiveFunction(
        MatchingInputArgs(A=csc_from_dense(dense), c=csc_from_dense(-dense),
                          projection_map=create_projection_map("simplex", {"z": 1}, n), b_vec=np.ones(m, np.float32)),
        gamma=1e-2, device="cpu", layout="row",
    )
    assert bfly.bcsc.row_sum is None
