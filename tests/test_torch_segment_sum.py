"""The fixed-order row segment-sum: its static row-sorted order against
``np.argsort(kind="stable")``, its plain version against
``jax.ops.segment_sum`` (fp32, atol 1e-5 of the largest row sum), and the csc
objective's use of it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dualip_tpu_torch.objectives.matching import MatchingInputArgs, MatchingSolverDualObjectiveFunction
from dualip_tpu_torch.ops.segment_sum import segment_sum_rows, segment_sum_rows_reference
from dualip_tpu_torch.projections import create_projection_map
from dualip_tpu_torch.sparse import csc_from_dense
from dualip_tpu_torch.sparse.bcsc import tile_row_order

torch.set_num_threads(1)


def _tile(seed, m, K, L):
    rng = np.random.default_rng(seed)
    length = rng.integers(0, L + 1, size=K).astype(np.int32)
    rows = rng.integers(0, m, size=(K, L)).astype(np.int32)
    valid = np.arange(L)[None, :] < length[:, None]
    rows = np.where(valid, rows, 0).astype(np.int32)  # padding slots hold row 0, as the tiles do
    vals = np.where(valid, rng.normal(size=(K, L)), 0).astype(np.float32)
    return rows, length, valid, vals


@pytest.mark.parametrize("transposed", [False, True], ids=["KL", "LK"])
@pytest.mark.parametrize("m", [7, 300, 70_000], ids=["m7", "m300", "m70000-int32-keys"])
def test_row_order_is_the_stable_argsort_of_the_valid_slots(m, transposed):
    rows, length, valid, _ = _tile(m, m, K=257, L=6)
    if transposed:
        rows, valid = np.ascontiguousarray(rows.T), np.ascontiguousarray(valid.T)
    ro = tile_row_order(rows, length, m, transposed)
    slots = np.nonzero(valid.reshape(-1))[0]
    keys = rows.reshape(-1)[slots]
    np.testing.assert_array_equal(ro.order, slots[np.argsort(keys, kind="stable")])
    assert ro.order.dtype == np.int32 and ro.ptr.dtype == np.int64 and ro.ptr.shape == (m + 1,)
    np.testing.assert_array_equal(np.diff(ro.ptr), np.bincount(keys, minlength=m))
    for r in (0, m // 2, m - 1):  # a row's range holds exactly its slots, in slot order
        mine = ro.order[ro.ptr[r]:ro.ptr[r + 1]]
        np.testing.assert_array_equal(mine, slots[keys == r])


@pytest.mark.parametrize("m", [7, 300])
def test_plain_version_matches_jax_segment_sum(m):
    rows, length, valid, vals = _tile(m + 1, m, K=500, L=8)
    start = np.random.default_rng(m).normal(size=m).astype(np.float32)
    ref = jnp.asarray(start) + jax.ops.segment_sum(
        jnp.asarray(vals.reshape(-1)), jnp.asarray(rows.reshape(-1)), num_segments=m)
    got = segment_sum_rows_reference(torch.from_numpy(start.copy()), torch.from_numpy(vals), torch.from_numpy(rows))
    scale = max(1.0, np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5 * scale)
    # the wrapper takes the plain version on CPU tensors, with or without the order, and counts nothing
    ro = tile_row_order(rows, length, m)
    out = torch.from_numpy(start.copy())
    same = segment_sum_rows(out, torch.from_numpy(vals), torch.from_numpy(rows),
                            (torch.from_numpy(ro.order), torch.from_numpy(ro.ptr)))
    assert same is out and torch.equal(out, got) and segment_sum_rows.launches == 0
    # summing the row-sorted order row by row is the same function
    by_order = start.astype(np.float64) + np.add.reduceat(
        np.append(vals.reshape(-1)[ro.order].astype(np.float64), 0.0), np.minimum(ro.ptr[:-1], ro.order.size)
    ) * (np.diff(ro.ptr) > 0)
    np.testing.assert_allclose(got.numpy(), by_order, atol=1e-5 * scale)


def test_wrapper_rejects_mixed_devices():
    with pytest.raises(ValueError, match="vals on"):
        segment_sum_rows(torch.zeros(3), torch.zeros(4, device="meta"), torch.zeros(4, dtype=torch.int32))


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
    assert obj.bcsc.transposed == use_pallas and len(obj.bcsc.row_orders) == len(obj.bcsc.tiles)
    for tile, ro in zip(obj.bcsc.tiles, obj.bcsc.row_orders):
        want = tile_row_order(tile.rows.numpy(), tile.length.numpy(), m, use_pallas)
        np.testing.assert_array_equal(ro.order.numpy(), want.order)
        np.testing.assert_array_equal(ro.ptr.numpy(), want.ptr)
        assert int(ro.ptr[-1]) == int(tile.length.sum())
    lam = np.abs(rng.normal(size=m)).astype(np.float32)
    r1, r2 = obj.calculate(lam), obj.calculate(lam)
    assert torch.equal(r1.dual_gradient, r2.dual_gradient) and float(r1.dual_objective) == float(r2.dual_objective)
    assert sum(int(t.length.sum()) for t in obj.bcsc.tiles) == int((dense != 0).sum())
    # the layouts that never segment-sum carry no orders
    bfly = MatchingSolverDualObjectiveFunction(
        MatchingInputArgs(A=csc_from_dense(dense), c=csc_from_dense(-dense),
                          projection_map=create_projection_map("simplex", {"z": 1}, n), b_vec=np.ones(m, np.float32)),
        gamma=1e-2, device="cpu", layout="row",
    )
    assert bfly.bcsc.row_orders is None
