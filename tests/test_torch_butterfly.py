"""The port's Benes engine against the JAX package's, on the CPU.

Everything here is exact: routing masks, packed planes, packed plans (groups
and mask arrays) and every application of a plan move bits without arithmetic,
so the two packages must agree element for element."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dualip_tpu.ops.butterfly as jbf
import dualip_tpu_torch.ops.butterfly as pbf
from dualip_tpu_torch.io import native_loader

torch.set_num_threads(1)


def _perm(n, seed):
    return np.random.default_rng(seed).permutation(n)


def _x(n, seed, dtype=np.float32):
    return np.random.default_rng(seed + 100).normal(size=n).astype(dtype)


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's payload as integers, so bf16 compares bit for bit."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()


def _jax_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("n,seed", [(2, 0), (8, 1), (100, 3), (1024, 4), (5000, 5), (20_000, 6)])
def test_benes_route_masks_equal(n, seed):
    """(20_000 pads to 2^15, where both packages take their native router.)"""
    perm = _perm(n, seed)
    ref, got = jbf.benes_route(perm), pbf.benes_route(perm)
    assert got.dists == ref.dists and (got.n_in, got.n_out) == (ref.n_in, ref.n_out)
    np.testing.assert_array_equal(np.asarray(got.masks), np.asarray(ref.masks))


def test_benes_route_injective_and_pad_to_equal():
    sel = np.random.default_rng(7).permutation(300)[:120]
    ref, got = jbf.benes_route(sel, pad_to=1024, n_in=300), pbf.benes_route(sel, pad_to=1024, n_in=300)
    np.testing.assert_array_equal(np.asarray(got.masks), np.asarray(ref.masks))
    assert (got.n_in, got.n_out) == (300, 120)
    with pytest.raises(ValueError, match="pad_to"):
        pbf.benes_route(sel, pad_to=256)
    with pytest.raises(ValueError, match="power of two"):
        pbf.benes_route(sel, pad_to=1000)


@pytest.mark.parametrize("n", [5000, 20_000])
def test_benes_route_planes_equal(n):
    perm = _perm(n, 2)
    ref, got = jbf.benes_route_planes(perm), pbf.benes_route_planes(perm)
    np.testing.assert_array_equal(got[0], ref[0])
    assert tuple(got[1:]) == tuple(ref[1:])
    np.testing.assert_array_equal(got[0], pbf._packbits_stages(np.asarray(pbf.benes_route(perm).masks)))


def test_native_router_equals_numpy_router(monkeypatch):
    """The port's binding of the native routers against its numpy router."""
    if not native_loader.native_available():
        pytest.skip("no C++ compiler: the numpy router is the only one")
    perm = _perm(1 << 14, 9)
    native = pbf.benes_route(perm)
    assert pbf.last_route["router"] == "native"
    packed = native_loader.benes_route_packed_native(pbf._complete_bijection(perm, perm.size, 1 << 14))
    monkeypatch.setattr(native_loader, "benes_route_native", lambda src: None)
    plain = pbf.benes_route(perm)
    assert pbf.last_route["router"] == "numpy"
    np.testing.assert_array_equal(np.asarray(native.masks), np.asarray(plain.masks))
    np.testing.assert_array_equal(packed, pbf._packbits_stages(np.asarray(plain.masks)))


# (n, block_log2, cap on the two-axis regime or None): one fine group only; one
# single-axis group a side; one two-axis group a side; two groups a side.
REGIMES = [
    pytest.param(4096, 15, None, id="fine-only"),
    pytest.param(4096, 9, None, id="one-group"),
    pytest.param(1 << 16, 7, None, id="two-axis"),
    pytest.param(90_000, 8, None, id="two-axis-padded"),
    pytest.param(1 << 16, 7, 64, id="split"),
]


def _packed_pair(n, block_log2, cap, monkeypatch, seed=5):
    if cap is not None:
        monkeypatch.setattr(jbf, "COARSE_FUSE_NB_CAP", cap)
        monkeypatch.setattr(pbf, "COARSE_FUSE_NB_CAP", cap)
    perm = _perm(n, seed)
    plan = pbf.benes_route(perm)
    return perm, plan, jbf.pack_plan(jbf.benes_route(perm), block_log2=block_log2), pbf.pack_plan(plan, block_log2)


@pytest.mark.parametrize("n,block_log2,cap", REGIMES)
def test_pack_plan_equal(n, block_log2, cap, monkeypatch):
    _, _, ref, got = _packed_pair(n, block_log2, cap, monkeypatch)
    assert got.fine_dists == ref.fine_dists
    assert got.pre_groups == ref.pre_groups and got.post_groups == ref.post_groups
    assert (got.N, got.n_in, got.n_out, got.block_log2) == (ref.N, ref.n_in, ref.n_out, ref.block_log2)
    assert got.fine_masks.dtype == torch.uint8
    np.testing.assert_array_equal(got.fine_masks.numpy(), np.asarray(ref.fine_masks))
    assert len(got.pre_masks) == len(ref.pre_masks) and len(got.post_masks) == len(ref.post_masks)
    for g, r in zip(got.pre_masks + got.post_masks, ref.pre_masks + ref.post_masks):
        assert tuple(g.shape) == tuple(r.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if cap is not None:
        assert len(got.pre_groups) == 2 and not isinstance(got.pre_groups[0][1], tuple)
    elif n > (1 << block_log2) and block_log2 <= 8:
        assert len(got.pre_groups) == 1 and isinstance(got.pre_groups[0][1], tuple)


def test_pack_plan_rejects_a_block_below_one_row():
    with pytest.raises(ValueError, match="block_log2"):
        pbf.pack_plan(pbf.benes_route(_perm(1024, 0)), block_log2=6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [100, 5000])
def test_apply_butterfly_equal(n, dtype):
    perm = _perm(n, 11)
    x = _x(n, 11)
    ref_plan, plan = jbf.benes_route(perm), pbf.benes_route(perm)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    for truncate in (True, False):
        y_ref = jbf.apply_butterfly(ref_plan, xj, truncate=truncate)
        y = pbf.apply_butterfly(plan, xt, truncate=truncate)
        np.testing.assert_array_equal(_bits(y), _jax_bits(y_ref))
    back_ref = jbf.apply_butterfly(ref_plan, jbf.apply_butterfly(ref_plan, xj), reverse=True)
    back = pbf.apply_butterfly(plan, pbf.apply_butterfly(plan, xt), reverse=True)
    np.testing.assert_array_equal(_bits(back), _jax_bits(back_ref))
    np.testing.assert_array_equal(_bits(back), _bits(xt))
    if dtype == "float32":
        np.testing.assert_array_equal(pbf.apply_butterfly(plan, xt).numpy(), x[perm])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,block_log2,cap", REGIMES)
def test_blocked_apply_equals_permutation(n, block_log2, cap, dtype, monkeypatch):
    """The blocked form on the CPU (each kernel's plain version on the packed
    masks): forward is x[perm], reverse gives x back, in every regime."""
    perm, plan, _, packed = _packed_pair(n, block_log2, cap, monkeypatch)
    x = torch.from_numpy(_x(n, 3)).to(getattr(torch, dtype))
    y = pbf.apply_butterfly_cuda(packed, x)
    np.testing.assert_array_equal(_bits(y), _bits(x[torch.from_numpy(perm)]))
    np.testing.assert_array_equal(_bits(y), _bits(pbf.apply_butterfly(plan, x)))
    back = pbf.apply_butterfly_cuda(packed, y, reverse=True)
    np.testing.assert_array_equal(_bits(back[:n]), _bits(x))
    full = pbf.apply_butterfly_cuda(packed, x, truncate=False)
    assert full.shape == (packed.N,) and not full[plan.n_out:].any()


@pytest.mark.parametrize("n,block_log2,cap", [REGIMES[1], REGIMES[2]])
def test_blocked_apply_equals_jax_interpret(n, block_log2, cap, monkeypatch):
    """Against the Pallas kernels in interpret mode, through the plan carried
    across as numpy arrays."""
    perm, _, ref, _ = _packed_pair(n, block_log2, cap, monkeypatch)
    x = _x(n, 4)
    y_ref = np.asarray(jbf.apply_butterfly_tpu(ref, jnp.asarray(x), interpret=True))
    carried = pbf.benes_plan_packed_from_numpy(
        ref.fine_dists, ref.pre_groups, ref.post_groups, np.asarray(ref.fine_masks),
        [np.asarray(m) for m in ref.pre_masks], [np.asarray(m) for m in ref.post_masks],
        ref.N, ref.n_in, ref.n_out, ref.block_log2,
    )
    y = pbf.apply_butterfly_cuda(carried, torch.from_numpy(x))
    np.testing.assert_array_equal(y.numpy(), y_ref)
    back_ref = np.asarray(jbf.apply_butterfly_tpu(ref, jnp.asarray(y_ref), reverse=True, interpret=True))
    back = pbf.apply_butterfly_cuda(carried, y, reverse=True)
    np.testing.assert_array_equal(back.numpy(), back_ref)


def test_plan_from_numpy_carries_a_jax_plan():
    perm = _perm(3000, 8)
    ref = jbf.benes_route(perm)
    plan = pbf.benes_plan_from_numpy(ref.dists, np.asarray(ref.masks), ref.n_in, ref.n_out)
    assert isinstance(plan.masks, torch.Tensor) and plan.masks.dtype == torch.int8
    x = _x(3000, 8)
    np.testing.assert_array_equal(pbf.apply_butterfly(plan, torch.from_numpy(x)).numpy(), x[perm])


def test_per_group_plain_versions_compose_to_the_plan():
    """K5, K6 and K7's plain versions, called one group at a time, give the
    unblocked plan's result."""
    perm = _perm(1 << 13, 12)
    plan = pbf.benes_route(perm)
    x = torch.from_numpy(_x(1 << 13, 12))
    for block_log2 in (9, 7):  # 16 blocks: one group a side; 64 blocks with the cap below
        packed = pbf.pack_plan(plan, block_log2)
        v = x
        for (steps, E, I_rows), m in zip(packed.pre_groups, packed.pre_masks):
            v = pbf.benes_coarse(v, m, steps, E, I_rows)
        v = pbf.benes_fine(v, packed.fine_masks, packed.fine_dists)
        for (steps, E, I_rows), m in zip(packed.post_groups, packed.post_masks):
            v = pbf.benes_coarse(v, m, steps, E, I_rows)
        np.testing.assert_array_equal(v.numpy(), x.numpy()[perm])
    assert pbf.benes_fine.launches == pbf.benes_coarse.launches == pbf.benes_coarse2.launches == 0
