"""The source index of the gather kernels (K5, K7) against the JAX package, on
the CPU.

A packed plan carries, per gather launch, each slot's source position (in its
block for the fine stages, along the launch's axis for a two-axis coarse
side), forward and reverse.  Applied as a plain gather, the index must give
exactly what the stages give: the JAX package's Pallas kernels in interpret
mode, and the port's own plain stages, bit for bit in fp32 and bf16."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dualip_tpu.ops.butterfly as jbf
import dualip_tpu_torch.ops.butterfly as pbf
from dualip_tpu_torch.utils import profiling

torch.set_num_threads(1)

# (n, block_log2, cap on the two-axis regime, cap on a K7 strip's slots): as
# tests/test_torch_butterfly.py's REGIMES, plus a two-axis side whose strip
# does not fit a (lowered) cap, so its gather runs one launch per axis.
REGIMES = [
    pytest.param(4096, 15, None, None, id="fine-only"),
    pytest.param(4096, 9, None, None, id="one-group"),
    pytest.param(1 << 16, 7, None, None, id="two-axis"),
    pytest.param(90_000, 8, None, None, id="two-axis-padded"),
    pytest.param(1 << 16, 7, 64, None, id="split"),
    pytest.param(1 << 16, 7, None, 2048, id="two-axis-per-axis"),
]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()


def _plans(n, block_log2, cap, strip, monkeypatch, seed=5):
    """(perm, JAX packed plan, the port's packing of the same routing)."""
    if cap is not None:
        monkeypatch.setattr(jbf, "COARSE_FUSE_NB_CAP", cap)
        monkeypatch.setattr(pbf, "COARSE_FUSE_NB_CAP", cap)
    if strip is not None:
        monkeypatch.setattr(pbf, "GATHER_STRIP_SLOTS", strip)
    perm = np.random.default_rng(seed).permutation(n)
    ref = jbf.pack_plan(jbf.benes_route(perm), block_log2=block_log2)
    return perm, ref, pbf.pack_plan(pbf.benes_route(perm), block_log2)


def _carry(ref):
    """The JAX package's packed plan carried across as numpy leaves."""
    return pbf.benes_plan_packed_from_numpy(
        ref.fine_dists, ref.pre_groups, ref.post_groups, np.asarray(ref.fine_masks),
        [np.asarray(m) for m in ref.pre_masks], [np.asarray(m) for m in ref.post_masks],
        ref.N, ref.n_in, ref.n_out, ref.block_log2,
    )


def _gather_fine(v, idx, bs):
    """Plain K5 by its index: each block gathers from itself."""
    return v.view(-1, bs).gather(1, pbf.index_values(idx).view(-1, bs)).reshape(-1)


def _gather_rows(v, launches, E_hi, E_lo, R):
    """Plain K7 by its index: ``launches`` = ((axis, index), ...) in execution order."""
    for axis, idx in launches:
        E, inner = pbf._axis_view(axis, E_hi, E_lo, R)
        v = v.view(-1, E, inner).gather(1, pbf.index_values(idx).view(-1, E, inner)).reshape(-1)
    return v


def _gather_apply(plan, x, reverse=False):
    """The whole blocked application through the index (K6 groups by their
    plain stages, as K6 keeps its window form)."""
    pre = list(zip(plan.pre_groups, plan.pre_masks, plan.pre_src))
    post = list(zip(plan.post_groups, plan.post_masks, plan.post_src))
    if reverse:
        pre, post = ([((st[::-1], E, I), m, s) for (st, E, I), m, s in reversed(post)],
                     [((st[::-1], E, I), m, s) for (st, E, I), m, s in reversed(pre)])
    bs = plan.fine_masks.shape[2] * plan.fine_masks.shape[3]
    v = pbf._pad_to(x, plan.N)

    def coarse(v, side):
        for (steps, E, I), m, src in side:
            if isinstance(E, tuple):
                v = _gather_rows(v, pbf._direction(src, reverse), *E, I)
            else:
                v = pbf.benes_coarse_reference(v, m, steps, E, I)
        return v

    v = coarse(v, pre)
    v = _gather_fine(v, plan.fine_src_rev if reverse else plan.fine_src_fwd, bs)
    return coarse(v, post)


@pytest.mark.parametrize("n,block_log2,cap,strip", [REGIMES[1], REGIMES[2], REGIMES[5]])
def test_index_gather_equals_jax_interpret(n, block_log2, cap, strip, monkeypatch):
    """The index of a plan the JAX package routed and packed, applied as a
    plain gather to an iota, against the Pallas kernels in interpret mode,
    forward and reverse, in whole."""
    _, ref, _ = _plans(n, block_log2, cap, strip, monkeypatch)
    plan = _carry(ref)
    iota = np.arange(ref.N, dtype=np.float32)  # exact in fp32: N < 2^24
    y_ref = np.asarray(jbf.apply_butterfly_tpu(ref, jnp.asarray(iota), interpret=True, truncate=False))
    y = _gather_apply(plan, torch.from_numpy(iota))
    np.testing.assert_array_equal(y.numpy(), y_ref)
    back_ref = np.asarray(jbf.apply_butterfly_tpu(ref, jnp.asarray(iota), reverse=True, interpret=True,
                                                  truncate=False))
    back = _gather_apply(plan, torch.from_numpy(iota), reverse=True)
    np.testing.assert_array_equal(back.numpy(), back_ref)


@pytest.mark.parametrize("n,block_log2,cap,strip", REGIMES)
def test_index_is_a_permutation_of_each_block_and_axis(n, block_log2, cap, strip, monkeypatch):
    _, _, plan = _plans(n, block_log2, cap, strip, monkeypatch)
    bs = plan.fine_masks.shape[2] * plan.fine_masks.shape[3]
    for idx in (plan.fine_src_fwd, plan.fine_src_rev):
        assert idx.dtype == torch.int16 and idx.shape == (plan.N,)
        rows = pbf.index_values(idx).view(-1, bs).sort(dim=1).values
        assert torch.equal(rows, torch.arange(bs).expand_as(rows))
    for groups, srcs in ((plan.pre_groups, plan.pre_src), (plan.post_groups, plan.post_src)):
        assert len(srcs) == len(groups)
        for (steps, E, R), src in zip(groups, srcs):
            if not isinstance(E, tuple):
                assert src is None  # K6 keeps its window form
                continue
            assert [a for a, _, _ in src] == [a for a, _ in pbf.coarse2_launches(steps, *E)]
            for axis, fwd, rev in src:
                En, inner = pbf._axis_view(axis, *E, R)
                for idx in (fwd, rev):
                    cols = pbf.index_values(idx).view(-1, En, inner).sort(dim=1).values
                    assert torch.equal(cols, torch.arange(En).view(1, En, 1).expand_as(cols))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,block_log2,cap,strip", REGIMES)
def test_index_gather_equals_plain_stages(n, block_log2, cap, strip, dtype, monkeypatch):
    """Each gather by the index against the plain version of its kernel,
    group by group, forward and reverse, bit for bit."""
    _, _, plan = _plans(n, block_log2, cap, strip, monkeypatch)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=plan.N).astype(np.float32)).to(getattr(torch, dtype))
    bs = plan.fine_masks.shape[2] * plan.fine_masks.shape[3]
    for reverse, idx in ((False, plan.fine_src_fwd), (True, plan.fine_src_rev)):
        want = pbf.benes_fine_reference(x, plan.fine_masks, plan.fine_dists, reverse)
        np.testing.assert_array_equal(_bits(_gather_fine(x, idx, bs)), _bits(want))
    for groups, masks, srcs in ((plan.pre_groups, plan.pre_masks, plan.pre_src),
                                (plan.post_groups, plan.post_masks, plan.post_src)):
        for (steps, E, R), m, src in zip(groups, masks, srcs):
            if not isinstance(E, tuple):
                continue
            for reverse in (False, True):
                want = pbf.benes_coarse2_reference(x, m, steps[::-1] if reverse else steps, *E, R)
                got = _gather_rows(x, pbf._direction(src, reverse), *E, R)
                np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n,block_log2,cap,strip", REGIMES)
def test_index_gather_is_the_permutation(n, block_log2, cap, strip, monkeypatch):
    """Forward through the index is x[perm]; reverse gives x back."""
    perm, _, plan = _plans(n, block_log2, cap, strip, monkeypatch)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=n).astype(np.float32))
    y = _gather_apply(plan, x)
    np.testing.assert_array_equal(y[:n].numpy(), x.numpy()[perm])
    np.testing.assert_array_equal(_gather_apply(plan, y, reverse=True)[:n].numpy(), x.numpy())


@pytest.mark.parametrize("n,block_log2,cap,strip", REGIMES)
def test_carried_jax_plan_has_the_ports_index(n, block_log2, cap, strip, monkeypatch):
    """``benes_plan_packed_from_numpy`` of a JAX plan builds the same index as
    the port's own packing of the same routing."""
    _, ref, own = _plans(n, block_log2, cap, strip, monkeypatch)
    carried = _carry(ref)
    got, want = pbf.index_tensors(carried), pbf.index_tensors(own)
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert g is not None and torch.equal(g, w)
    # fine: 2 B a slot a direction; each two-axis side the same again
    sides = sum(isinstance(E, tuple) for _, E, _ in own.pre_groups + own.post_groups)
    n_axes = sum(len(s) for s in own.pre_src + own.post_src if s is not None)
    assert pbf.index_bytes(own) == 4 * own.N * (1 + n_axes)
    assert n_axes >= sides


def test_index_built_by_window_wrappers_equals_plain_build():
    """On the CPU the window wrappers run their plain versions, so the two
    builds agree; on the card chip_smoke.py holds the kernels' build to it."""
    perm = np.random.default_rng(3).permutation(1 << 15)
    plan = pbf.pack_plan(pbf.benes_route(perm), 7)
    plain = pbf.build_index(dataclasses.replace(plan), plain=True)
    for g, w in zip(pbf.index_tensors(plan), pbf.index_tensors(plain)):
        assert torch.equal(g, w)
    assert profiling.last("dualip.build.index").end_ns > profiling.last("dualip.build.index").start_ns
    assert profiling.counter("dualip.ops.benes_fine_window.enqueued") == 0
    assert profiling.counter("dualip.ops.benes_coarse2_window.enqueued") == 0


@pytest.mark.parametrize("drop", ["fine_src_fwd", "fine_src_rev", "pre_src", "post_src", "one-launch"])
def test_plan_without_its_index_is_refused(drop):
    """The check that stops a CUDA plan without its index (no fallback to the
    window form or the plain stages), on a plan object built on the CPU."""
    plan = pbf.pack_plan(pbf.benes_route(np.random.default_rng(4).permutation(1 << 16)), 7)
    pbf.require_index(plan)  # a whole plan passes
    if drop == "one-launch":
        (axis, fwd, _), = plan.pre_src[0]
        broken = dataclasses.replace(plan, pre_src=(((axis, fwd, None),),))
    else:
        broken = dataclasses.replace(plan, **{drop: None})
    with pytest.raises(ValueError, match="source index"):
        pbf.require_index(broken)
    # the CPU path runs the plain stages and needs no index
    x = torch.arange(plan.N, dtype=torch.float32)
    assert torch.equal(pbf.apply_butterfly_cuda(broken, x), pbf.apply_butterfly_cuda(plan, x))


def test_a_single_axis_plan_needs_only_the_fine_index():
    plan = pbf.pack_plan(pbf.benes_route(np.random.default_rng(6).permutation(4096)), 9)
    assert plan.pre_src == (None,) and plan.post_src == (None,)
    pbf.require_index(plan)
    assert pbf.index_bytes(plan) == 4 * plan.N


def test_index_needs_a_16_bit_block():
    perm = np.random.default_rng(7).permutation(1 << 17)
    with pytest.raises(ValueError, match="block_log2 <= 16"):
        pbf.pack_plan(pbf.benes_route(perm), 17)


@pytest.mark.parametrize("E,elem,want", [
    (2048, 4, 16), (2048, 2, 16), (4096, 4, 8), (4096, 2, 8), (1024, 4, 16), (64, 2, 32), (8192, 4, 0),
])
def test_gather_strip_lanes(E, elem, want):
    """K7's strip: 64 B of lanes per position, narrowed to at most 2^15 slots,
    never below 8 lanes (16 B of index, one TMA box row); 8192 positions never
    fit, and coarse2_launches splits such a side by axis."""
    W = pbf._gather_lanes(E, 1 << 15, elem)
    assert W == want
    if W:
        assert E * W <= pbf.GATHER_STRIP_SLOTS and E * W * (elem + 2) <= pbf.SMEM_LIMIT and W * elem >= 16


@pytest.mark.parametrize("E_hi,E_lo,launches", [(32, 64, (2,)), (64, 64, (2,)), (64, 128, (1, 0))])
def test_coarse2_launch_split(E_hi, E_lo, launches):
    """One launch while all positions fit a strip at 8 lanes (the slice's
    2048 blocks), one per axis beyond (8192 blocks)."""
    qs = [E_hi * E_lo >> k for k in range(1, (E_hi * E_lo).bit_length())]  # pre side: descending
    steps = tuple(enumerate(qs))
    got = pbf.coarse2_launches(steps, E_hi, E_lo)
    assert tuple(a for a, _ in got) == launches
    assert sum(len(st) for _, st in got) == len(steps)
    post = pbf.coarse2_launches(tuple(enumerate(qs[::-1])), E_hi, E_lo)
    assert tuple(a for a, _ in post) == launches[::-1]
