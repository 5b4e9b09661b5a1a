"""Benes butterfly engine: a static permutation as a network of paired
exchanges (``dualip_tpu/ops/butterfly.py``).

A static permutation of N = 2^n slots is a Benes network: ``2n - 1`` stages at
distances ``2^(n-1), ..., 2, 1, 2, ..., 2^(n-1)``; stage ``s`` with distance
``d`` is ``out[i] = mask[s][i] ? in[i ^ d] : in[i]``.  The distance sequence is
a palindrome and every stage is an involution, so the SAME masks walked
backwards apply the inverse permutation (``reverse=True``).

Pieces:

* ``benes_route(perm)`` / ``benes_route_planes(perm)``: host-side routing, the
  looping argument vectorised in numpy by pointer doubling (O(N log^2 N)); from
  N = 2^14 on the native router (``io/native_loader.py``) when it can be built.
  Each routing is a span ``dualip.build.route`` of ``utils/profiling.py``
  (attributes ``router``, ``"native"`` or ``"numpy"``, and ``N``).
* ``apply_butterfly(plan, x)``: the plain version, stage by stage in torch ops.
* ``pack_plan`` / ``pack_plan_from_planes``: the split of a plan at a block
  size into coarse groups and fine stages, masks bit-packed 8 stages per uint8
  plane, element for element the JAX package's packed plan.
* ``build_index(plan)``: the source index of the gather kernels.  The fine
  stages permute within each block and a two-axis coarse side moves each lane
  across the block positions only, so each is a static permutation that is
  found once per plan by running its stages on an iota: for every slot, the
  in-block offset (fine) or block position (coarse) it reads from, 16 bits,
  forward and reverse.  Packing builds it.
* ``apply_butterfly_cuda(plan, x)``: the blocked form.  On CUDA tensors the
  fine stages run in ``benes_fine`` (K5) and a two-axis coarse side in
  ``benes_coarse2`` (K7), each one gather through the plan's index, and a
  single-axis coarse group in ``benes_coarse`` (K6), which runs its stages in
  register windows; all are hand-written kernels of ``csrc/benes.cu`` and
  work in place.  On CPU tensors each wrapper runs its plain version (the
  stages) on the same packed masks.

Block size.  The TPU block is 2^17 slots (512 KB of VMEM).  A Hopper thread
block has at most 227 KB of shared memory, and the fine kernel holds the
payload block there: 2^15 fp32 slots are 128 KB (the window form, which
builds the index, adds one 32 KB mask plane).  ``DEFAULT_BLOCK_LOG2`` is
therefore 15; ``block_log2`` stays a parameter, at most 16 for the 16-bit
index.
"""

from __future__ import annotations

import ctypes
import functools
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from dualip_tpu_torch.ops import _build
from dualip_tpu_torch.utils import profiling


@dataclass
class BenesPlan:
    """Routing of one static permutation (host-built, device-applied)."""

    dists: tuple  # (2n-1,) stage distances: 2^(n-1)..2..1..2..2^(n-1)
    masks: object  # (2n-1, N) int8, 1 where the pair at that stage swaps; numpy or tensor
    n_in: int  # valid input length (inputs zero-padded to N)
    n_out: int  # valid output length



def _components_min(h: np.ndarray, max_cycle_log2: Optional[int] = None) -> np.ndarray:
    """Min element id over each orbit of permutation ``h`` (pointer doubling);
    ``max_cycle_log2`` bounds the orbit length 2^k, so k+1 steps suffice."""
    rep = np.arange(h.size, dtype=np.int32)
    hk = h
    if max_cycle_log2 is None:
        max_cycle_log2 = int(np.ceil(np.log2(max(h.size, 2))))
    for _ in range(max(1, max_cycle_log2 + 1)):
        rep = np.minimum(rep, rep[hk])
        hk = hk[hk]
    return rep


def _route_shape(perm: np.ndarray, pad_to, n_in):
    """Normalize (perm, n_out, n_in, N, n) for the routers."""
    perm = np.asarray(perm)
    if perm.dtype not in (np.int32, np.int64):
        perm = perm.astype(np.int64)
    n_out = perm.size
    if n_in is None:
        n_in = int(perm.max()) + 1 if perm.size else 1
    N = 1 << int(np.ceil(np.log2(max(n_out, n_in, 2))))
    if pad_to is not None:
        if pad_to < N:
            raise ValueError(f"pad_to={pad_to} < required {N}")
        N = pad_to
        if N & (N - 1):
            raise ValueError("pad_to must be a power of two")
    return perm, n_out, n_in, N, N.bit_length() - 1


def _complete_bijection(perm: np.ndarray, n_out: int, N: int) -> np.ndarray:
    """Complete an injective perm to a bijection on N slots (spares carry
    zeros either way).  Identity-preferring: a padding output slot whose
    same-numbered input is also unused maps to itself, a fixed point of every
    routing stage."""
    src = np.full(N, -1, dtype=np.int32)
    src[:n_out] = perm
    used = np.zeros(N, dtype=bool)
    used[perm] = True
    tail = np.arange(n_out, N)
    fix = ~used[tail]  # same-numbered input free -> identity
    src[tail[fix]] = tail[fix]
    used[tail[fix]] = True
    src[tail[~fix]] = np.nonzero(~used)[0]
    return src


def _benes_dists(n: int) -> tuple:
    return tuple(1 << b for b in range(n - 1, 0, -1)) + (1,) + tuple(1 << b for b in range(1, n))


def _note_route(router: str, N: int, t0_ns: int) -> None:
    profiling.add_span("dualip.build.route", t0_ns, router=router, N=N)


def benes_route_planes(perm: np.ndarray, pad_to: Optional[int] = None, n_in: Optional[int] = None):
    """Route ``perm`` and return ``(planes, dists, n_in, n_out)`` with the stage
    masks bit-packed 8 stages per byte, without the (2n-1, N) int8 masks in
    between when the native packed router is available.  Bit for bit
    ``_packbits_stages(benes_route(...).masks)``."""
    perm, n_out, n_in, N, n = _route_shape(perm, pad_to, n_in)
    if N >= (1 << 14):
        from dualip_tpu_torch.io.native_loader import benes_route_packed_native

        t0 = time.time_ns()
        planes = benes_route_packed_native(_complete_bijection(perm, n_out, N))
        if planes is not None:
            _note_route("native", N, t0)
            return planes, _benes_dists(n), n_in, n_out
    plan = benes_route(perm, pad_to=pad_to, n_in=n_in)
    return _packbits_stages(np.asarray(plan.masks)), plan.dists, plan.n_in, plan.n_out


def benes_route(perm: np.ndarray, pad_to: Optional[int] = None, n_in: Optional[int] = None) -> BenesPlan:
    """Route ``y = x_padded[perm]`` through a Benes network.

    ``perm`` maps output position to input position and must be injective;
    inputs and outputs are zero-padded to the next power of two.  ``n_in`` pins
    the valid input length (default ``perm.max() + 1``): the truncation of
    ``reverse=True`` outputs.  The masks stay on the host (numpy)."""
    perm, n_out, n_in, N, n = _route_shape(perm, pad_to, n_in)
    src = _complete_bijection(perm, n_out, N)
    n_stages = 2 * n - 1
    dists = _benes_dists(n)
    t0 = time.time_ns()

    if N >= (1 << 14):
        from dualip_tpu_torch.io.native_loader import benes_route_native

        native_masks = benes_route_native(src)
        if native_masks is not None:
            _note_route("native", N, t0)
            return BenesPlan(dists=dists, masks=native_masks, n_in=n_in, n_out=n_out)

    masks = np.zeros((n_stages, N), dtype=np.int8)
    idx = np.arange(N, dtype=np.int32)
    for t, b in enumerate(range(n - 1, 0, -1)):
        D = np.int32(1) << b
        inv = np.empty(N, dtype=np.int32)
        inv[src] = idx
        f = idx ^ D  # exit-switch partner (element ids == dest slots)
        g = inv[src ^ D]  # entry-switch partner
        h = g[f]  # jump-2 along the alternating constraint cycle
        # bits above b are pinned by earlier stages, so h only permutes within
        # independent blocks of 2^(b+1) slots
        rep = _components_min(h, max_cycle_log2=b + 1)
        # f maps each h-orbit to its parity complement; smaller-rep side = 0
        color = (rep > rep[f]).astype(np.int32)
        # entry stage swaps at source positions, exit stage at dest positions
        j = src
        m_entry = np.zeros(N, dtype=np.int8)
        m_entry[j] = (((j >> b) & 1) != color).astype(np.int8)
        m_exit = (((idx >> b) & 1) != color).astype(np.int8)
        masks[t] = m_entry
        masks[n_stages - 1 - t] = m_exit
        # pin bit b: element for dest i now enters sub-network `color`
        i2 = (idx & ~D) | (color << b)
        j2 = (j & ~D) | (color << b)
        new_src = np.empty(N, dtype=np.int32)
        new_src[i2] = j2
        src = new_src
    # middle stage (distance 1): whatever disagreement remains is a pair swap
    masks[n - 1] = (src != idx).astype(np.int8)
    _note_route("numpy", N, t0)
    return BenesPlan(dists=dists, masks=masks, n_in=n_in, n_out=n_out)


def benes_plan_from_numpy(dists, masks, n_in: int, n_out: int, device="cpu") -> BenesPlan:
    """The port's ``BenesPlan`` from another package's leaves (the JAX
    package's plan as numpy arrays and static values), masks on ``device``."""
    m = torch.as_tensor(np.array(masks, dtype=np.int8, order="C"), device=device)  # a copy: may be read-only
    return BenesPlan(dists=tuple(int(d) for d in dists), masks=m, n_in=int(n_in), n_out=int(n_out))


# ---------------------------------------------------------------------------
# Plain version: one torch op chain per stage
# ---------------------------------------------------------------------------


def _stage(v: torch.Tensor, mask: torch.Tensor, d: int) -> torch.Tensor:
    """One butterfly stage on a flat (N,) vector: slot i takes slot i ^ d
    where ``mask`` is set."""
    partner = v.view(-1, 2, d).flip(1).reshape(-1)
    return torch.where(mask, partner, v)


def _pad_to(x: torch.Tensor, N: int) -> torch.Tensor:
    pad = N - x.shape[0]
    return torch.cat([x, torch.zeros(pad, dtype=x.dtype, device=x.device)]) if pad else x


def apply_butterfly(plan: BenesPlan, x: torch.Tensor, reverse: bool = False, truncate: bool = True) -> torch.Tensor:
    """Apply the permutation (or its inverse) stage by stage in torch ops.

    ``truncate=False`` returns the full padded (N,) vector (spare slots carry
    zeros)."""
    masks = plan.masks
    if not isinstance(masks, torch.Tensor) or masks.device != x.device:
        masks = torch.as_tensor(np.asarray(masks) if not isinstance(masks, torch.Tensor) else masks, device=x.device)
    N = masks.shape[1]
    v = _pad_to(x, N)
    order = range(len(plan.dists))
    for s in (reversed(order) if reverse else order):
        v = _stage(v, masks[s] != 0, plan.dists[s])
    if not truncate:
        return v
    return v[: (plan.n_in if reverse else plan.n_out)]


# ---------------------------------------------------------------------------
# Blocked form: the packed plan
# ---------------------------------------------------------------------------

DEFAULT_BLOCK_LOG2 = 15  # 32K fp32 slots = 128 KB of shared memory, + one 32 KB mask plane

# Block-count limits of the coarse regimes, kept as the JAX package has them so
# a plan packed at one block_log2 is the same in both: a side with nb <=
# COARSE_E_CAP blocks is one single-axis group (K6); up to COARSE_FUSE_NB_CAP
# one two-axis group (K7); beyond, two single-axis groups (high, then low).
COARSE_E_CAP = 256
COARSE_FUSE_NB_CAP = 8192


@dataclass
class BenesPlanPacked:
    """Split of a ``BenesPlan`` at a fixed block size, masks bit-packed 8
    stages per byte (stage s in bit ``s & 7`` of plane ``s >> 3``).  One buffer
    serves forward and reverse.

    Coarse stages are stored as groups: ``pre_groups``/``post_groups`` are
    static ``(steps, E, I_rows)`` tuples (``steps`` = ((bit, q), ...) in forward
    execution order, ``q`` the distance in E-axis units; ``E`` is a pair
    ``(E_hi, E_lo)`` for a two-axis group) with per-group bit-planes in
    ``pre_masks``/``post_masks``.

    The gather kernels read the source index (``build_index``): (N,) int16
    tensors whose bits are read as uint16, in the payload's own layout.
    ``fine_src_fwd``/``fine_src_rev`` hold each slot's in-block source offset;
    ``pre_src``/``post_src`` hold, per group, ``None`` for a single-axis group
    (K6 keeps its window form) or one ``(axis, fwd, rev)`` per gather launch
    of a two-axis side in forward order (``coarse2_launches``), each index the
    source position along that launch's axis."""

    fine_dists: tuple  # static, forward order
    pre_groups: tuple  # static ((steps, E, I_rows), ...) forward order
    post_groups: tuple
    fine_masks: torch.Tensor  # (ceil(S_f/8), nb, R, 128) uint8 bit-planes
    pre_masks: tuple  # per group (ceil(S_g/8), O, E, I_rows, 128) uint8 bit-planes
    post_masks: tuple
    N: int
    n_in: int
    n_out: int
    block_log2: int
    fine_src_fwd: Optional[torch.Tensor] = None
    fine_src_rev: Optional[torch.Tensor] = None
    pre_src: Optional[tuple] = None
    post_src: Optional[tuple] = None


def _packbits_stages(m: np.ndarray) -> np.ndarray:
    """(S, X) masks -> (ceil(S/8), X) uint8 bit-planes, stage s -> bit s&7 of plane s>>3."""
    if m.shape[0] == 0:
        return np.zeros((0, m.shape[1]), dtype=np.uint8)
    if m.dtype in (np.int8, np.uint8):
        return np.packbits(m.view(np.uint8), axis=0, bitorder="little")
    return np.packbits(m != 0, axis=0, bitorder="little")


def _extract_planes(planes: np.ndarray, s0: int, s1: int) -> np.ndarray:
    """Re-base packed stage bit-planes to the stage subrange [s0, s1): the
    result packs stage s0+j at bit j&7 of plane j>>3.  A byte-shift splice;
    the masks are never unpacked."""
    N = planes.shape[1]
    if s1 <= s0:
        return np.zeros((0, N), dtype=np.uint8)
    P = (s1 - s0 + 7) // 8
    out = np.empty((P, N), dtype=np.uint8)
    for q in range(P):
        s = s0 + 8 * q
        k, r = s >> 3, s & 7
        v = planes[k] >> r if r else planes[k].copy()
        if r and k + 1 < planes.shape[0]:
            v |= (planes[k + 1] << (8 - r)).astype(np.uint8)
        nbits = min(8, s1 - s)
        if nbits < 8:
            v &= (1 << nbits) - 1
        out[q] = v
    return out


def _shaped_group_mask(planes: np.ndarray, s0: int, s1: int, E: int, I_rows: int) -> np.ndarray:
    """A group's planes re-based to [s0, s1), shaped (P, O, E, I_rows, 128)."""
    g = _extract_planes(planes, s0, s1)
    P, N = g.shape
    return g.reshape(P, N // (E * I_rows * 128), E, I_rows, 128)


def _pack_side(s0, s1, qs, planes, nb, R, e_cap):
    """Pack one side's coarse stages [s0, s1) into 1-2 contiguous groups.

    ``qs`` are the block distances (powers of two < nb) in forward execution
    order.  ``nb <= e_cap``: one single-axis group, E = nb.  Up to
    ``COARSE_FUSE_NB_CAP``: one two-axis group, descriptor
    ``(steps, (E_hi, E_lo), R)``; stages with q >= E_lo exchange along E_hi by
    q/E_lo, the rest along E_lo.  Beyond: split at q = e_lo into a HIGH group
    (E = nb/e_lo, I = e_lo*R rows) and a LOW group (E = e_lo, I = R)."""
    if s1 <= s0:
        return (), ()
    if nb <= e_cap:
        steps = tuple((i, q) for i, q in enumerate(qs))
        return ((steps, nb, R),), (_shaped_group_mask(planes, s0, s1, nb, R),)
    if nb <= COARSE_FUSE_NB_CAP:
        e_lo = 1 << ((nb.bit_length() - 1 + 1) // 2)  # ~sqrt(nb), pow2
        e_hi = nb // e_lo
        steps = tuple((i, q) for i, q in enumerate(qs))
        g = _extract_planes(planes, s0, s1)
        P, N = g.shape
        masks = g.reshape(P, N // (nb * R * 128), e_hi, e_lo, R * 128)
        return ((steps, (e_hi, e_lo), R),), (masks,)
    n_lo = 1
    while n_lo * n_lo < nb:
        n_lo *= 2
    e_lo = min(n_lo, e_cap)
    e_hi = nb // e_lo
    if e_hi > e_cap:
        raise ValueError(f"nb={nb} exceeds two-level coarse capacity ({e_cap}^2)")
    groups, group_masks = [], []
    hi_sel = [i for i, q in enumerate(qs) if q >= e_lo]
    lo_sel = [i for i, q in enumerate(qs) if q < e_lo]
    for sel, E, I_rows, qdiv in ((hi_sel, e_hi, e_lo * R, e_lo), (lo_sel, e_lo, R, 1)):
        if not sel:
            continue
        if sel != list(range(sel[0], sel[0] + len(sel))):
            raise AssertionError("coarse stage split is not contiguous")
        steps = tuple((j, qs[i] // qdiv) for j, i in enumerate(sel))
        groups.append((steps, E, I_rows))
        group_masks.append(_shaped_group_mask(planes, s0 + sel[0], s0 + sel[-1] + 1, E, I_rows))
    # appended (hi, lo); distances on the pre side DESCEND (high first), on
    # the post side ASCEND (low group executes first)
    if qs and qs[0] < qs[-1]:
        groups.reverse()
        group_masks.reverse()
    return tuple(groups), tuple(group_masks)


def pack_plan(plan: BenesPlan, block_log2: int = DEFAULT_BLOCK_LOG2, device="cpu") -> BenesPlanPacked:
    """Split a routed plan into coarse groups and fine stages at ``block_log2``."""
    masks = plan.masks.cpu().numpy() if isinstance(plan.masks, torch.Tensor) else np.asarray(plan.masks)
    return pack_plan_from_planes(_packbits_stages(masks), plan.dists, plan.n_in, plan.n_out, block_log2, device)


def pack_plan_from_planes(
    planes: np.ndarray, dists, n_in: int, n_out: int, block_log2: int = DEFAULT_BLOCK_LOG2, device="cpu"
) -> BenesPlanPacked:
    """Build the packed plan straight from packed stage bit-planes (the
    (ceil(S/8), N) uint8 form the plan cache stores); masks go to ``device``."""
    if block_log2 < 7:
        raise ValueError(f"block_log2={block_log2}: a block is at least one 128-slot row")
    planes = np.ascontiguousarray(planes).view(np.uint8)
    N = planes.shape[1]
    n = N.bit_length() - 1
    S = len(dists)
    if N <= (1 << block_log2):
        pre, fine, post, bs = (0, 0), (0, S), (S, S), N
    else:
        bs = 1 << block_log2
        n_coarse = n - block_log2
        pre, fine, post = (0, n_coarse), (n_coarse, S - n_coarse), (S - n_coarse, S)
    nb = N // bs
    R, C = bs // 128, 128
    pre_groups, pre_masks = _pack_side(
        pre[0], pre[1], [dists[s] // bs for s in range(*pre)], planes, nb, R, COARSE_E_CAP
    )
    post_groups, post_masks = _pack_side(
        post[0], post[1], [dists[s] // bs for s in range(*post)], planes, nb, R, COARSE_E_CAP
    )

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return build_index(BenesPlanPacked(
        fine_dists=tuple(int(dists[s]) for s in range(*fine)),
        pre_groups=pre_groups,
        post_groups=post_groups,
        fine_masks=put(_extract_planes(planes, *fine).reshape(-1, nb, R, C)),
        pre_masks=tuple(put(m) for m in pre_masks),
        post_masks=tuple(put(m) for m in post_masks),
        N=N,
        n_in=n_in,
        n_out=n_out,
        block_log2=block_log2,
    ))


def benes_plan_packed_from_numpy(
    fine_dists, pre_groups, post_groups, fine_masks, pre_masks, post_masks,
    N: int, n_in: int, n_out: int, block_log2: int, device="cpu",
) -> BenesPlanPacked:
    """The port's ``BenesPlanPacked`` from another package's leaves as numpy
    arrays and static tuples (the JAX package's packed plan), with its source
    index built here."""

    def put(a):  # a copy: another package's arrays may be read-only
        return torch.as_tensor(np.array(a, dtype=np.uint8, order="C"), device=device)

    return build_index(BenesPlanPacked(
        fine_dists=tuple(int(d) for d in fine_dists),
        pre_groups=tuple(pre_groups),
        post_groups=tuple(post_groups),
        fine_masks=put(fine_masks),
        pre_masks=tuple(put(m) for m in pre_masks),
        post_masks=tuple(put(m) for m in post_masks),
        N=int(N), n_in=int(n_in), n_out=int(n_out), block_log2=int(block_log2),
    ))


# ---------------------------------------------------------------------------
# Plain versions of the three kernels: the stages on the packed masks
# ---------------------------------------------------------------------------


def _apply_steps_reference(v: torch.Tensor, masks: torch.Tensor, steps) -> torch.Tensor:
    """Plain version shared by the three kernels: ``steps`` = ((bit, d), ...)
    in execution order, ``d`` the flat distance; ``masks`` any shape with P
    planes leading, read as (P, N)."""
    flat = masks.reshape(masks.shape[0], -1)
    for s, d in steps:
        m = (flat[s >> 3] >> (s & 7)) & 1
        v = _stage(v, m != 0, d)
    return v


def benes_fine_reference(v, fine_masks, fine_dists, reverse=False):
    """Plain K5: all fine stages on the flat (N,) vector."""
    steps = [(s, d) for s, d in enumerate(fine_dists)]
    return _apply_steps_reference(v, fine_masks, steps[::-1] if reverse else steps)


def benes_coarse_reference(v, masks, steps, E, I_rows):
    """Plain K6: one coarse group; ``steps`` in execution order, q in E units."""
    del E
    return _apply_steps_reference(v, masks, [(s, q * I_rows * 128) for s, q in steps])


def benes_coarse2_reference(v, masks, steps, E_hi, E_lo, R):
    """Plain K7: one two-axis side; q in block units."""
    del E_hi, E_lo
    return _apply_steps_reference(v, masks, [(s, q * R * 128) for s, q in steps])


SMEM_LIMIT = 227 * 1024  # bytes of shared memory one block may use on sm_90
LINE_BYTES = 128  # widest strip of the window form: one cache line of lanes
SECTOR_BYTES = 32  # narrowest strip the window form keeps a two-axis side whole for
GATHER_ROW_BYTES = 64  # lanes of a K7 strip: 64 B of payload per block position (32 B measured slower)
GATHER_STRIP_SLOTS = 1 << 15  # a K7 strip holds at most this many slots (32 a thread)
GATHER_MIN_LANES = 8  # 16 B of index per position: the narrowest TMA box row

_INT_P = ctypes.POINTER(ctypes.c_int)


@functools.lru_cache(maxsize=None)
def _c_steps(triples: tuple):
    """ctypes int arrays (planes, bits, logs) of a launch's stages."""
    n = len(triples)
    cols = list(zip(*triples)) if n else [(), (), ()]
    return n, *((ctypes.c_int * max(n, 1))(*col) for col in cols)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("benes")
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dualip_benes_fine.argtypes = [vp, vp, ll, ci, ci, ci, _INT_P, _INT_P, _INT_P, vp]
    # K6 and the window form of K7 share one entry point: a single-axis group is E_hi = 1
    lib.dualip_benes_coarse.argtypes = [vp, vp, ll, ll, ll, ll, ll, ci, ci, ci, ci, _INT_P, _INT_P, _INT_P, vp]
    lib.dualip_benes_gather_fine.argtypes = [vp, vp, ll, ci, ci, vp]
    lib.dualip_benes_gather_rows.argtypes = [vp, vp, ll, ll, ll, ll, ci, vp]
    for fn in (lib.dualip_benes_fine, lib.dualip_benes_coarse, lib.dualip_benes_gather_fine,
               lib.dualip_benes_gather_rows):
        fn.restype = ctypes.c_int
    return lib


def _check_cuda_payload(v: torch.Tensor, side: torch.Tensor, N: int, what: str) -> int:
    """Checks a payload and the tensor the kernel reads beside it (mask planes
    or a source index); returns the payload's element size."""
    if v.dim() != 1 or v.shape[0] != N:
        raise ValueError(f"{what}: payload must be flat ({N},), got {tuple(v.shape)}")
    if side.device != v.device:
        raise ValueError(f"{what}: payload on {v.device}, plan on {side.device}")
    if side.dtype not in (torch.uint8, torch.int16):
        raise TypeError(f"{what}: masks must be uint8 bit-planes, an index int16, got {side.dtype}")
    if v.element_size() not in (2, 4):
        raise TypeError(f"{what}: the kernel moves 2- or 4-byte payloads, got {v.dtype}")
    if not (v.is_contiguous() and side.is_contiguous()) or v.data_ptr() % 16 or side.data_ptr() % 16:
        raise ValueError(f"{what}: the kernel takes contiguous, 16-byte aligned tensors")
    return v.element_size()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _strip_lanes(E: int, inner: int, elem: int, planes: int, floor_bytes: int = 1) -> int:
    """Lanes W of a window-form coarse strip: at most one 128 B line, halved
    until the strip (E*W payload + planes) fits shared memory; 0 if it does
    not fit at ``floor_bytes`` of lanes."""
    W = min(inner, LINE_BYTES // elem)
    floor = max(1, min(inner, floor_bytes // elem))
    while W > floor and E * W * (elem + planes) > SMEM_LIMIT:
        W //= 2
    return W if E * W * (elem + planes) <= SMEM_LIMIT else 0


def _gather_lanes(E: int, inner: int, elem: int) -> int:
    """Lanes W of a K7 gather strip: ``GATHER_ROW_BYTES`` of payload per
    position, halved (down to 8 lanes: 16 bytes of index, the narrowest TMA
    box row) until the strip holds at most ``GATHER_STRIP_SLOTS`` slots; 0 if
    it never does.  Shared memory then holds the strip and its index: at most
    192 KB."""
    W = min(inner, GATHER_ROW_BYTES // elem)
    while W > GATHER_MIN_LANES and E * W > GATHER_STRIP_SLOTS:
        W //= 2
    return W if W >= GATHER_MIN_LANES and E * W <= GATHER_STRIP_SLOTS else 0


# ---------------------------------------------------------------------------
# Window forms: all stages of a launch in register windows, read from the
# mask planes.  K6 runs so; the fine and two-axis forms
# build the source index of the gather kernels once per plan.
# ---------------------------------------------------------------------------


def benes_fine_window(v, fine_masks, fine_dists, reverse=False):
    """The fine stages of every block in register windows (the index builder
    of K5).  In place on CUDA (returns ``v``); plain version on CPU.  Counts
    what it enqueues in the counter ``dualip.ops.benes_fine_window.enqueued``
    (``utils/profiling.py``)."""
    if v.device.type == "cpu":
        return benes_fine_reference(v, fine_masks, fine_dists, reverse)
    P, nb, R, C = fine_masks.shape
    N = nb * R * C
    elem = _check_cuda_payload(v, fine_masks, N, "benes_fine_window")
    bs_log2 = (R * C).bit_length() - 1
    if (R * C) * (elem + 1) > SMEM_LIMIT:
        raise ValueError(f"benes_fine_window: a block of 2^{bs_log2} {elem}-byte slots and one mask plane "
                         f"exceed {SMEM_LIMIT} B of shared memory; pack the plan at a smaller block_log2")
    triples = tuple((s >> 3, s & 7, d.bit_length() - 1) for s, d in enumerate(fine_dists))
    n, planes, bits, logs = _c_steps(triples[::-1] if reverse else triples)
    with torch.cuda.device(v.device):
        rc = _lib().dualip_benes_fine(
            v.data_ptr(), fine_masks.data_ptr(), N, bs_log2, elem, n, planes, bits, logs, _stream(v.device)
        )
    if rc != 0:
        raise RuntimeError(f"benes_fine_window: CUDA error {rc} at launch (N={N}, block=2^{bs_log2}, stages={n})")
    profiling.count("dualip.ops.benes_fine_window.enqueued")
    return v


def benes_coarse(v: torch.Tensor, masks: torch.Tensor, steps: tuple, E: int, I_rows: int) -> torch.Tensor:
    """K6: all stages of one single-axis coarse group, exchanging along E of
    the (O, E, I_rows, 128) view; ``steps`` = ((bit, q), ...) in execution
    order.  In place on CUDA (returns ``v``); plain version on CPU.  Counts
    launches in the counter ``dualip.ops.benes_coarse.enqueued``: a CUDA
    graph's capture enqueues once, and a replay calls no wrapper."""
    if v.device.type == "cpu":
        return benes_coarse_reference(v, masks, steps, E, I_rows)
    if v.device.type != "cuda":
        raise ValueError(f"benes_coarse runs on cuda or cpu tensors, got {v.device}")
    P = masks.shape[0]
    N = masks.numel() // P
    elem = _check_cuda_payload(v, masks, N, "benes_coarse")
    inner = I_rows * 128
    W = _strip_lanes(E, inner, elem, P)
    if not W:
        raise ValueError(f"benes_coarse: a strip of E={E} positions does not fit shared memory")
    n, planes, bits, logs = _c_steps(tuple((s >> 3, s & 7, q.bit_length() - 1) for s, q in steps))
    with torch.cuda.device(v.device):
        rc = _lib().dualip_benes_coarse(
            v.data_ptr(), masks.data_ptr(), N, 1, E, inner, W, 2, P, elem, n, planes, bits, logs, _stream(v.device)
        )
    if rc != 0:
        raise RuntimeError(f"benes_coarse: CUDA error {rc} at launch (N={N}, E={E}, W={W}, stages={n})")
    profiling.count("dualip.ops.benes_coarse.enqueued")
    return v


def benes_coarse2_window(v, masks, steps, E_hi, E_lo, R):
    """The stages of one two-axis coarse side (or any run of them) in
    register windows on the (O2, E_hi, E_lo, R*128) view (the index builder
    of K7): one launch when the whole side fits shared memory at one 32 B
    sector of lanes, else one launch per run of stages on one axis.  In place
    on CUDA (returns ``v``); plain version on CPU.  Counts kernel launches in
    the counter ``dualip.ops.benes_coarse2_window.enqueued``."""
    if v.device.type == "cpu":
        return benes_coarse2_reference(v, masks, steps, E_hi, E_lo, R)
    P = masks.shape[0]
    N = masks.numel() // P
    elem = _check_cuda_payload(v, masks, N, "benes_coarse2_window")
    inner = R * 128
    lo_log = E_lo.bit_length() - 1
    W = _strip_lanes(E_hi * E_lo, inner, elem, P, floor_bytes=SECTOR_BYTES)
    if W:
        launches = [(2, W, tuple((s >> 3, s & 7, q.bit_length() - 1) for s, q in steps))]
    else:  # runs of consecutive stages on one axis, each a launch of its own
        launches = []
        for s, q in steps:
            axis = 1 if q >= E_lo else 0
            triple = (s >> 3, s & 7, q.bit_length() - 1 - (lo_log if axis else 0))
            if launches and launches[-1][0] == axis:
                launches[-1][2].append(triple)
            else:
                Wa = _strip_lanes(E_hi if axis else E_lo, inner, elem, P)
                if not Wa:
                    raise ValueError(f"benes_coarse2_window: an axis of ({E_hi}, {E_lo}) does not fit shared memory")
                launches.append((axis, Wa, [triple]))
        launches = [(axis, Wa, tuple(tr)) for axis, Wa, tr in launches]
    with torch.cuda.device(v.device):
        for axis, Wa, triples in launches:
            n, planes, bits, logs = _c_steps(triples)
            rc = _lib().dualip_benes_coarse(
                v.data_ptr(), masks.data_ptr(), N, E_hi, E_lo, inner, Wa, axis, P, elem,
                n, planes, bits, logs, _stream(v.device),
            )
            if rc != 0:
                raise RuntimeError(f"benes_coarse2_window: CUDA error {rc} at launch "
                                   f"(N={N}, E=({E_hi}, {E_lo}), axis={axis}, W={Wa})")
            profiling.count("dualip.ops.benes_coarse2_window.enqueued")
    return v


# ---------------------------------------------------------------------------
# The source index
# ---------------------------------------------------------------------------


def coarse2_launches(steps: tuple, E_hi: int, E_lo: int) -> tuple:
    """The gather launches of a two-axis side, forward order: ``((axis,
    steps), ...)``.  One launch (axis 2, the block position e = e_hi*E_lo +
    e_lo) while a strip of all E_hi*E_lo positions at the fewest lanes fits
    (``_gather_lanes``; up to 4096 positions); else one launch per run of
    consecutive stages on one axis (1: E_hi, 0: E_lo).  The rule does not
    depend on the payload type, so one index serves fp32 and bf16."""
    if E_hi * E_lo * GATHER_MIN_LANES <= GATHER_STRIP_SLOTS:
        return ((2, tuple(steps)),)
    runs = []
    for s, q in steps:
        axis = 1 if q >= E_lo else 0
        if runs and runs[-1][0] == axis:
            runs[-1][1].append((s, q))
        else:
            runs.append((axis, [(s, q)]))
    return tuple((axis, tuple(st)) for axis, st in runs)


def _axis_view(axis: int, E_hi: int, E_lo: int, R: int) -> tuple:
    """(E, inner) of the (O, E, inner) view a gather launch permutes along E."""
    inner = R * 128
    return {2: (E_hi * E_lo, inner), 1: (E_hi, E_lo * inner), 0: (E_lo, inner)}[axis]


def _as_index(pos: torch.Tensor) -> torch.Tensor:
    """Positions in [0, 2^16) as int16 bits (the kernels read them as uint16)."""
    pos = pos.to(torch.int32)
    return (pos - ((pos >> 15) << 16)).to(torch.int16)


def index_values(idx: torch.Tensor) -> torch.Tensor:
    """An index's positions as int64, for indexing."""
    return idx.to(torch.int64) & 0xFFFF


@profiling.timed("dualip.build.index")
def build_index(plan: BenesPlanPacked, plain: bool = False) -> BenesPlanPacked:
    """Fills the plan's source index in place and returns the plan.

    A gather launch's permutation is found by running its stages on an iota:
    slot i then holds the flat slot it reads from.  Forward and reverse are
    both such runs (the stages in reverse order give the inverse), two
    gathers, never a scatter.  On a CUDA plan the window kernels run them
    (``benes_fine_window``, ``benes_coarse2_window``: 4-byte payloads of any
    type); on a CPU plan, or with ``plain=True``, the plain stages.  The
    build, synchronised on the card, is the span ``dualip.build.index``."""
    P, nb, R, C = plan.fine_masks.shape
    bs = R * C
    if bs > 1 << 16:
        raise ValueError(f"a block of {bs} slots: the 16-bit source index needs block_log2 <= 16")
    if plan.N >= 1 << 31:
        raise ValueError(f"N={plan.N}: the index is built on an int32 iota")
    dev = plan.fine_masks.device
    on_card = dev.type == "cuda" and not plain
    fine_fn = benes_fine_window if on_card else benes_fine_reference
    coarse_fn = benes_coarse2_window if on_card else benes_coarse2_reference

    def iota():
        return torch.arange(plan.N, dtype=torch.int32, device=dev)

    plan.fine_src_fwd, plan.fine_src_rev = (
        _as_index(fine_fn(iota(), plan.fine_masks, plan.fine_dists, rev) & (bs - 1)) for rev in (False, True)
    )

    def side(groups, masks):
        out = []
        for (steps, E, R_g), m in zip(groups, masks):
            if not isinstance(E, tuple):
                out.append(None)
                continue
            launches = []
            for axis, st in coarse2_launches(steps, *E):
                En, inner = _axis_view(axis, *E, R_g)
                shift = inner.bit_length() - 1
                fwd, rev = (_as_index((coarse_fn(iota(), m, s, *E, R_g) >> shift) & (En - 1))
                            for s in (st, st[::-1]))
                launches.append((axis, fwd, rev))
            out.append(tuple(launches))
        return tuple(out)

    plan.pre_src = side(plan.pre_groups, plan.pre_masks)
    plan.post_src = side(plan.post_groups, plan.post_masks)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return plan


def index_tensors(plan: BenesPlanPacked) -> list:
    """Every index tensor of the plan, in a fixed order (``None`` where one is
    missing): fine forward and reverse, then each two-axis launch's pair."""
    out = [plan.fine_src_fwd, plan.fine_src_rev]
    for groups, srcs in ((plan.pre_groups, plan.pre_src), (plan.post_groups, plan.post_src)):
        for i, (_, E, _) in enumerate(groups):
            if not isinstance(E, tuple):
                continue
            entry = srcs[i] if srcs is not None else None
            out.extend([None, None] if entry is None else [t for _, f, r in entry for t in (f, r)])
    return out


def index_bytes(plan: BenesPlanPacked) -> int:
    return sum(t.numel() * t.element_size() for t in index_tensors(plan) if t is not None)


def require_index(plan: BenesPlanPacked) -> None:
    """Refuses a plan without its source index: the gather kernels need it,
    and nothing falls back to the window form or the plain stages."""
    if any(t is None for t in index_tensors(plan)):
        raise ValueError("this packed plan has no source index; build it with build_index(plan) "
                         "(pack_plan and benes_plan_packed_from_numpy do)")


# ---------------------------------------------------------------------------
# The gather kernels' wrappers (K5, K7), each beside its plain version
# ---------------------------------------------------------------------------


def _check_index(src, what: str) -> None:
    if src is None:
        raise ValueError(f"{what}: no source index for a CUDA payload (build_index); the kernel is a gather")
    if src.dtype != torch.int16:
        raise TypeError(f"{what}: the source index is int16 bits, got {src.dtype}")


def benes_fine(v: torch.Tensor, fine_masks: torch.Tensor, fine_dists: tuple, reverse: bool = False,
               src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5: all fine stages (distance < block) of every block.  On a CUDA
    tensor one gather kernel, in place, through ``src`` (the plan's
    ``fine_src_rev`` for ``reverse``, else ``fine_src_fwd``), and ``v`` is
    returned; on a CPU tensor the plain stages return a new tensor.  Counts
    launches in the counter ``dualip.ops.benes_fine.enqueued``: a CUDA
    graph's capture enqueues once, and a replay calls no wrapper."""
    if v.device.type == "cpu":
        return benes_fine_reference(v, fine_masks, fine_dists, reverse)
    if v.device.type != "cuda":
        raise ValueError(f"benes_fine runs on cuda or cpu tensors, got {v.device}")
    _check_index(src, "benes_fine")
    P, nb, R, C = fine_masks.shape
    N = nb * R * C
    elem = _check_cuda_payload(v, src, N, "benes_fine")
    if src.shape != (N,):
        raise ValueError(f"benes_fine: index of shape {tuple(src.shape)} for {N} slots")
    bs_log2 = (R * C).bit_length() - 1
    if (R * C) * elem > SMEM_LIMIT:
        raise ValueError(f"benes_fine: a block of 2^{bs_log2} {elem}-byte slots exceeds {SMEM_LIMIT} B "
                         "of shared memory; pack the plan at a smaller block_log2")
    with torch.cuda.device(v.device):
        rc = _lib().dualip_benes_gather_fine(v.data_ptr(), src.data_ptr(), N, bs_log2, elem, _stream(v.device))
    if rc != 0:
        raise RuntimeError(f"benes_fine: CUDA error {rc} at launch (N={N}, block=2^{bs_log2})")
    profiling.count("dualip.ops.benes_fine.enqueued")
    return v


def benes_coarse2(v: torch.Tensor, masks: torch.Tensor, steps: tuple, E_hi: int, E_lo: int, R: int,
                  src: Optional[tuple] = None) -> torch.Tensor:
    """K7: all stages of one two-axis coarse side on the (O2, E_hi, E_lo,
    R*128) view; ``steps`` = ((bit, q), ...) in execution order, q in block
    units (q >= E_lo exchanges along E_hi).  On a CUDA tensor one gather
    kernel per entry of ``src`` = ((axis, index), ...), in execution order
    (``coarse2_launches``; each strip holds all positions of its axis and a
    few lanes), in place, returning ``v``; on a CPU tensor the plain stages.
    Counts kernel launches in the counter ``dualip.ops.benes_coarse2.enqueued``:
    a CUDA graph's capture enqueues once, and a replay calls no wrapper."""
    if v.device.type == "cpu":
        return benes_coarse2_reference(v, masks, steps, E_hi, E_lo, R)
    if v.device.type != "cuda":
        raise ValueError(f"benes_coarse2 runs on cuda or cpu tensors, got {v.device}")
    if not src:
        raise ValueError("benes_coarse2: no source index for a CUDA payload (build_index); the kernel is a gather")
    N = v.shape[0]
    for axis, idx in src:
        _check_index(idx, "benes_coarse2")
        elem = _check_cuda_payload(v, idx, idx.numel(), "benes_coarse2")
        E, inner = _axis_view(axis, E_hi, E_lo, R)
        W = _gather_lanes(E, inner, elem)
        if not W or N % (E * inner):
            raise ValueError(f"benes_coarse2: a strip of E={E} positions does not fit shared memory (N={N})")
        with torch.cuda.device(v.device):
            rc = _lib().dualip_benes_gather_rows(v.data_ptr(), idx.data_ptr(), N, E, inner, W, elem,
                                                 _stream(v.device))
        if rc != 0:
            raise RuntimeError(f"benes_coarse2: CUDA error {rc} at launch (N={N}, E={E}, inner={inner}, W={W})")
        profiling.count("dualip.ops.benes_coarse2.enqueued")
    return v


def _direction(src: Optional[tuple], reverse: bool) -> Optional[tuple]:
    """A two-axis group's ((axis, index), ...) in execution order."""
    if src is None:
        return None
    return tuple((a, r) for a, _, r in reversed(src)) if reverse else tuple((a, f) for a, f, _ in src)


def apply_butterfly_cuda(
    plan: "BenesPlan | BenesPlanPacked",
    x: torch.Tensor,
    reverse: bool = False,
    block_log2: int = DEFAULT_BLOCK_LOG2,
    truncate: bool = True,
) -> torch.Tensor:
    """Blocked application (``apply_butterfly_tpu`` of the JAX package): the
    pre-side coarse groups, the fine stages, the post-side coarse groups.
    ``reverse`` swaps the sides, reverses the group order within a side and
    the steps within a group, on the same masks, and reads the reverse index.

    On a CUDA tensor the kernels work in place: an ``x`` of the full padded
    length N is overwritten and returned (no second N-sized buffer); a shorter
    ``x`` is first copied into a zero-padded buffer.  Pass a ``BenesPlanPacked``
    on ``x``'s device; it must carry its source index (``require_index``).
    Packing a ``BenesPlan`` here costs a host pass over the masks and an index
    build on every call."""
    if not isinstance(plan, BenesPlanPacked):
        plan = pack_plan(plan, block_log2=block_log2, device=x.device)
    if x.device.type == "cuda":
        require_index(plan)
    v = _pad_to(x, plan.N)

    def groups(gs, ms, srcs):
        return list(zip(gs, ms, srcs if srcs is not None else (None,) * len(gs)))

    pre = groups(plan.pre_groups, plan.pre_masks, plan.pre_src)
    post = groups(plan.post_groups, plan.post_masks, plan.post_src)
    if reverse:
        pre, post = (
            [((steps[::-1], E, I), m, s) for (steps, E, I), m, s in reversed(post)],
            [((steps[::-1], E, I), m, s) for (steps, E, I), m, s in reversed(pre)],
        )

    def coarse(v, side):
        for (steps, E, I_rows), m, src in side:
            if isinstance(E, tuple):  # two-axis side
                v = benes_coarse2(v, m, steps, E[0], E[1], I_rows, _direction(src, reverse))
            else:
                v = benes_coarse(v, m, steps, E, I_rows)
        return v

    v = coarse(v, pre)
    v = benes_fine(v, plan.fine_masks, plan.fine_dists, reverse, plan.fine_src_rev if reverse else plan.fine_src_fwd)
    v = coarse(v, post)
    if not truncate:
        return v
    return v[: (plan.n_in if reverse else plan.n_out)]
