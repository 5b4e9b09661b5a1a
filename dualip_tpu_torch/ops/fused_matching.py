"""The fused matching kernels and their plain PyTorch versions: the tile
kernel (K1/K2) of the csc layout and the panel kernel (K3/K4) of the butterfly
layout.

Port of ``dualip_tpu/ops/pallas_matching.py::fused_tile_eval_T``
(``_fused_kernel`` / ``_fused_kernel_x`` with the device function
``_project_block``).  Per ``(L, K)``-transposed tile:

    z = a * lam_g + neg_inv_gamma * c  ->  x = Proj(z) along L  ->  mask
    ->  a*x,  sum(c*x),  sum(x*x)   (and x itself with ``want_x``)

``fused_tile_gather_eval_T`` (the objective's) takes ``scaled =
-lambda/gamma`` and the tile's rows and gathers inside the kernel.
``fused_tile_eval_T`` keeps the TPU kernel's contract, ``lam_g =
(-lambda/gamma)[rows]`` gathered by the caller as the JAX package leaves it to
XLA: it runs the gather form on ``scaled = lam_g`` and rows ``0 .. L*K - 1``,
which gathers ``lam_g`` itself, so the two give the same bits.  The caller
segment-sums ``a*x`` by row.

On CUDA tensors the wrappers launch the hand-written kernel of
``csrc/fused_matching.cu`` or raise; on CPU tensors they run
``fused_tile_eval_T_reference``, a step-by-step transcription of the TPU
kernel that the tests hold against the JAX package (the gather form on
``scaled[rows]``).  The simplex and
box-cut kinds run ``BISECTION_ITERS = 30`` bisection steps, as the TPU
kernel does (the registry's jnp/torch projections run 50).

``fused_panel_project`` is the port of ``fused_panel_project`` there
(``_panel_kernel`` / ``_panel_kernel_x``): one tile's region of the (N,) carry
buffer, in panel layout, is read as srow, projected and overwritten with
``a*x`` in place.  ``fused_panel_project_tiles`` does the same for every tile
of a layout in one launch, from a ``PanelTable`` built once per layout
(``build_panel_table``); the objective calls it.  On a CUDA tensor both launch
``csrc/panel_matching.cu`` or raise; on a CPU tensor they run
``fused_panel_project_reference`` (tile by tile).  They share the projection
with K1/K2 (``csrc/project_block.cuh`` on the card,
``_project_block_reference`` here).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dualip_tpu_torch.ops import _build
from dualip_tpu_torch.utils import profiling
from dualip_tpu_torch.projections.base import project

DEFAULT_BLOCK_K = 1024
BISECTION_ITERS = 30

# Must match csrc/fused_matching.cu.
_THREADS = 256  # columns per slab (one partial each) of the per-column kernels
REG_L_CAP = 64  # largest L whose column the per-column kernel keeps in registers
_WIDE_WARPS = 8  # columns per group (one partial each, one warp a column) above REG_L_CAP
_WARP_L_CAP = 512  # largest L a warp projects (16 lanes a thread in registers); above, a block a column
_BLOCK_REGS, _BLOCK_REGS_LONG, _BLOCK_MAX = 8, 16, 1024  # a block's lanes a thread in registers; its threads
_SMEM_LIMIT = 226 * 1024  # bytes of shared memory a block may keep a column's lanes in
_KIND_CODE = {"identity": 0, "box": 0, "cone": 0, "simplex": 1, "simplex_eq": 1, "box_cut": 2, "box_cut_eq": 2}


class K1Path(NamedTuple):
    """How the tile kernel projects a column of a tile of L lanes."""

    path: str  # "thread", "warp" or "block": what projects one column
    threads: int  # threads a column
    keep: str  # where a column's lanes stay between passes: "registers", "shared memory" or "device memory"


def _block_rule(L: int) -> K1Path:
    """A block a column of L lanes (``csrc/project_block.cuh``'s
    ``block_threads``, ``block_keep``): the fewest threads (a power of two,
    at most 1024) that hold the lanes at 8 a thread, then at 16 a thread of
    1024 threads, then in the block's shared memory, then nowhere (every pass
    forms z again)."""
    threads = 32
    while threads < _BLOCK_MAX and threads * _BLOCK_REGS < L:
        threads *= 2
    if L <= threads * _BLOCK_REGS_LONG:
        keep = "registers"
    else:
        keep = "shared memory" if 4 * L <= _SMEM_LIMIT else "device memory"
    return K1Path("block", threads, keep)


def k1_path(kind: str, L: int) -> K1Path:
    """The rule of ``csrc/fused_matching.cu`` (``launch_projection``,
    ``wide_threads``): the elementwise kinds and L <= 64 a thread a column;
    simplex and box_cut to L = 512 a warp; above, a block (``_block_rule``)."""
    if _KIND_CODE[kind] == 0 or L <= REG_L_CAP:
        return K1Path("thread", 1, "registers")
    if L <= _WARP_L_CAP:
        return K1Path("warp", 32, "registers")
    return _block_rule(L)


def _project_block_reference(
    z: torch.Tensor, kind: str, params: dict, length: torch.Tensor, L: int, axis: int = 0
) -> torch.Tensor:
    """``_project_block``: project along ``axis`` (the L lanes) and mask.
    Layouts: (L, K) with axis 0 and ``length`` (K,), or panel blocks
    (KP, L, 128) / (KP, q, L, 128) with ``length`` shaped to broadcast with
    the L axis kept."""
    dtype, dev = z.dtype, z.device
    lane_shape = [1] * z.dim()
    lane_shape[axis] = L
    if axis == 0 and length.dim() == 1:
        length = length.reshape(1, -1)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def const(v):
        return torch.full((), v, dtype=dtype, device=dev)

    if kind in ("identity", "box", "cone"):
        x = project(kind, **params)(z)
    elif kind in ("simplex", "simplex_eq"):
        radius = const(params.get("z", 1.0))
        tol = const(1e-6)
        v = torch.maximum(z, zero)
        vn = v / radius
        v_max = torch.amax(vn, dim=axis, keepdim=True)
        v_shift = vn - v_max
        lo = torch.full(v_max.shape, -1.0, dtype=dtype, device=dev)
        hi = torch.zeros(v_max.shape, dtype=dtype, device=dev)
        for _ in range(BISECTION_ITERS):
            mid = (lo + hi) * 0.5
            s = torch.sum(torch.maximum(v_shift - mid, zero), dim=axis, keepdim=True)
            too_high = s > 1.0
            lo, hi = torch.where(too_high, mid, lo), torch.where(too_high, hi, mid)
        nu = (lo + hi) * 0.5
        w = torch.maximum(v_shift - nu, zero) * radius
        if L > 1:
            # top-2 vertex shortcut; argmax takes the first maximum
            i0 = torch.argmax(vn, dim=axis, keepdim=True)
            lane = torch.arange(L, device=dev).view(lane_shape)
            masked = torch.where(lane == i0, const(-torch.inf), vn)
            v1 = torch.amax(masked, dim=axis, keepdim=True)
            shortcut = (v_max - v1) > 1.0
            onehot = torch.where(lane == i0, radius, zero)
            w = torch.where(shortcut, onehot, w)
        if kind == "simplex":  # inequality: feasible columns pass through
            feasible = torch.sum(v, dim=axis, keepdim=True) <= radius + tol
            w = torch.where(feasible, v, w)
        x = w
    elif kind in ("box_cut", "box_cut_eq"):
        op = project(kind, **params)  # the registry parses and checks the bounds
        lt, ut, zcut, tol = const(op.lower), const(op.upper), const(op.z), const(1e-6)

        def clip(t):
            return torch.minimum(torch.maximum(t, lt), ut)

        lo = torch.amin(z, dim=axis, keepdim=True) - ut
        hi = torch.amax(z, dim=axis, keepdim=True) - lt
        for _ in range(BISECTION_ITERS):
            mid = (lo + hi) * 0.5
            s = torch.sum(clip(z - mid), dim=axis, keepdim=True)
            too_high = s > zcut
            lo, hi = torch.where(too_high, mid, lo), torch.where(too_high, hi, mid)
        nu = (lo + hi) * 0.5
        w = clip(z - nu)
        if kind == "box_cut":  # inequality: box-feasible columns pass through
            clipped = clip(z)
            feasible = torch.sum(clipped, dim=axis, keepdim=True) <= zcut + tol
            w = torch.where(feasible, clipped, w)
        x = w
    else:
        raise ValueError(f"Unsupported projection kind {kind!r}")

    lane = torch.arange(L, device=dev, dtype=torch.int32).view(lane_shape)
    return torch.where(lane < length, x, zero)


def fused_tile_eval_T_reference(
    lam_g_T: torch.Tensor,
    a_T: torch.Tensor,
    c_T: torch.Tensor,
    length: torch.Tensor,
    neg_inv_gamma,
    kind: str,
    params_tuple: Tuple = (),
    want_x: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The plain version of the kernel: ``(ax_T, obj, reg[, x_T])``."""
    L = a_T.shape[0]
    nig = torch.as_tensor(neg_inv_gamma, dtype=torch.float32, device=a_T.device)
    z = a_T * lam_g_T + nig * c_T
    x = _project_block_reference(z, kind, dict(params_tuple), length, L)
    ax = a_T * x
    obj = torch.sum(c_T * x).to(torch.float32)
    reg = torch.sum(x * x).to(torch.float32)
    return (ax, obj, reg, x) if want_x else (ax, obj, reg)


def _kernel_params(kind: str, params: dict):
    """(kind code, inequality, lo, hi, has_lo, has_hi, radius) for the kernel."""
    code = _KIND_CODE.get(kind)
    if code is None:
        raise ValueError(f"Unsupported projection kind {kind!r}")
    if code == 0:
        op = project(kind, **params)
        lo, hi = getattr(op, "lower", None), getattr(op, "upper", None)
        return code, 0, lo or 0.0, hi or 0.0, lo is not None, hi is not None, 1.0
    if code == 1:
        return code, int(kind == "simplex"), 0.0, 0.0, False, False, params.get("z", 1.0)
    op = project(kind, **params)
    return code, int(kind == "box_cut"), op.lower, op.upper, True, True, op.z


def num_partial_blocks(kind: str, L: int, K: int) -> int:
    """Partial (obj, reg) pairs of the kernel's launch: one per ``_THREADS``
    columns (a thread a column), one per ``_WIDE_WARPS`` columns (a warp a
    column), or one a column (a block a column; ``k1_path``)."""
    path = k1_path(kind, L).path
    if path == "block":
        return K
    if path == "warp":
        return -(-K // _WIDE_WARPS)
    return -(-K // _THREADS)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("fused_matching").dualip_fused_tile_eval
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp, vp, ci] + [vp] * 8 + [ci] * 6 + [cf, cf, ci, ci, cf, vp]
    fn.restype = ci
    return fn


def _check_tile(a_T, others, length, block_k):
    if a_T.dim() != 2:
        raise ValueError(f"a_T must be (L, K), got shape {tuple(a_T.shape)}")
    L, K = a_T.shape
    for name, t in others:
        if t.shape != a_T.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != a_T shape {tuple(a_T.shape)}")
    if tuple(length.shape) != (K,):
        raise ValueError(f"length must be ({K},), got {tuple(length.shape)}")
    if block_k <= 0 or K % block_k != 0:
        raise ValueError(f"K={K} not divisible by block_k={block_k}")


def _launch(rows_T, scaled, a_T, c_T, length, neg_inv_gamma, kind, params_tuple, want_x, out):
    """Launch the tile kernel on CUDA tensors."""
    dev = a_T.device
    L, K = a_T.shape
    if dev.type != "cuda":
        raise ValueError(f"the fused tile kernel runs on cuda or cpu tensors, got {dev}")
    if a_T.dtype != torch.float32 or c_T.dtype != torch.float32:
        raise TypeError("the fused kernel takes float32 a_T and c_T")
    if length.dtype != torch.int32:
        raise TypeError("length must be int32")
    if not all(t.is_contiguous() for t in (rows_T, scaled, a_T, c_T, length)):
        raise ValueError("the fused kernel takes contiguous tensors")
    if out is None:
        out_ax = torch.empty_like(a_T)
    elif out.shape != a_T.shape or out.dtype != torch.float32 or out.device != dev or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous float32 ({L}, {K}) tensor on {dev}")
    else:
        out_ax = out
    code, ineq, lo, hi, has_lo, has_hi, radius = _kernel_params(kind, dict(params_tuple))
    if isinstance(neg_inv_gamma, torch.Tensor):
        nig = neg_inv_gamma.to(device=dev, dtype=torch.float32).reshape(())
    else:
        nig = torch.full((), float(neg_inv_gamma), dtype=torch.float32, device=dev)

    nb = num_partial_blocks(kind, L, K)
    x = torch.empty_like(a_T) if want_x else None
    partials = torch.empty((nb, 2), dtype=torch.float32, device=dev)
    sums = torch.empty(2, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _kernel()(
            rows_T.data_ptr(), scaled.data_ptr(), scaled.numel(),
            a_T.data_ptr(), c_T.data_ptr(), length.data_ptr(), nig.data_ptr(),
            out_ax.data_ptr(), x.data_ptr() if want_x else None, partials.data_ptr(), sums.data_ptr(),
            L, K, nb, code, int(want_x), ineq,
            lo, hi, int(has_lo), int(has_hi), radius, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused tile kernel: CUDA error {rc} at launch (kind={kind}, L={L}, K={K})")
    return (out_ax, sums[0], sums[1], x) if want_x else (out_ax, sums[0], sums[1])


def fused_tile_eval_T(
    lam_g_T: torch.Tensor,
    a_T: torch.Tensor,
    c_T: torch.Tensor,
    length: torch.Tensor,
    neg_inv_gamma,
    kind: str,
    params_tuple: Tuple = (),
    block_k: int = DEFAULT_BLOCK_K,
    want_x: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Evaluate one (L, K)-transposed tile: ``(a*x, sum(c*x), sum(x*x))``,
    plus ``x`` with ``want_x=True``.  ``obj``/``reg`` are 0-d fp32 tensors on
    the tile's device; ``neg_inv_gamma`` is a float or a 0-d tensor (a CUDA
    tensor is read by the kernel on the card, with no host sync).  The TPU
    kernel's contract: ``lam_g_T`` is gathered by the caller.

    Runs ``fused_tile_gather_eval_T`` on ``scaled = lam_g_T`` flattened and
    rows ``0 .. L*K - 1``, which gathers ``lam_g_T`` back bit for bit (the
    kernel's gather index is an int32, so L*K must stay below 2**31); its
    launches count in that wrapper's counters.
    """
    _check_tile(a_T, (("lam_g_T", lam_g_T), ("c_T", c_T)), length, block_k)
    if any(t.device != a_T.device for t in (lam_g_T, c_T, length)):
        raise ValueError("lam_g_T, a_T, c_T and length must be on one device")
    L, K = a_T.shape
    if L * K >= 2**31:
        raise ValueError(f"a ({L}, {K}) tile has {L * K} slots: the kernel indexes lam_g_T by int32, below 2**31")
    if a_T.device.type != "cpu":
        if lam_g_T.dtype != torch.float32:
            raise TypeError("the fused kernel takes a float32 lam_g_T")
        if not lam_g_T.is_contiguous():
            raise ValueError("the fused kernel takes contiguous tensors")
    iota = torch.arange(L * K, dtype=torch.int32, device=a_T.device).view(L, K)
    return fused_tile_gather_eval_T(lam_g_T.reshape(-1), iota, a_T, c_T, length, neg_inv_gamma, kind, params_tuple,
                                    block_k=block_k, want_x=want_x)


def fused_tile_gather_eval_T_reference(
    scaled: torch.Tensor,
    rows_T: torch.Tensor,
    a_T: torch.Tensor,
    c_T: torch.Tensor,
    length: torch.Tensor,
    neg_inv_gamma,
    kind: str,
    params_tuple: Tuple = (),
    want_x: bool = False,
    out: torch.Tensor = None,
) -> Tuple[torch.Tensor, ...]:
    """The plain version of the gather form: the plain kernel on
    ``lam_g = scaled[rows]``, with ``a*x`` copied into ``out`` when given."""
    lam_g = scaled.index_select(0, rows_T.reshape(-1).long()).view(rows_T.shape)
    res = fused_tile_eval_T_reference(lam_g, a_T, c_T, length, neg_inv_gamma, kind, params_tuple, want_x)
    if out is None:
        return res
    return (out.copy_(res[0]),) + tuple(res[1:])


def fused_tile_gather_eval_T(
    scaled: torch.Tensor,
    rows_T: torch.Tensor,
    a_T: torch.Tensor,
    c_T: torch.Tensor,
    length: torch.Tensor,
    neg_inv_gamma,
    kind: str,
    params_tuple: Tuple = (),
    block_k: int = DEFAULT_BLOCK_K,
    want_x: bool = False,
    out: torch.Tensor = None,
) -> Tuple[torch.Tensor, ...]:
    """``fused_tile_eval_T`` with the lambda gather folded in: the kernel
    reads ``scaled`` (m,) float32 and the tile's ``rows_T`` (L, K) int32 and
    forms ``lam_g = scaled[rows]`` itself, giving the same bits as the plain
    version on ``scaled[rows]``.  ``rows_T`` must hold rows below m (the tile
    builder's do; the kernel does not check).  ``out`` (L, K) float32, when
    given, receives ``a*x`` (a view into a larger buffer serves).

    Counts launches in the counters ``dualip.ops.fused_tile_gather_eval_T.enqueued``
    (K1) and ``.enqueued_x`` (K2), and in ``.block_columns`` those that
    project a column by a block: a CUDA graph's capture enqueues once, and a
    replay calls no wrapper; CPU calls count nothing."""
    _check_tile(a_T, (("rows_T", rows_T), ("c_T", c_T)), length, block_k)
    if scaled.dim() != 1:
        raise ValueError(f"scaled must be (m,), got shape {tuple(scaled.shape)}")
    if any(t.device != a_T.device for t in (scaled, rows_T, c_T, length)):
        raise ValueError("scaled, rows_T, a_T, c_T and length must be on one device")
    if a_T.device.type == "cpu":
        return fused_tile_gather_eval_T_reference(
            scaled, rows_T, a_T, c_T, length, neg_inv_gamma, kind, params_tuple, want_x, out)
    if scaled.dtype != torch.float32 or rows_T.dtype != torch.int32:
        raise TypeError("the gather form takes a float32 scaled and int32 rows_T")
    res = _launch(rows_T, scaled, a_T, c_T, length, neg_inv_gamma, kind, params_tuple, want_x, out)
    profiling.count("dualip.ops.fused_tile_gather_eval_T.enqueued_x" if want_x
                    else "dualip.ops.fused_tile_gather_eval_T.enqueued")
    if k1_path(kind, a_T.shape[0]).path == "block":
        profiling.count("dualip.ops.fused_tile_gather_eval_T.block_columns")
    return res


# ---------------------------------------------------------------------------
# K3/K4: the panel kernel of the butterfly layout
# ---------------------------------------------------------------------------


def _panel_geometry(a_p: torch.Tensor, pack):
    """(KP, L, L2, q) of a panel tile; ``pack`` = (L, L2, q) on the compact
    packing, else one column per power-of-two buffer row."""
    KP, QL, C = a_p.shape
    if C != 128:
        raise ValueError(f"panel tiles are (KP, q*L, 128), got {tuple(a_p.shape)}")
    if pack is not None:
        L, L2, q = pack
        if QL != q * L:
            raise ValueError(f"packed tile shape {tuple(a_p.shape)} vs pack {pack}")
    else:
        L, q = QL, 1
        L2 = 1 << max(L - 1, 0).bit_length() if L > 1 else 1
    return KP, L, L2, q


def fused_panel_project_reference(
    buf: torch.Tensor,
    a_p: torch.Tensor,
    c_p: torch.Tensor,
    len_p: torch.Tensor,
    off: int,
    kind: str,
    params_tuple: Tuple = (),
    want_x: bool = False,
    neg_inv_gamma=None,
    pack: Tuple = None,
) -> Tuple[torch.Tensor, ...]:
    """The plain version of the panel kernel: ``(buf, obj, reg[, x])``, with
    the tile's region of ``buf`` overwritten in place."""
    KP, L, L2, q = _panel_geometry(a_p, pack)
    C = 128
    region = buf[off : off + KP * L2 * C].view(KP, L2, C)
    s = region[:, : q * L, :]
    # the TPU kernel's rule (_panel_body): fp32 when srow or a is bf16
    compute = torch.float32 if torch.bfloat16 in (s.dtype, a_p.dtype) else s.dtype
    s = s.to(compute)
    a, c = a_p.to(compute), c_p.to(compute)
    nig = torch.as_tensor(neg_inv_gamma, device=buf.device).to(compute)
    z = a * s + nig * c
    params = dict(params_tuple)
    if q == 1:
        x = _project_block_reference(z, kind, params, len_p, L, axis=1)
    else:
        x = _project_block_reference(z.view(KP, q, L, C), kind, params, len_p[:, :, None, :], L, axis=2)
        x = x.reshape(KP, q * L, C)
    region[:, : q * L, :] = (a * x).to(buf.dtype)
    if L2 > q * L:
        region[:, q * L :, :] = 0
    obj = torch.sum(c * x).to(torch.float32)
    reg = torch.sum(x * x).to(torch.float32)
    return (buf, obj, reg, x.to(torch.float32)) if want_x else (buf, obj, reg)


_PANEL_MAX_GRID = 2048  # (obj, reg) partials of the per-device scratch

# Must match csrc/panel_matching.cu.
PANEL_RING_L_CAP = 47  # the largest L whose items go through the kernel's ring
PANEL_WARP_L_CAP = 512  # the largest L a warp projects (STRETCH_L); above, the block form
_PANEL_WIDE_COLS = 8  # columns of a work unit of an item wider than the ring

# One row of the kernel's tile table: csrc/panel_matching.cu's ``struct Tile``.
_TILE_DTYPE = np.dtype(
    [("a", np.uint64), ("c", np.uint64), ("len", np.uint64), ("off", np.int64), ("x_off", np.int64),
     ("first", np.int64), ("L", np.int32), ("L2", np.int32), ("q", np.int32), ("kind", np.int32),
     ("inequality", np.int32), ("has_lo", np.int32), ("has_hi", np.int32),
     ("lo", np.float32), ("hi", np.float32), ("radius", np.float32)],
    align=True,
)
assert _TILE_DTYPE.itemsize == 88


def _units_per_item(L: int) -> int:
    """Work units of one item in the ring's launch: 1 in the ring, 16 of 8
    columns for the warps, none above (the block form's launch takes the
    tile column by column)."""
    if L <= PANEL_RING_L_CAP:
        return 1
    return 128 // _PANEL_WIDE_COLS if L <= PANEL_WARP_L_CAP else 0


def panel_path(L: int) -> K1Path:
    """How the panel kernel projects a column of a tile of L lanes, whatever
    its kind: a thread of the ring to L = 47 (its lanes in registers to
    L = 32, read again from the ring's shared memory above), a consumer warp
    to L = 512 (registers to 128 lanes, then the warp's stretch of shared
    memory), then a block of the block form (``_block_rule``, K1's)."""
    if L <= PANEL_RING_L_CAP:
        return K1Path("thread", 1, "registers" if L <= 32 else "shared memory")
    if L <= PANEL_WARP_L_CAP:
        return K1Path("warp", 32, "registers" if L <= 128 else "shared memory")
    return _block_rule(L)


class PanelTableTile(NamedTuple):
    """One column tile of a panel table: its panel-form tensors, its region
    of the carry buffer, its projection and its place in the work units."""

    a: torch.Tensor  # (KP, q*L, 128) float32 or bfloat16
    c: torch.Tensor
    length: torch.Tensor  # (KP, q, 128) int32
    off: int  # region start in the carry buffer
    KP: int  # buffer rows
    L: int
    L2: int
    q: int
    kind: str
    params: Tuple
    pack: Optional[Tuple]  # (L, L2, q) on the compact packing, else None
    first: int  # first work unit
    x_off: int  # first slot of the tile's x in the x buffer


class PanelTable(NamedTuple):
    """Every column tile of a butterfly layout, for one launch of the panel
    kernel (``fused_panel_project_tiles``).  Built once per layout by
    ``build_panel_table`` (the butterfly objective builds its own with the
    layout).  ``rows`` is the kernel's copy of the table on the tiles' CUDA
    device (None on the CPU).

    The ring's launch takes work units: one per buffer row and segment
    (an item) of a tile whose item the kernel's ring holds, and
    ``128 / _PANEL_WIDE_COLS`` per item of a wider tile (L above
    ``PANEL_RING_L_CAP`` up to ``PANEL_WARP_L_CAP``, for every carry and tile
    type).  ``wide`` says whether the table holds such a tile: a table
    without one takes the ring's instance that has no wide path.  Each tile
    above ``PANEL_WARP_L_CAP`` (``blocks``, table order) has no unit there:
    a launch of the block form follows for each, one unit a column.
    ``panel_unit_where`` maps a unit of either back."""

    tiles: Tuple[PanelTableTile, ...]
    rows: Optional[torch.Tensor]  # (n_tiles * 96,) uint8
    device: torch.device
    tile_dtype: torch.dtype  # of every tile's a and c
    n_items: int  # work units of the ring's launch
    n_buf: int  # the end of the last region: the least buffer length
    x_slots: int  # slots of the x buffer
    wide: bool  # a tile is above PANEL_RING_L_CAP, up to PANEL_WARP_L_CAP
    blocks: Tuple[int, ...]  # the tiles above PANEL_WARP_L_CAP, a launch of the block form each


def build_panel_table(col_tiles, offsets, packs, kinds) -> PanelTable:
    """The panel table of ``col_tiles`` (each with ``a``, ``c``, ``length`` in
    panel form), their region ``offsets`` in the carry buffer, their ``packs``
    ((L, L2, q) or None each) and their ``kinds`` ((proj_type, proj_params)
    each).  a and c are float32 or bfloat16, one type for every tile.
    Raises on a tile whose shapes, types, devices or region disagree with the
    geometry, and on regions that overlap."""
    col_tiles, offsets, packs, kinds = list(col_tiles), list(offsets), list(packs), list(kinds)
    if not col_tiles or not len(col_tiles) == len(offsets) == len(packs) == len(kinds):
        raise ValueError(
            f"a panel table needs one offset, pack and kind per tile: {len(col_tiles)} tiles, "
            f"{len(offsets)} offsets, {len(packs)} packs, {len(kinds)} kinds")
    dev, tile_dtype = col_tiles[0].a.device, col_tiles[0].a.dtype
    if tile_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the panel kernel takes float32 a and c, or bfloat16 a and c; got {tile_dtype}")
    tiles, rows = [], np.zeros(len(col_tiles), dtype=_TILE_DTYPE)
    first = x_off = 0
    for i, (pt, off, pack, (kind, params)) in enumerate(zip(col_tiles, offsets, packs, kinds)):
        a, c, length = pt.a, pt.c, pt.length
        KP, L, L2, q = _panel_geometry(a, pack)
        if c.shape != a.shape:
            raise ValueError(f"tile {i}: c shape {tuple(c.shape)} != a shape {tuple(a.shape)}")
        if tuple(length.shape) != (KP, q, 128):
            raise ValueError(f"tile {i}: length must be ({KP}, {q}, 128), got {tuple(length.shape)}")
        if a.dtype != tile_dtype or c.dtype != tile_dtype or length.dtype != torch.int32:
            raise TypeError(f"tile {i}: the panel kernel takes float32 a and c, or bfloat16 a and c, one type "
                            f"for all tiles ({tile_dtype} here), and int32 length")
        if any(t.device != dev for t in (a, c, length)):
            raise ValueError(f"tile {i}: every tile's tensors must be on {dev}")
        if not all(t.is_contiguous() for t in (a, c, length)):
            raise ValueError(f"tile {i}: the panel kernel takes contiguous tensors")
        off = int(off)
        if off < 0 or off % (128 * L2):
            raise ValueError(f"tile {i}: region off={off} is not a multiple of 128*L2={128 * L2}")
        code, ineq, lo, hi, has_lo, has_hi, radius = _kernel_params(kind, dict(params))
        tiles.append(PanelTableTile(a, c, length, off, KP, L, L2, q, kind, tuple(params), pack, first, x_off))
        if dev.type == "cuda":
            if any(t.data_ptr() % 16 for t in (a, c, length)):
                raise ValueError(f"tile {i}: the bulk copies need 16-byte aligned tensors")
            rows[i] = (a.data_ptr(), c.data_ptr(), length.data_ptr(), off, x_off, first, L, L2, q, code, ineq,
                       int(has_lo), int(has_hi), lo, hi, radius)
        first += KP * q * _units_per_item(L)
        x_off += a.numel()
    spans = sorted((t.off, t.off + t.KP * t.L2 * 128) for t in tiles)
    for (_, end), (start, _) in zip(spans, spans[1:]):
        if start < end:
            raise ValueError(f"panel regions overlap: one ends at {end}, the next starts at {start}")
    table_rows = torch.from_numpy(rows.view(np.uint8).copy()).to(dev) if dev.type == "cuda" else None
    return PanelTable(
        tiles=tuple(tiles), rows=table_rows, device=dev, tile_dtype=tile_dtype, n_items=first, n_buf=spans[-1][1],
        x_slots=x_off, wide=any(panel_path(t.L).path == "warp" for t in tiles),
        blocks=tuple(i for i, t in enumerate(tiles) if panel_path(t.L).path == "block"),
    )


def panel_unit_where(table: PanelTable, unit: int) -> Tuple[int, int, int, int, int]:
    """Where work unit ``unit`` of a call lies: ``(tile index, buffer row,
    segment, first column, columns)``.  Units below ``table.n_items`` are the
    ring's launch's, the same map as the kernel's ``TileWalk`` and ``Where``
    (csrc/panel_matching.cu); then come the columns of each tile of
    ``table.blocks`` in turn, a unit a column in item order, as its launch of
    the block form numbers them (``block_columns``)."""
    n_block = sum(_panel_columns(table.tiles[i]) for i in table.blocks)
    if not 0 <= unit < table.n_items + n_block:
        raise ValueError(f"unit {unit} is not one of the call's {table.n_items + n_block}")
    if unit >= table.n_items:
        u = unit - table.n_items
        for i in table.blocks:
            t = table.tiles[i]
            if u < _panel_columns(t):
                item, col = divmod(u, 128)
                row, seg = divmod(item, t.q)
                return i, row, seg, col, 1
            u -= _panel_columns(t)
    i = max(k for k, t in enumerate(table.tiles) if t.first <= unit)
    t = table.tiles[i]
    per = _units_per_item(t.L)
    item, part = divmod(unit - t.first, per)
    row, seg = divmod(item, t.q)
    return (i, row, seg, part * _PANEL_WIDE_COLS, _PANEL_WIDE_COLS) if per > 1 else (i, row, seg, 0, 128)


def _panel_columns(t: PanelTableTile) -> int:
    """Columns of a tile, padding included: a unit each in the block form."""
    return t.KP * t.q * 128


def fused_panel_project_tiles_reference(
    buf: torch.Tensor, table: PanelTable, neg_inv_gamma, want_x: bool = False,
) -> Tuple:
    """The plain version of the all-tiles launch: the per-tile plain version
    in table order, (obj, reg) added in that order; ``x`` as one tensor per
    tile."""
    obj = reg = None
    xs = []
    for t in table.tiles:
        _, o, r, *x = fused_panel_project_reference(
            buf, t.a, t.c, t.length, t.off, t.kind, t.params, want_x, neg_inv_gamma, t.pack)
        obj, reg = (o, r) if obj is None else (obj + o, reg + r)
        xs += x
    return (buf, obj, reg, xs) if want_x else (buf, obj, reg)


@functools.lru_cache(maxsize=None)
def _panel_lib():
    lib = _build.load("panel_matching")
    vp, ci, cf, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.dualip_panel_project_tiles.argtypes = [vp, ci, ci, vp, ci, ll, ci, vp, ci, vp, vp, vp, ci, vp, vp]
    lib.dualip_panel_project.argtypes = (
        [vp, ll, ci, ci, vp, vp, vp, ll] + [ci] * 6 + [cf, cf, ci, ci, cf] + [vp, vp, vp, ci, vp, vp])
    for fn in (lib.dualip_panel_project_tiles, lib.dualip_panel_project):
        fn.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _panel_partials(dev: torch.device) -> torch.Tensor:
    """The per-device scratch of the kernel's per-block partials (one launch
    at a time, the launches of one call in turn: the same one-stream
    restriction as the kernel's counter)."""
    return torch.empty((_PANEL_MAX_GRID, 2), dtype=torch.float32, device=dev)


def _panel_args(buf, neg_inv_gamma, want_x, x_slots):
    """The carry buffer's checks on the card, the scalar, x and out."""
    dev = buf.device
    if buf.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the panel kernel takes a float32 or bfloat16 carry buffer, got {buf.dtype}")
    if not buf.is_contiguous():
        raise ValueError("the panel kernel takes a contiguous carry buffer")
    if buf.data_ptr() % 16:
        raise ValueError("the bulk copies need a 16-byte aligned carry buffer")
    if isinstance(neg_inv_gamma, torch.Tensor):
        nig = neg_inv_gamma.to(device=dev, dtype=torch.float32).reshape(())
    else:
        nig = torch.full((), float(neg_inv_gamma), dtype=torch.float32, device=dev)
    x = torch.empty(x_slots, dtype=torch.float32, device=dev) if want_x else None
    return nig, x, torch.empty(2, dtype=torch.float32, device=dev)


def fused_panel_project_tiles(
    buf: torch.Tensor, table: PanelTable, neg_inv_gamma, want_x: bool = False,
) -> Tuple:
    """Every tile of ``table`` (``fused_panel_project`` on each, in place on
    the (N,) carry buffer) in one launch of the panel kernel.  Returns
    ``(buf, sum(c*x), sum(x*x))`` over all tiles, plus with ``want_x`` a list
    of each tile's x (KP, q*L, 128) float32, views of one buffer.

    a*x and x are bit for bit those of ``fused_panel_project`` tile by tile;
    the two sums are added in another (fixed) order.  On the card a tile
    above ``PANEL_WARP_L_CAP`` takes a launch of the kernel's block form of
    its own after the others' (``table.blocks``).  Counts calls in the
    counters ``dualip.ops.fused_panel_project_tiles.enqueued`` (K3) and
    ``.enqueued_x`` (K4), and in ``.block_tiles`` the tiles a call sends to
    the block form (a CUDA graph's capture enqueues once, and a replay calls
    no wrapper); CPU calls count nothing."""
    if buf.dim() != 1:
        raise ValueError(f"buf must be (N,), got shape {tuple(buf.shape)}")
    if buf.device != table.device:
        raise ValueError(f"the carry buffer is on {buf.device}, the panel table on {table.device}")
    if buf.shape[0] < table.n_buf:
        raise ValueError(f"the panel regions end at {table.n_buf}, past the ({buf.shape[0]},) buffer")
    if neg_inv_gamma is None:
        raise ValueError("neg_inv_gamma is required")
    dev = buf.device
    if dev.type == "cpu":
        return fused_panel_project_tiles_reference(buf, table, neg_inv_gamma, want_x)
    if dev.type != "cuda":
        raise ValueError(f"fused_panel_project_tiles runs on cuda or cpu tensors, got {dev}")
    nig, x, out = _panel_args(buf, neg_inv_gamma, want_x, table.x_slots)
    blocks = [v for i in table.blocks for v in (i, table.tiles[i].L, _panel_columns(table.tiles[i]))]
    with torch.cuda.device(dev):
        rc = _panel_lib().dualip_panel_project_tiles(
            buf.data_ptr(), buf.element_size(), table.tiles[0].a.element_size(), table.rows.data_ptr(),
            len(table.tiles), table.n_items, int(table.wide), (ctypes.c_longlong * len(blocks))(*blocks),
            len(table.blocks), nig.data_ptr(), x.data_ptr() if want_x else None, _panel_partials(dev).data_ptr(),
            _PANEL_MAX_GRID, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_panel_project_tiles: CUDA error {rc} at launch ({len(table.tiles)} tiles, "
                           f"{table.n_items} work units, {len(table.blocks)} tiles of the block form)")
    profiling.count("dualip.ops.fused_panel_project_tiles.block_tiles", len(table.blocks))
    if not want_x:
        profiling.count("dualip.ops.fused_panel_project_tiles.enqueued")
        return buf, out[0], out[1]
    profiling.count("dualip.ops.fused_panel_project_tiles.enqueued_x")
    xs = [x[t.x_off:t.x_off + t.a.numel()].view(t.a.shape) for t in table.tiles]
    return buf, out[0], out[1], xs


def fused_panel_project(
    buf: torch.Tensor,
    a_p: torch.Tensor,
    c_p: torch.Tensor,
    len_p: torch.Tensor,
    off: int,
    kind: str,
    params_tuple: Tuple = (),
    want_x: bool = False,
    neg_inv_gamma=None,
    pack: Tuple = None,
) -> Tuple[torch.Tensor, ...]:
    """Compute z from the carried srow, project, and write ``a*x``: one tile's
    region of the (N,) carry buffer, in place.  The TPU kernel's contract,
    one tile a call; the objective launches all tiles at once
    (``fused_panel_project_tiles``, the same kernel).

    ``buf`` (float32 or bfloat16) holds ``srow = (-lambda/gamma)[row]`` in
    panel layout; the tile's region is rows ``[off/(128*L2), +KP)`` of
    ``buf.view(-1, L2, 128)``.  ``a_p``/``c_p`` are (KP, q*L, 128) float32
    or both bfloat16, ``len_p`` (KP, q, 128) int32; ``pack`` = (L, L2, q) on the compact packing.
    Only the region is written; its ghost lanes ``[q*L, L2)`` become zeros.
    Returns ``(buf, sum(c*x), sum(x*x))`` plus ``x`` (KP, q*L, 128) float32
    with ``want_x``.

    Counts launches of the kernel in the counters
    ``dualip.ops.fused_panel_project.enqueued`` (K3) and ``.enqueued_x`` (K4),
    and in ``.block_tiles`` those of the block form (L above
    ``PANEL_WARP_L_CAP``, as in the all-tiles call); CPU calls count
    nothing."""
    KP, L, L2, q = _panel_geometry(a_p, pack)
    if c_p.shape != a_p.shape:
        raise ValueError(f"c_p shape {tuple(c_p.shape)} != a_p shape {tuple(a_p.shape)}")
    if tuple(len_p.shape) != (KP, q, 128):
        raise ValueError(f"len_p must be ({KP}, {q}, 128), got {tuple(len_p.shape)}")
    if buf.dim() != 1 or off % (128 * L2) or off < 0 or off + KP * L2 * 128 > buf.shape[0]:
        raise ValueError(f"region off={off}, rows={KP}, L2={L2} does not lie in the ({buf.shape[0]},) buffer")
    if neg_inv_gamma is None:
        raise ValueError("neg_inv_gamma is required")
    dev = buf.device
    tensors = (buf, a_p, c_p, len_p)
    if any(t.device != dev for t in tensors):
        raise ValueError("buf, a_p, c_p and len_p must be on one device")

    if dev.type == "cpu":
        return fused_panel_project_reference(buf, a_p, c_p, len_p, off, kind, params_tuple, want_x, neg_inv_gamma, pack)
    if dev.type != "cuda":
        raise ValueError(f"fused_panel_project runs on cuda or cpu tensors, got {dev}")

    if a_p.dtype not in (torch.float32, torch.bfloat16) or c_p.dtype != a_p.dtype:
        raise TypeError(f"the panel kernel takes float32 or bfloat16 a_p and c_p of one type, got {a_p.dtype} "
                        f"and {c_p.dtype}")
    if len_p.dtype != torch.int32:
        raise TypeError("len_p must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the panel kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors[1:]):
        raise ValueError("the bulk copies need 16-byte aligned a_p, c_p and len_p")
    code, ineq, lo, hi, has_lo, has_hi, radius = _kernel_params(kind, dict(params_tuple))
    nig, x, out = _panel_args(buf, neg_inv_gamma, want_x, a_p.numel())
    with torch.cuda.device(dev):
        rc = _panel_lib().dualip_panel_project(
            buf.data_ptr(), buf.shape[0], buf.element_size(), a_p.element_size(), a_p.data_ptr(), c_p.data_ptr(),
            len_p.data_ptr(),
            off, KP, L, L2, q, code, ineq, lo, hi, int(has_lo), int(has_hi), radius,
            nig.data_ptr(), x.data_ptr() if want_x else None, _panel_partials(dev).data_ptr(), _PANEL_MAX_GRID,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_panel_project: CUDA error {rc} at launch (kind={kind}, KP={KP}, L={L}, L2={L2}, q={q})")
    if panel_path(L).path == "block":
        profiling.count("dualip.ops.fused_panel_project.block_tiles")
    if want_x:
        profiling.count("dualip.ops.fused_panel_project.enqueued_x")
        return buf, out[0], out[1], x.view(a_p.shape)
    profiling.count("dualip.ops.fused_panel_project.enqueued")
    return buf, out[0], out[1]
