"""The fused matching kernels and their plain PyTorch versions: the tile
kernel (K1/K2) of the csc layout and the panel kernel (K3/K4) of the butterfly
layout.

Port of ``dualip_tpu/ops/pallas_matching.py::fused_tile_eval_T``
(``_fused_kernel`` / ``_fused_kernel_x`` with the device function
``_project_block``).  Per ``(L, K)``-transposed tile:

    z = a * lam_g + neg_inv_gamma * c  ->  x = Proj(z) along L  ->  mask
    ->  a*x,  sum(c*x),  sum(x*x)   (and x itself with ``want_x``)

``lam_g = (-lambda/gamma)[rows]`` is gathered by the caller, and the caller
segment-sums ``a*x`` by row, as the JAX package leaves both to XLA.

On a CUDA tensor ``fused_tile_eval_T`` launches the hand-written kernel of
``csrc/fused_matching.cu`` or raises; on a CPU tensor it runs
``fused_tile_eval_T_reference``, a step-by-step transcription of the TPU
kernel that the tests hold against the JAX package.  The simplex and
box-cut kinds run ``BISECTION_ITERS = 30`` bisection steps, as the TPU
kernel does (the registry's jnp/torch projections run 50).

``fused_panel_project`` is the port of ``fused_panel_project`` there
(``_panel_kernel`` / ``_panel_kernel_x``): one tile's region of the (N,) carry
buffer, in panel layout, is read as srow, projected and overwritten with
``a*x`` in place.  On a CUDA tensor it launches ``csrc/panel_matching.cu`` or
raises; on a CPU tensor it runs ``fused_panel_project_reference``.  Both share
the projection with K1/K2 (``csrc/project_block.cuh`` on the card,
``_project_block_reference`` here).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from dualip_tpu_torch.ops import _build
from dualip_tpu_torch.projections.base import project

DEFAULT_BLOCK_K = 1024
BISECTION_ITERS = 30

# Must match csrc/fused_matching.cu.
_THREADS = 128  # columns per block of the per-column kernels
REG_L_CAP = 64  # largest L whose column the per-column kernel keeps in registers
_KIND_CODE = {"identity": 0, "box": 0, "cone": 0, "simplex": 1, "simplex_eq": 1, "box_cut": 2, "box_cut_eq": 2}


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
    """Blocks of the kernel's launch (one partial (obj, reg) pair each):
    a block per ``_THREADS`` columns, or a block per column above ``REG_L_CAP``."""
    if _KIND_CODE[kind] != 0 and L > REG_L_CAP:
        return K
    return -(-K // _THREADS)


_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]


def _kernel():
    lib = _build.load("fused_matching")
    fn = lib.dualip_fused_tile_eval
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


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
    tensor is read by the kernel on the card, with no host sync).

    Counts launches of the kernel in ``fused_tile_eval_T.launches`` (K1) and
    ``fused_tile_eval_T.launches_x`` (K2, ``want_x``); CPU calls count nothing.
    """
    if a_T.dim() != 2:
        raise ValueError(f"a_T must be (L, K), got shape {tuple(a_T.shape)}")
    L, K = a_T.shape
    for name, t in (("lam_g_T", lam_g_T), ("c_T", c_T)):
        if t.shape != a_T.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != a_T shape {tuple(a_T.shape)}")
    if tuple(length.shape) != (K,):
        raise ValueError(f"length must be ({K},), got {tuple(length.shape)}")
    if block_k <= 0 or K % block_k != 0:
        raise ValueError(f"K={K} not divisible by block_k={block_k}")
    tensors = (lam_g_T, a_T, c_T, length)
    dev = a_T.device
    if any(t.device != dev for t in tensors):
        raise ValueError("lam_g_T, a_T, c_T and length must be on one device")
    params = dict(params_tuple)

    if dev.type == "cpu":
        return fused_tile_eval_T_reference(lam_g_T, a_T, c_T, length, neg_inv_gamma, kind, params_tuple, want_x)
    if dev.type != "cuda":
        raise ValueError(f"fused_tile_eval_T runs on cuda or cpu tensors, got {dev}")

    if any(t.dtype != torch.float32 for t in tensors[:3]):
        raise TypeError("the fused kernel takes float32 lam_g_T, a_T and c_T")
    if length.dtype != torch.int32:
        raise TypeError("length must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the fused kernel takes contiguous tensors")
    code, ineq, lo, hi, has_lo, has_hi, radius = _kernel_params(kind, params)
    if isinstance(neg_inv_gamma, torch.Tensor):
        nig = neg_inv_gamma.to(device=dev, dtype=torch.float32).reshape(())
    else:
        nig = torch.full((), float(neg_inv_gamma), dtype=torch.float32, device=dev)

    nb = num_partial_blocks(kind, L, K)
    ax = torch.empty_like(a_T)
    x = torch.empty_like(a_T) if want_x else None
    partials = torch.empty((nb, 2), dtype=torch.float32, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel()(
            lam_g_T.data_ptr(), a_T.data_ptr(), c_T.data_ptr(), length.data_ptr(), nig.data_ptr(),
            ax.data_ptr(), x.data_ptr() if want_x else None, partials.data_ptr(), out.data_ptr(),
            L, K, nb, code, int(want_x), ineq,
            lo, hi, int(has_lo), int(has_hi), radius, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_tile_eval_T: CUDA error {rc} at launch (kind={kind}, L={L}, K={K})")
    if want_x:
        fused_tile_eval_T.launches_x += 1
        return ax, out[0], out[1], x
    fused_tile_eval_T.launches += 1
    return ax, out[0], out[1]


fused_tile_eval_T.launches = 0
fused_tile_eval_T.launches_x = 0


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
    compute = torch.float32 if s.dtype == torch.bfloat16 else s.dtype
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


@functools.lru_cache(maxsize=None)
def _panel_kernel():
    fn = _build.load("panel_matching").dualip_panel_project
    vp, ci, cf, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    fn.argtypes = [vp] * 8 + [ll, ll] + [ci] * 7 + [cf, cf, ci, ci, cf, vp]
    fn.restype = ci
    return fn


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
    region of the (N,) carry buffer, in place.

    ``buf`` (float32 or bfloat16) holds ``srow = (-lambda/gamma)[row]`` in
    panel layout; the tile's region is rows ``[off/(128*L2), +KP)`` of
    ``buf.view(-1, L2, 128)``.  ``a_p``/``c_p`` are (KP, q*L, 128) float32,
    ``len_p`` (KP, q, 128) int32; ``pack`` = (L, L2, q) on the compact packing.
    Only the region is written; its ghost lanes ``[q*L, L2)`` become zeros.
    Returns ``(buf, sum(c*x), sum(x*x))`` plus ``x`` (KP, q*L, 128) float32
    with ``want_x``.

    Counts launches of the kernel in ``fused_panel_project.launches`` (K3) and
    ``.launches_x`` (K4); CPU calls count nothing."""
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

    if buf.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the panel kernel takes a float32 or bfloat16 carry buffer, got {buf.dtype}")
    if a_p.dtype != torch.float32 or c_p.dtype != torch.float32:
        raise TypeError("the panel kernel takes float32 a_p and c_p")
    if len_p.dtype != torch.int32:
        raise TypeError("len_p must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the panel kernel takes contiguous tensors")
    code, ineq, lo, hi, has_lo, has_hi, radius = _kernel_params(kind, dict(params_tuple))
    if isinstance(neg_inv_gamma, torch.Tensor):
        nig = neg_inv_gamma.to(device=dev, dtype=torch.float32).reshape(())
    else:
        nig = torch.full((), float(neg_inv_gamma), dtype=torch.float32, device=dev)

    x = torch.empty_like(a_p) if want_x else None
    partials = torch.empty((KP * q, 2), dtype=torch.float32, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _panel_kernel()(
            buf.data_ptr(), a_p.data_ptr(), c_p.data_ptr(), len_p.data_ptr(), nig.data_ptr(),
            x.data_ptr() if want_x else None, partials.data_ptr(), out.data_ptr(),
            off, buf.shape[0], buf.element_size(), KP, L, L2, q, code, ineq,
            lo, hi, int(has_lo), int(has_hi), radius, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_panel_project: CUDA error {rc} at launch (kind={kind}, KP={KP}, L={L}, L2={L2}, q={q})")
    if want_x:
        fused_panel_project.launches_x += 1
        return buf, out[0], out[1], x
    fused_panel_project.launches += 1
    return buf, out[0], out[1]


fused_panel_project.launches = 0
fused_panel_project.launches_x = 0
