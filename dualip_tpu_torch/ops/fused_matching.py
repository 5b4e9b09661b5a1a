"""The fused matching tile kernel (K1/K2) and its plain PyTorch version.

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
"""

from __future__ import annotations

import ctypes
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


def _project_block_reference(z: torch.Tensor, kind: str, params: dict, length: torch.Tensor, L: int) -> torch.Tensor:
    """``_project_block`` on an (L, K) block, reducing over axis 0."""
    dtype, dev = z.dtype, z.device
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
        v_max = torch.amax(vn, dim=0, keepdim=True)
        v_shift = vn - v_max
        lo = torch.full(v_max.shape, -1.0, dtype=dtype, device=dev)
        hi = torch.zeros(v_max.shape, dtype=dtype, device=dev)
        for _ in range(BISECTION_ITERS):
            mid = (lo + hi) * 0.5
            s = torch.sum(torch.maximum(v_shift - mid, zero), dim=0, keepdim=True)
            too_high = s > 1.0
            lo, hi = torch.where(too_high, mid, lo), torch.where(too_high, hi, mid)
        nu = (lo + hi) * 0.5
        w = torch.maximum(v_shift - nu, zero) * radius
        if L > 1:
            # top-2 vertex shortcut; argmax takes the first maximum
            i0 = torch.argmax(vn, dim=0, keepdim=True)
            lane = torch.arange(L, device=dev)[:, None]
            masked = torch.where(lane == i0, const(-torch.inf), vn)
            v1 = torch.amax(masked, dim=0, keepdim=True)
            shortcut = (v_max - v1) > 1.0
            onehot = torch.where(lane == i0, radius, zero)
            w = torch.where(shortcut, onehot, w)
        if kind == "simplex":  # inequality: feasible columns pass through
            feasible = torch.sum(v, dim=0, keepdim=True) <= radius + tol
            w = torch.where(feasible, v, w)
        x = w
    elif kind in ("box_cut", "box_cut_eq"):
        op = project(kind, **params)  # the registry parses and checks the bounds
        lt, ut, zcut, tol = const(op.lower), const(op.upper), const(op.z), const(1e-6)

        def clip(t):
            return torch.minimum(torch.maximum(t, lt), ut)

        lo = torch.amin(z, dim=0, keepdim=True) - ut
        hi = torch.amax(z, dim=0, keepdim=True) - lt
        for _ in range(BISECTION_ITERS):
            mid = (lo + hi) * 0.5
            s = torch.sum(clip(z - mid), dim=0, keepdim=True)
            too_high = s > zcut
            lo, hi = torch.where(too_high, mid, lo), torch.where(too_high, hi, mid)
        nu = (lo + hi) * 0.5
        w = clip(z - nu)
        if kind == "box_cut":  # inequality: box-feasible columns pass through
            clipped = clip(z)
            feasible = torch.sum(clipped, dim=0, keepdim=True) <= zcut + tol
            w = torch.where(feasible, clipped, w)
        x = w
    else:
        raise ValueError(f"Unsupported projection kind {kind!r}")

    lane = torch.arange(L, device=dev, dtype=torch.int32)[:, None]
    valid = lane < length.reshape(1, -1)
    return torch.where(valid, x, zero)


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
