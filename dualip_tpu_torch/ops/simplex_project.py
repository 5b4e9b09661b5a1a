"""Duchi's simplex projection of rows of at most 64 lanes in one kernel.

    w = argmin ||w - x|| over {w >= 0, sum w (<=|=) z}, for each last-axis row

``projections/simplex.py::duchi_project`` sends float32 CUDA rows of
``L <= KERNEL_MAX_L`` lanes here (``takes_kernel``): the hand-written kernel
of ``csrc/simplex_project.cu`` sorts, scans and thresholds each row in
registers, in place of torch's batched sort, cumsum and the rho/theta glue.
It replaces no TPU kernel (the JAX package leaves the sort and cumsum to
XLA).  Its arithmetic is Duchi's rule in ``duchi_project``'s order, with one
order of its own: the prefix sums are added one after another in sorted
order, and the inequality's pass-through tests the last of them.
``simplex_project_reference`` is that arithmetic in torch ops, the plain
version: on the card it gives the kernel's bits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dualip_tpu_torch.ops import _build
from dualip_tpu_torch.utils import profiling

KERNEL_MAX_L = 64  # widest row the kernel holds in registers (csrc/simplex_project.cu)


def takes_kernel(device, dtype: torch.dtype, width: int) -> bool:
    """Whether ``duchi_project`` sends rows of ``width`` lanes of ``dtype``
    on ``device`` to the kernel: CUDA, float32, 1 to ``KERNEL_MAX_L`` lanes.
    Everything else (the CPU, float64, wider rows) runs torch's ops."""
    return torch.device(device).type == "cuda" and dtype == torch.float32 and 1 <= width <= KERNEL_MAX_L


def simplex_project_reference(x: torch.Tensor, z: float = 1.0, inequality: bool = False,
                              tol: float = 1e-6) -> torch.Tensor:
    """The kernel's arithmetic in torch ops, in ``x``'s dtype and any width:
    clamp at 0; sort descending; the prefix sums ``css`` added one after
    another; ``q_i = (css_i - z) / (i + 1)``; rho the largest i with
    ``u_i - q_i > 0`` (else 0) and ``theta = q_rho``; ``w = max(x - theta,
    0)``; where ``u_0/z - u_1/z > 1``, z at the lane that holds ``u_0`` and 0
    elsewhere; with ``inequality``, rows with ``css_{L-1} <= z + tol`` pass
    through."""
    dtype, dev = x.dtype, x.device
    L = x.shape[-1]
    zt = torch.full((), z, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    x = torch.maximum(x, zero)
    u = torch.sort(x, dim=-1, descending=True).values
    run = u[..., 0]
    sums = [run]
    for i in range(1, L):
        run = run + u[..., i]
        sums.append(run)
    css = torch.stack(sums, dim=-1)
    lane = torch.arange(L, device=dev)
    q = (css - zt) / (lane + 1).to(dtype)
    rho = torch.amax(torch.where(u - q > 0, lane, 0), dim=-1, keepdim=True)
    theta = torch.take_along_dim(q, rho, dim=-1)
    w = torch.maximum(x - theta, zero)
    if L > 1:
        u0 = u[..., :1]
        shortcut = (u0 / zt - u[..., 1:2] / zt) > 1.0
        w = torch.where(shortcut, torch.where(x == u0, zt, zero), w)
    if inequality:
        feasible = css[..., -1:] <= zt + torch.full((), tol, dtype=dtype, device=dev)
        w = torch.where(feasible, x, w)
    return w


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("simplex_project").dualip_simplex_project
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def simplex_project(x: torch.Tensor, z: float = 1.0, inequality: bool = False, tol: float = 1e-6) -> torch.Tensor:
    """Project each last-axis row of ``x`` onto ``{w >= 0, sum w (<=|=) z}``
    (``<=`` with ``inequality``); returns a new tensor.

    On CUDA tensors the kernel runs (float32, 1 to ``KERNEL_MAX_L`` lanes; a
    non-contiguous ``x`` is copied first) or the call raises; on CPU tensors
    the plain version runs.  A row with a NaN entry comes out all NaN, as
    from torch's ops.  One
    launch counts one in ``dualip.ops.simplex_project.enqueued``
    (``utils/profiling.py``; a CUDA graph's capture enqueues once, and a
    replay calls no wrapper)."""
    dev = x.device
    if dev.type == "cpu":
        return simplex_project_reference(x, z, inequality, tol)
    if not takes_kernel(dev, x.dtype, x.shape[-1] if x.dim() else 0):
        raise ValueError(f"the simplex kernel takes float32 CUDA rows of 1 to {KERNEL_MAX_L} lanes, "
                         f"got {x.dtype} of shape {tuple(x.shape)} on {dev}")
    x = x.contiguous()
    w = torch.empty_like(x)
    with torch.cuda.device(dev):
        rc = _kernel()(x.data_ptr(), w.data_ptr(), x.numel() // x.shape[-1], x.shape[-1], z, tol, int(inequality),
                       torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"simplex_project: CUDA error {rc} at launch (shape {tuple(x.shape)})")
    profiling.count("dualip.ops.simplex_project.enqueued")
    return w
