#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dualip_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--sources N] [--iters N] [--phases a,b,...]

Phases, one output line or more each (``--phases`` runs a subset; the two
result lines at the end are printed only by a full run):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile every hand-written kernel from this checkout (one ``nvcc``
   per source, all started together) and the native Benes router (``g++``);
3. kernels: the fused tile kernel (K1/K2) against its plain PyTorch version on
   the card, for every projection kind, at L in {1, 2, 8, 32, 100, 29};
4. segsum: the fixed-order row segment-sum against a float64 ``index_add_``,
   and two launches bit for bit;
5. benes: the three Benes kernels (K5 fine, K6 coarse group, K7 two-axis
   coarse side) against the plain stages with ``torch.equal``, forward and
   reverse, fp32 and bf16, in every regime of the block count;
6. panel: the panel kernel (K3/K4) against its plain version for every
   projection kind, q = 1 and q > 1, L a power of two and not, fp32 and bf16
   carry; the rest of the buffer unchanged, ghost lanes zero;
7. golden: the 5x5 matching golden trace through ``run_solver`` on the card,
   csc layout and butterfly layout (plain, compact, ``srow_gather``, bf16);
8. slice: the synthetic matching LP (2,500,000 sources x 10,000 destinations,
   sparsity 1e-3, seed 42) through ``run_solver`` on the csc layout with the
   fused kernel, its launches counted, its first 20 iterations repeated with
   the plain version and compared, a repeat that must be bit-identical, the
   segment-sum held against a float64 ``index_add_`` on each tile's own a*x,
   and each kernel timed on the slice's tiles beside its plain version and bound;
9. butterfly: the same data through ``run_solver`` with
   ``layout="butterfly"``: launches counted, plain versions compared, the csc
   log compared, a bit-identical repeat, a 250,000-source solve (the K6
   regime), then ``compact``, ``carry_dtype=bfloat16`` and ``srow_gather``,
   and each kernel timed at the slice's shapes.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
the last line.  Without a CUDA device, or without the repository beside it,
the script exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
BISECTION_ITERS = 30

SMALL_SOURCES = 250_000  # the second butterfly solve: few enough blocks for one single-axis group a side
ALL_PHASES = ("kernels", "segsum", "benes", "panel", "golden", "slice", "butterfly")

# 5x5 Scala golden problem and trace (tests/objectives/test_dualip_matching_simplex.py).
A_COMPACT = np.array(
    [
        [0.307766110869125, 0.483770735096186, 0.624996477039531, 0.669021712383255, 0.535811153938994],
        [0.257672501029447, 0.812402617651969, 0.882165518123657, 0.204612161964178, 0.710803845431656],
        [0.552322433330119, 0.370320537127554, 0.28035383997485, 0.357524853432551, 0.538348698290065],
        [0.0563831503968686, 0.546558595029637, 0.398487901547924, 0.359475114848465, 0.74897222686559],
        [0.468549283919856, 0.170262051047757, 0.76255108229816, 0.690290528349578, 0.420101450523362],
    ],
    dtype=np.float32,
)
GOLDEN = [(2, -3.6010155991401818), (16, -3.60842718733725), (23, -3.5080258013053136), (29, -3.4868496294227143)]

# The (kind, params) cases of tests/ops/test_pallas_matching.py plus box_cut.
CASES = [
    ("simplex", (("z", 1.0),)),
    ("simplex", (("z", 2.5),)),
    ("simplex_eq", (("z", 1.0),)),
    ("box", (("lower", 0.0), ("upper", 1.0))),
    ("box", ()),
    ("box", (("l", -0.5), ("u", 0.5))),
    ("box", (("lower", float("nan")), ("upper", 0.25))),
    ("cone", (("lower", 0.0),)),
    ("cone", (("u", 0.1),)),
    ("identity", ()),
    ("box_cut", (("lower", 0.0), ("upper", 0.6), ("z", 1.0))),
    ("box_cut_eq", (("l", 0.0), ("u", 1.0), ("z", 2.0))),
]


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, between CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ops_per_slot(kind: str) -> int:
    """Arithmetic per tile slot, counted from csrc/project_block.cuh."""
    base = 3 + 1 + 1 + 4  # z (2 mul, 1 add), mask, a*x, c*x and x*x sums
    if kind in ("simplex", "simplex_eq"):
        return base + 4 + 3 * BISECTION_ITERS + 3  # clamp/div/max/shift, (sub, max, add) per step, final
    if kind in ("box_cut", "box_cut_eq"):
        return base + 5 + 4 * BISECTION_ITERS + 3  # min/max/clip sum, (sub, clip, add) per step, final
    return base + 2  # clamps


def tol_x(ref: torch.Tensor) -> float:
    return 5e-5 * max(1.0, float(ref.abs().max()))


@contextlib.contextmanager
def rebound(module, **attrs):
    """Module attributes replaced for the length of the block (the plain
    versions stand in for the kernels' wrappers in a check)."""
    old = {k: getattr(module, k) for k in attrs}
    try:
        for k, v in attrs.items():
            setattr(module, k, v)
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def rel_dev(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return np.abs(got - want) / np.maximum(1.0, np.abs(want))


def phase_kernels(widths, dev):
    """K1/K2: every (kind, params) case at each width and both want_x, kernel vs plain."""
    from dualip_tpu_torch.ops.fused_matching import fused_tile_eval_T, fused_tile_eval_T_reference

    rng = np.random.default_rng(0)
    K, m = 4 * 1024, 64
    err = {False: 0.0, True: 0.0}
    n = 0
    for kind, params in CASES:
        for L in widths:
            a = np.abs(rng.normal(size=(L, K))).astype(np.float32)
            c = -np.abs(rng.normal(size=(L, K))).astype(np.float32)
            length = rng.integers(1, L + 1, size=K).astype(np.int32)
            length[-5:] = 0
            mask = np.arange(L)[:, None] < length[None, :]
            a, c = np.where(mask, a, 0).astype(np.float32), np.where(mask, c, 0).astype(np.float32)
            lam = np.abs(rng.normal(size=m)).astype(np.float32)
            rows = rng.integers(0, m, size=(L, K))
            for scale in (-100.0, -2.0):
                lam_g = torch.from_numpy((np.float32(scale) * lam)[rows]).to(dev)
                t = [torch.from_numpy(v).to(dev) for v in (a, c, length)]
                for want_x in (False, True):
                    got = fused_tile_eval_T(lam_g, *t, scale, kind, params, block_k=1024, want_x=want_x)
                    ref = fused_tile_eval_T_reference(lam_g, *t, scale, kind, params, want_x=want_x)
                    torch.cuda.synchronize()
                    tol = tol_x(ref[3] if want_x else ref[0])
                    e_ax = float((got[0] - ref[0]).abs().max())
                    e = e_ax
                    check(e_ax <= tol, f"{kind}{params} L={L} want_x={want_x}: |ax| err {e_ax} > {tol}")
                    if want_x:
                        e_x = float((got[3] - ref[3]).abs().max())
                        check(e_x <= tol, f"{kind}{params} L={L}: |x| err {e_x} > {tol}")
                        e = max(e, e_x)
                    for i, name in ((1, "obj"), (2, "reg")):
                        g, r = float(got[i]), float(ref[i])
                        check(abs(g - r) <= 1e-3 + 1e-4 * abs(r), f"{kind}{params} L={L}: {name} {g} vs {r}")
                    err[want_x] = max(err[want_x], e)
                    n += 1
    say("kernels", cases=n, widths=list(widths), max_abs_err_K1=err[False], max_abs_err_K2=err[True],
        tolerance="ax,x: 5e-5*max(1,max|x|); obj,reg: 1e-3+1e-4*|ref|")
    return err


def phase_segsum(dev) -> float:
    """The segment-sum kernel against a float64 index_add_; two launches bit for bit."""
    from dualip_tpu_torch.ops.segment_sum import segment_sum_rows
    from dualip_tpu_torch.sparse.bcsc import RowOrder, tile_row_order

    rng = np.random.default_rng(1)
    worst = 0.0
    for m, K, L, transposed in ((1000, 1 << 16, 16, True), (70_000, 1 << 15, 5, False), (7, 1024, 3, True)):
        length = rng.integers(0, L + 1, size=K).astype(np.int32)
        shape = (L, K) if transposed else (K, L)
        rows = rng.integers(0, m, size=shape).astype(np.int32)
        lane = np.arange(L)
        valid = (lane[:, None] < length[None, :]) if transposed else (lane[None, :] < length[:, None])
        vals = np.where(valid, rng.normal(size=shape), 0.0).astype(np.float32)
        ro = tile_row_order(rows, length, m, transposed)
        ro = RowOrder(torch.from_numpy(ro.order).to(dev), torch.from_numpy(ro.ptr).to(dev))
        v, r = torch.from_numpy(vals).to(dev), torch.from_numpy(rows).to(dev)
        start = torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(dev)
        got = segment_sum_rows(start.clone(), v, r, ro)
        again = segment_sum_rows(start.clone(), v, r, ro)
        ref = start.double().index_add_(0, r.reshape(-1), v.reshape(-1).double())
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"segment-sum m={m}: two launches differ")
        scale = float(torch.zeros(m, dtype=torch.float64, device=dev).index_add_(
            0, r.reshape(-1), v.reshape(-1).double().abs()).max())
        e = float((got.double() - ref).abs().max())
        check(e <= 1e-5 * max(1.0, scale), f"segment-sum m={m}: err {e} vs sum|v| {scale}")
        worst = max(worst, e)
    say("segsum", cases=3, max_abs_err_vs_float64=worst, tolerance="1e-5*max(1, max row sum of |v|)",
        repeat="bit-identical")
    return worst


def phase_benes(dev) -> None:
    """K5, K6, K7 against the plain stages, bit for bit, in every regime."""
    import dualip_tpu_torch.ops.butterfly as bf

    # (slots, block_log2, what the packed plan must look like)
    regimes = [
        (1 << 12, bf.DEFAULT_BLOCK_LOG2, "fine only (K5 alone)"),
        (1 << 17, 12, "one group a side (K6)"),
        (1 << 17, 7, "two-axis side, one launch (K7)"),
        (1 << 20, 7, "two-axis side, two launches (K7)"),
        (1 << 21, 7, "two groups a side (K6 twice)"),
        (1 << 20, bf.DEFAULT_BLOCK_LOG2, "default block (K6)"),
    ]
    rng = np.random.default_rng(2)
    for N, bl, what in regimes:
        n = N - 37 if N > 4096 else N  # a padded tail too
        perm = rng.permutation(n)
        t0 = time.perf_counter()
        planes, dists, n_in, n_out = bf.benes_route_planes(perm, pad_to=N)
        route_s = time.perf_counter() - t0
        packed = bf.pack_plan_from_planes(planes, dists, n_in, n_out, bl, device=dev)
        kinds = ["K7" if isinstance(g[1], tuple) else "K6" for g in packed.pre_groups]
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev).to(dtype)
            want = bf._pad_to(x, N)[torch.from_numpy(np.concatenate([perm, np.arange(n, N)])).to(dev)]
            before = (bf.benes_fine.launches, bf.benes_coarse.launches, bf.benes_coarse2.launches)
            y = bf.apply_butterfly_cuda(packed, x.clone(), truncate=False)
            used = tuple(b - a for a, b in zip(before, (bf.benes_fine.launches, bf.benes_coarse.launches,
                                                        bf.benes_coarse2.launches)))
            # the plain version of every kernel, group by group, on the same masks
            v = bf._pad_to(x, N)
            for (steps, E, I), mk in zip(packed.pre_groups, packed.pre_masks):
                v = bf.benes_coarse2_reference(v, mk, steps, *E, I) if isinstance(E, tuple) else \
                    bf.benes_coarse_reference(v, mk, steps, E, I)
            v = bf.benes_fine_reference(v, packed.fine_masks, packed.fine_dists)
            for (steps, E, I), mk in zip(packed.post_groups, packed.post_masks):
                v = bf.benes_coarse2_reference(v, mk, steps, *E, I) if isinstance(E, tuple) else \
                    bf.benes_coarse_reference(v, mk, steps, E, I)
            torch.cuda.synchronize()
            check(torch.equal(y, v), f"benes {what} {dtype}: kernels differ from the plain stages")
            check(torch.equal(y[:n_out], want[:n_out]), f"benes {what} {dtype}: forward is not x[perm]")
            back = bf.apply_butterfly_cuda(packed, y.clone(), reverse=True)
            plain_back = bf._pad_to(x, N)
            torch.cuda.synchronize()
            check(torch.equal(back, plain_back[:n_in]), f"benes {what} {dtype}: reverse does not undo forward")
        say("benes", slots=N, block_log2=bl, regime=repr(what), pre_groups=kinds,
            launches_fine_coarse_coarse2=used, router=bf.last_route.get("router"), route_s=f"{route_s:.2f}",
            equal="bit for bit, forward and reverse, fp32 and bf16")
        if "two launches" in what:
            check(used[2] == 4, f"benes {what}: expected 4 K7 launches, got {used[2]}")
        if "one launch" in what:
            check(used[2] == 2, f"benes {what}: expected 2 K7 launches, got {used[2]}")
        if "K6 twice" in what:
            check(used[1] == 4 and used[2] == 0, f"benes {what}: expected 4 K6 launches, got {used}")


def phase_panel(dev):
    """K3/K4 against the plain version: every case, q = 1 and q > 1, both carries."""
    from dualip_tpu_torch.ops.fused_matching import fused_panel_project, fused_panel_project_reference
    from dualip_tpu_torch.sparse.rowmajor import _pack_geometry

    rng = np.random.default_rng(3)
    err = {False: 0.0, True: 0.0}
    n = 0
    # (L, compact): plain panels with L a power of two and not; compact packings with q > 1
    shapes = [(1, False), (2, False), (5, False), (16, False), (29, False), (100, False),
              (3, True), (5, True), (29, True), (34, True)]
    for kind, params in CASES:
        for L, compact in shapes:
            if compact:
                L2, q = _pack_geometry(L)
                pack = (L, L2, q)
            else:
                L2, q, pack = (1 << max(L - 1, 0).bit_length()) if L > 1 else 1, 1, None
            KP = 16
            a = np.abs(rng.normal(size=(KP, q, L, 128))).astype(np.float32)
            c = -np.abs(rng.normal(size=(KP, q, L, 128))).astype(np.float32)
            length = rng.integers(0, L + 1, size=(KP, q, 1, 128)).astype(np.int32)
            mask = np.arange(L)[None, None, :, None] < length
            a = np.where(mask, a, 0).astype(np.float32).reshape(KP, q * L, 128)
            c = np.where(mask, c, 0).astype(np.float32).reshape(KP, q * L, 128)
            length = length.reshape(KP, q, 128)
            region = KP * L2 * 128
            off = 3 * region  # the region lies inside a larger buffer
            N = 8 * region
            t = [torch.from_numpy(v).to(dev) for v in (a, c, length)]
            for carry in (torch.float32, torch.bfloat16):
                buf0 = torch.from_numpy(rng.normal(size=N).astype(np.float32) * 50).to(dev).to(carry)
                for want_x in (False, True):
                    got = fused_panel_project(buf0.clone(), *t, off, kind, params, want_x=want_x,
                                              neg_inv_gamma=-2.0, pack=pack)
                    ref = fused_panel_project_reference(buf0.clone(), *t, off, kind, params, want_x=want_x,
                                                        neg_inv_gamma=-2.0, pack=pack)
                    torch.cuda.synchronize()
                    name = f"{kind}{params} L={L} q={q} {carry} want_x={want_x}"
                    gb, rb = got[0], ref[0]
                    check(torch.equal(gb[:off], buf0[:off]) and torch.equal(gb[off + region:], buf0[off + region:]),
                          f"panel {name}: wrote outside its region")
                    g_reg, r_reg = gb[off:off + region].view(KP, L2, 128).float(), rb[off:off + region].view(KP, L2, 128).float()
                    check(not g_reg[:, q * L:, :].any(), f"panel {name}: ghost lanes not zero")
                    # a bf16 carry rounds a*x once: one bf16 ulp of slack on top
                    tol = tol_x(r_reg) + (float(r_reg.abs().max()) * 2.0 ** -7 if carry == torch.bfloat16 else 0.0)
                    e = float((g_reg - r_reg).abs().max())
                    check(e <= tol, f"panel {name}: |ax| err {e} > {tol}")
                    if want_x:
                        e_x = float((got[3] - ref[3]).abs().max())
                        check(e_x <= tol_x(ref[3]), f"panel {name}: |x| err {e_x}")
                        e = max(e, e_x) if carry == torch.float32 else e_x
                    for i, nm in ((1, "obj"), (2, "reg")):
                        g, r = float(got[i]), float(ref[i])
                        check(abs(g - r) <= 1e-3 + 1e-4 * abs(r), f"panel {name}: {nm} {g} vs {r}")
                    if carry == torch.float32 or want_x:
                        err[want_x] = max(err[want_x], e)
                    n += 1
    say("panel", cases=n, shapes_L_compact=shapes, max_abs_err_K3=err[False], max_abs_err_K4=err[True],
        tolerance="ax,x: 5e-5*max(1,max|.|) (+1 bf16 ulp on a bf16 carry); obj,reg: 1e-3+1e-4*|ref|",
        outside_region="unchanged", ghost_lanes="zero")
    return err


def phase_golden(dev_name):
    import dualip_tpu_torch as dt
    from dualip_tpu_torch.checkpoint import save_dual
    from dualip_tpu_torch.objectives.matching import MatchingInputArgs
    from dualip_tpu_torch.ops._build import BUILD_DIR
    from dualip_tpu_torch.projections import create_projection_map
    from dualip_tpu_torch.sparse import csc_from_dense

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    dual0 = BUILD_DIR / "golden_dual0.npz"  # the golden trace starts from 0.1
    save_dual(str(dual0), np.full(5, 0.1, dtype=np.float32))

    def solve(**kwargs):
        res = dt.run_solver(
            MatchingInputArgs(
                A=csc_from_dense(A_COMPACT.T), c=csc_from_dense(-A_COMPACT.T),
                projection_map=create_projection_map("simplex", {"z": 1}, 5), b_vec=np.full(5, 0.7, np.float32),
            ),
            dt.SolverArgs(max_iter=30, gamma=1e-3, initial_dual_path=str(dual0)),
            dt.ComputeArgs(),
            dt.ObjectiveArgs(objective_kwargs=kwargs),
        )
        check(res.dual_val.device.type == "cuda", "golden solve did not run on the card")
        return res.dual_objective_log

    # bf16 carry: the tolerance of tests/test_rowmajor_layout.py (rtol 4e-2 on the objective)
    variants = [
        ("csc", {"use_pallas": True, "pallas_block_k": 8}, 1e-5),
        ("csc, registry projections", {}, 1e-5),  # (K, L) tiles through the segment-sum kernel
        ("butterfly", {"layout": "butterfly"}, 1e-5),
        ("butterfly compact", {"layout": "butterfly", "compact": True}, 1e-5),
        ("butterfly srow_gather", {"layout": "butterfly", "srow_gather": True}, 1e-5),
        ("butterfly compact srow_gather", {"layout": "butterfly", "compact": True, "srow_gather": True}, 1e-5),
        ("butterfly bf16 carry", {"layout": "butterfly", "carry_dtype": "bfloat16"}, 4e-2 * abs(GOLDEN[0][1])),
        ("row", {"layout": "row"}, 1e-5),
    ]
    for name, kwargs, tol in variants:
        log = solve(**kwargs)
        worst = max(abs(log[i - 1] - want) for i, want in GOLDEN)
        check(worst < tol, f"golden trace through {name}: deviation {worst} >= {tol}")
        say("golden", path=repr(name), iterations=len(log), max_abs_dev=worst, tolerance=tol, card=dev_name)


def ptxas_summary(logs) -> None:
    regs = [int(r) for log in logs.values() for r in re.findall(r"Used (\d+) registers", log)]
    say("build", kernels_compiled=len(regs), max_registers=max(regs, default="cached"))
    for log in logs.values():  # ptxas -v: name each kernel that spills registers
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            entry = m.group(1) if m else entry
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and int(m.group(1)) > 0:
                say("build", spilling_kernel=entry, spill_store_bytes=m.group(1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sources", type=int, default=2_500_000)
    ap.add_argument("--destinations", type=int, default=10_000)
    ap.add_argument("--sparsity", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--check-iters", type=int, default=20)
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of: " + ", ".join(ALL_PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in ALL_PHASES:
            ap.error(f"unknown phase {p!r}")
    full = set(phases) == set(ALL_PHASES)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import dualip_tpu_torch as dt
    import dualip_tpu_torch.objectives.matching as matching_mod
    import dualip_tpu_torch.ops.butterfly as bf
    import dualip_tpu_torch.ops.fused_matching as fm
    from dualip_tpu_torch.io import native_loader
    from dualip_tpu_torch.objectives.matching import (
        MatchingSolverDualObjectiveFunction,
        route_row_ids,
    )
    from dualip_tpu_torch.ops import _build
    from dualip_tpu_torch.ops.fused_matching import (
        fused_panel_project,
        fused_panel_project_reference,
        fused_tile_eval_T,
        fused_tile_eval_T_reference,
        num_partial_blocks,
    )
    from dualip_tpu_torch.ops.segment_sum import segment_sum_rows
    from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent
    from dualip_tpu_torch.synthetic import generate_synthetic_matching_input_args

    t_run = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    print(f"card: {card}", flush=True)
    dev_name = torch.cuda.get_device_name(0)
    say("device", torch=torch.__version__, cuda=torch.version.cuda, name=repr(dev_name),
        capability=torch.cuda.get_device_capability(0))

    # 2. build: one nvcc per source, all started together; then the native router
    t0 = time.perf_counter()
    logs = _build.build(_build.KERNEL_SOURCES)
    say("build", sources=list(_build.KERNEL_SOURCES), seconds=f"{time.perf_counter() - t0:.2f}")
    ptxas_summary(logs)
    t0 = time.perf_counter()
    say("build", native_router="built" if native_loader.native_available() else "unavailable (numpy router)",
        seconds=f"{time.perf_counter() - t0:.2f}")

    # 8a. generate the slice's data once, for both layouts
    need_data = "slice" in phases or "butterfly" in phases
    inp, gen_s, l_max = None, 0.0, 29
    if need_data:
        t0 = time.perf_counter()
        inp = generate_synthetic_matching_input_args(args.sources, args.destinations, args.sparsity, seed=args.seed)
        gen_s = time.perf_counter() - t0
        l_max = int(inp.A.col_lengths.max())
        say("generate", sources=args.sources, destinations=args.destinations, sparsity=args.sparsity,
            seed=args.seed, nnz=inp.A.nnz, max_column_degree=l_max, seconds=f"{gen_s:.2f}")

    check_err = {False: 0.0, True: 0.0}
    panel_err = {False: 0.0, True: 0.0}
    segsum_err = 0.0
    if "kernels" in phases:
        check_err = phase_kernels(sorted({1, 2, 8, 32, 100, l_max}), dev)
    if "segsum" in phases:
        segsum_err = phase_segsum(dev)
    if "benes" in phases:
        phase_benes(dev)
    if "panel" in phases:
        panel_err = phase_panel(dev)
    if "golden" in phases:
        phase_golden(dev_name)
    say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

    kernels = []
    solver_kw = dict(gamma=1e-3, initial_step_size=1e-3, max_step_size=1e-1)
    n_chk = min(args.check_iters, args.iters)
    captured = {}

    class Timed:
        """Records a CUDA event around each evaluation (no host sync)."""

        def calculate_traceable(self, params, dual_val, gamma):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            res = super().calculate_traceable(params, dual_val, gamma)
            e.record()
            self.events.append((s, e))
            return res

    class TimedMatching(Timed, MatchingSolverDualObjectiveFunction):
        pass

    @dt.register_objective("matching_smoke")
    def _factory(input_args, solver_args, compute_args, mesh, **kw):
        t = time.perf_counter()
        obj = TimedMatching(input_args, gamma=solver_args.gamma, device=compute_args.host_device, **kw)
        torch.cuda.synchronize()
        obj.events = []
        captured["obj"], captured["build_s"] = obj, time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats()
        return obj

    @dt.register_objective("matching_smoke_prebuilt")
    def _prebuilt(input_args, solver_args, compute_args, mesh, objective=None):
        objective.events = []
        return objective

    def reset_counts():
        fused_tile_eval_T.launches = fused_tile_eval_T.launches_x = 0
        fused_panel_project.launches = fused_panel_project.launches_x = 0
        bf.benes_fine.launches = bf.benes_coarse.launches = bf.benes_coarse2.launches = 0
        segment_sum_rows.launches = 0

    def counts():
        return {"K1": fused_tile_eval_T.launches, "K2": fused_tile_eval_T.launches_x,
                "K3": fused_panel_project.launches, "K4": fused_panel_project.launches_x,
                "K5": bf.benes_fine.launches, "K6": bf.benes_coarse.launches, "K7": bf.benes_coarse2.launches,
                "segsum": segment_sum_rows.launches}

    def solve(data, iters, save_primal, objective_type="matching_smoke", **objective_kwargs):
        """One solve through run_solver: (result, launches, seconds), counts set to 0 just before."""
        reset_counts()
        t = time.perf_counter()
        res = dt.run_solver(
            data, dt.SolverArgs(max_iter=iters, save_primal=save_primal, **solver_kw), dt.ComputeArgs(),
            dt.ObjectiveArgs(objective_type=objective_type, objective_kwargs=objective_kwargs),
        )
        torch.cuda.synchronize()
        return res, counts(), time.perf_counter() - t

    def first_iterations(objective, m):
        return np.array(AcceleratedGradientDescent(max_iter=n_chk, **solver_kw).maximize(
            objective, torch.zeros(m, device=dev)).dual_objective_log)

    def ms_per_iteration(ev):
        return ev[1][0].elapsed_time(ev[-1][1]) / (len(ev) - 1)

    def check_solution(res, obj, data, iters, what):
        log = res.dual_objective_log
        check(len(log) == iters and all(np.isfinite(log)), f"{what}: non-finite dual objective log")
        check(res.dual_val.device.type == "cuda" and bool(torch.isfinite(res.dual_val).all()),
              f"{what}: dual not finite on card")
        check(bool((res.dual_val >= 0).all()), f"{what}: dual left the nonnegative cone")
        check(log[-1] > log[0], f"{what}: the dual objective did not rise")
        x = res.objective_result.primal_var
        if x is not None:
            check(x.shape == (obj.bcsc.nnz,) and np.isfinite(x).all() and (x >= 0).all(), f"{what}: primal_var malformed")
            col_sums = np.add.reduceat(x, data.A.indptr[:-1][data.A.col_lengths > 0])
            check(col_sums.max() <= 1.0 + 1e-4, f"{what}: primal column sums exceed the simplex: {col_sums.max()}")

    csc_log = None
    # ------------------------------------------------------------------ 8. csc slice
    if "slice" in phases:
        res, n_launch, solve_s = solve(inp, args.iters, True, use_pallas=True)
        peak = torch.cuda.max_memory_allocated()
        obj = captured["obj"]
        ev = obj.events
        specs, tiles = obj.bcsc.specs, obj.bcsc.tiles
        n_tiles = len(tiles)
        slots = sum(s.L * s.K for s in specs)
        cols = sum(s.K for s in specs)
        nnz = obj.bcsc.nnz
        first_iter_ms = ev[0][0].elapsed_time(ev[0][1])
        ms_per_iter = ms_per_iteration(ev)
        log = csc_log = res.dual_objective_log
        say("slice", nnz=nnz, tiles=n_tiles, tile_shapes=[(s.L, s.K) for s in specs],
            max_bucket_L=max(s.L for s in specs), slots=slots, pad_ratio=f"{slots / nnz:.4f}")
        say("slice", generate_s=f"{gen_s:.2f}", objective_build_s=f"{captured['build_s']:.2f}",
            time_to_first_iteration_s=f"{captured['build_s'] + first_iter_ms / 1e3:.3f}",
            first_iteration_ms=f"{first_iter_ms:.3f}", run_solver_s=f"{solve_s:.2f}")
        say("slice", iterations=len(log), ms_per_iteration=f"{ms_per_iter:.4f}",
            iterations_per_s=f"{1e3 / ms_per_iter:.2f}", window="start of iteration 2 to end of the last evaluation",
            final_dual_objective=res.dual_objective, peak_device_bytes=peak)
        say("slice", launches=n_launch, expected_K1=n_tiles * args.iters, expected_K2=n_tiles,
            expected_segsum=n_tiles * (args.iters + 1))
        check_solution(res, obj, inp, args.iters, "csc slice")
        check(n_launch["K1"] == n_tiles * args.iters, f"K1 launches {n_launch['K1']} != tiles x iterations")
        check(n_launch["K2"] == n_tiles, f"K2 launches {n_launch['K2']} != tiles {n_tiles}")
        check(n_launch["segsum"] == n_tiles * (args.iters + 1), f"segment-sum launches {n_launch['segsum']}")
        csc_launches = n_launch

        # The solve again, whole: the fixed-order segment-sum makes it repeat itself.
        res2, _, _ = solve(inp, args.iters, False, objective_type="matching_smoke_prebuilt", objective=obj)
        repeat_dev = rel_dev(res2.dual_objective_log, log)
        say("slice", repeat_of_the_solve="bit-identical" if repeat_dev.max() == 0 else "DIFFERS",
            max_rel_dev_fused_repeat=float(repeat_dev.max()), final_dual_objective_again=res2.dual_objective)
        check(repeat_dev.max() == 0.0 and res2.dual_objective == res.dual_objective,
              f"two csc solves differ by {repeat_dev.max()} relative")

        # The first iterations again, with K1's plain version on the card (same
        # tiles, the same segment-sum kernel on both sides).
        class PlainTiles(MatchingSolverDualObjectiveFunction):
            def _local(self, bcsc, dual_val, gamma, want_primal=False, row_layout=None):
                plain_eval = lambda *a, block_k, want_x: fused_tile_eval_T_reference(*a, want_x=want_x)  # noqa: E731
                with rebound(fm, fused_tile_eval_T=plain_eval):
                    return super()._local(bcsc, dual_val, gamma, want_primal, row_layout)

        plain = PlainTiles.__new__(PlainTiles)
        plain.__dict__.update({k: v for k, v in obj.__dict__.items() if k != "events"})
        g_t = torch.full((), 1e-3, dtype=torch.float32, device=dev)
        plain_dev = rel_dev(first_iterations(plain, obj.bcsc.m), log[:n_chk])
        r_f = obj.calculate_traceable(obj.params, res.dual_val, g_t)
        r_p = plain.calculate_traceable(plain.params, res.dual_val, g_t)
        say("slice", plain_check_iterations=n_chk, max_rel_dev_vs_plain=float(plain_dev.max()), tolerance=1e-4)
        say("slice", rel_dev_vs_plain_per_iteration=",".join(f"{v:.2e}" for v in plain_dev))
        check(plain_dev.max() <= 1e-4, f"fused vs plain dual-objective logs differ by {plain_dev.max()} relative")
        # at one dual: objective to 1e-5 relative, gradient to 1e-4 of its largest entry
        same_obj = abs(float(r_f.dual_objective) - float(r_p.dual_objective)) / max(1.0, abs(float(r_p.dual_objective)))
        same_grad = float((r_f.dual_gradient - r_p.dual_gradient).abs().max() / r_p.dual_gradient.abs().max())
        say("slice", same_dual_rel_dev_objective=same_obj, same_dual_rel_dev_gradient=same_grad)
        check(same_obj <= 1e-5 and same_grad <= 1e-4, f"fused vs plain at one dual: {same_obj}, {same_grad}")

        # Each kernel on the slice's tiles at the final dual: error, time, bound.
        nig = torch.full((), -1.0 / 1e-3, dtype=torch.float32, device=dev)
        scaled = nig * res.dual_val
        rows = [t.rows.reshape(-1) for t in tiles]
        lam_g = [scaled.index_select(0, r).view(t.a.shape) for r, t in zip(rows, tiles)]

        def run(fn, want_x):
            return [
                fn(lam_g[i], t.a, t.c, t.length, nig, s.proj_type, s.proj_params, block_k=1024, want_x=want_x)
                if fn is fused_tile_eval_T
                else fn(lam_g[i], t.a, t.c, t.length, nig, s.proj_type, s.proj_params, want_x=want_x)
                for i, (t, s) in enumerate(zip(tiles, specs))
            ]

        for name, want_x, replaces in (
            ("K1 fused_tile_eval_T", False, "dualip_tpu/ops/pallas_matching.py:141"),
            ("K2 fused_tile_eval_T want_x", True, "dualip_tpu/ops/pallas_matching.py:159"),
        ):
            got, ref = run(fused_tile_eval_T, want_x), run(fused_tile_eval_T_reference, want_x)
            err = check_err[want_x]
            for g, r in zip(got, ref):
                tol = tol_x(r[3] if want_x else r[0])
                e = float((g[0] - r[0]).abs().max())
                if want_x:
                    e = max(e, float((g[3] - r[3]).abs().max()))
                check(e <= tol, f"{name} on slice tile: err {e} > {tol}")
                for i in (1, 2):
                    check(abs(float(g[i]) - float(r[i])) <= 1e-3 + 1e-4 * abs(float(r[i])), f"{name} sums on slice tile")
                err = max(err, e)
            del got, ref
            ms = cuda_ms(lambda: run(fused_tile_eval_T, want_x), reps=20)
            plain_ms = cuda_ms(lambda: run(fused_tile_eval_T_reference, want_x), reps=3, warmup=1)
            nbytes = slots * (20 if want_x else 16) + cols * 4
            nops = sum(s.L * s.K * ops_per_slot(s.proj_type) for s in specs)
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_FLOP_PER_S * 1e3
            biggest = max(range(n_tiles), key=lambda i: specs[i].L * specs[i].K)
            big = specs[biggest]
            say("timing", kernel=repr(name), per_iteration_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}",
                bound_ms=f"{max(t_bytes, t_ops):.4f}", bytes=nbytes, ops=nops, largest_tile=(big.L, big.K),
                partial_blocks=num_partial_blocks(big.proj_type, big.L, big.K))
            kernels.append({
                "name": name, "route": "cuda", "source": "dualip_tpu_torch/csrc/fused_matching.cu",
                "replaces": replaces, "launches": csc_launches["K2" if want_x else "K1"], "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,  # no single PyTorch call computes the projection
            })

        # The torch ops around the kernel on the main path, and the segment-sum
        # on each tile's own a*x (K1's output at the final dual): against a
        # float64 index_add_, and two launches bit for bit.
        orders = obj.bcsc.row_orders
        axs = [g[0] for g in run(fused_tile_eval_T, False)]
        seg_err = 0.0
        for ax, t, ro, r, s_ in zip(axs, tiles, orders, rows, specs):
            got = segment_sum_rows(torch.zeros(obj.bcsc.m, device=dev), ax, t.rows, ro)
            again = segment_sum_rows(torch.zeros(obj.bcsc.m, device=dev), ax, t.rows, ro)
            v64 = ax.reshape(-1).double()
            ref = torch.zeros(obj.bcsc.m, dtype=torch.float64, device=dev).index_add_(0, r, v64)
            scale = float(torch.zeros(obj.bcsc.m, dtype=torch.float64, device=dev).index_add_(0, r, v64.abs()).max())
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"segment-sum on slice tile {(s_.L, s_.K)}: two launches differ")
            e = float((got.double() - ref).abs().max())
            check(e <= 1e-5 * max(1.0, scale), f"segment-sum on slice tile {(s_.L, s_.K)}: err {e} vs sum|v| {scale}")
            seg_err = max(seg_err, e)
            del got, again, v64, ref
        say("slice", segment_sum_on_slice_tiles=[(s_.L, s_.K) for s_ in specs], rows=obj.bcsc.m,
            max_abs_err_vs_float64=seg_err, tolerance="1e-5*max(1, max row sum of |v|)", repeat="bit-identical",
            max_abs_err_synthetic_shapes=segsum_err)
        grad = torch.zeros(obj.bcsc.m, device=dev)
        gather_ms = cuda_ms(lambda: [scaled.index_select(0, r) for r in rows], reps=20)
        seg_ms = cuda_ms(lambda: [segment_sum_rows(grad, ax, t.rows, ro) for ax, t, ro in zip(axs, tiles, orders)], reps=20)
        atomic_ms = cuda_ms(lambda: [grad.index_add_(0, r, ax.view(-1)) for r, ax in zip(rows, axs)], reps=5)
        seg_bound = nnz * 8 / PEAK_BYTES_PER_S * 1e3
        say("timing", gather_index_select_ms=f"{gather_ms:.4f}", segment_sum_kernel_ms=f"{seg_ms:.4f}",
            segment_sum_bound_ms=f"{seg_bound:.4f}", index_add_atomic_ms=f"{atomic_ms:.4f}",
            K1_ms=f"{kernels[0]['ms']:.4f}", iteration_ms=f"{ms_per_iter:.4f}",
            rest_ms=f"{ms_per_iter - gather_ms - seg_ms - kernels[0]['ms']:.4f}")
        kernels.append({
            "name": "segment_sum_rows", "route": "cuda", "source": "dualip_tpu_torch/csrc/segment_sum.cu",
            "replaces": "none: XLA's segment_sum at dualip_tpu/objectives/matching.py:182, outside any TPU kernel",
            "launches": csc_launches["segsum"], "max_abs_err": seg_err, "ms": seg_ms,
            "plain_ms": atomic_ms,  # the plain version is index_add_
            "bound_ms": seg_bound, "bound_by": "bytes", "library_ms": atomic_ms,
        })
        del lam_g, axs, obj, plain, captured["obj"], res, res2, r_f, r_p
        torch.cuda.empty_cache()
        say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

    # ------------------------------------------------------------------ 9. butterfly slice
    if "butterfly" in phases:
        class PlainButterfly(MatchingSolverDualObjectiveFunction):
            """The same layout with every kernel's plain version, on the card."""

            def _local(self, bcsc, dual_val, gamma, want_primal=False, row_layout=None):
                def plain_carry(rl, vec, reverse, truncate=True):
                    p = rl.plan
                    pre, post = list(zip(p.pre_groups, p.pre_masks)), list(zip(p.post_groups, p.post_masks))
                    if reverse:
                        pre, post = ([((st[::-1], E, I), mk) for (st, E, I), mk in reversed(post)],
                                     [((st[::-1], E, I), mk) for (st, E, I), mk in reversed(pre)])
                    v = vec
                    for side in (pre, None, post):
                        if side is None:
                            v = bf.benes_fine_reference(v, p.fine_masks, p.fine_dists, reverse)
                            continue
                        for (st, E, I), mk in side:
                            v = bf.benes_coarse2_reference(v, mk, st, *E, I) if isinstance(E, tuple) else \
                                bf.benes_coarse_reference(v, mk, st, E, I)
                    return v if not truncate else v[: (p.n_in if reverse else p.n_out)]

                with rebound(matching_mod, _carry=plain_carry), \
                        rebound(fm, fused_panel_project=fused_panel_project_reference):
                    return super()._local(bcsc, dual_val, gamma, want_primal, row_layout)

        def variant(obj, cls=None, **attrs):
            """A shallow copy of a built objective with some attributes replaced."""
            new = (cls or type(obj)).__new__(cls or type(obj))
            new.__dict__.update({k: v for k, v in obj.__dict__.items() if k != "events"})
            new.events = []
            for k, v in attrs.items():
                setattr(new, k, v)
            return new

        def butterfly_solve(data, sources, what, expect_coarse):
            """The solve, its counts, the plain-version and repeat checks."""
            res, n_launch, solve_s = solve(data, args.iters, True, layout="butterfly")
            peak = torch.cuda.max_memory_allocated()
            obj = captured["obj"]
            rl, plan = obj.row_layout, obj.row_layout.plan
            n_tiles = len(rl.col_tiles_T)
            nb = plan.N >> plan.block_log2
            evals = args.iters + 1  # the iterations and the save_primal evaluation
            groups = [("K7" if isinstance(g[1], tuple) else "K6") for g in plan.pre_groups + plan.post_groups]
            say(what, sources=sources, nnz=obj.bcsc.nnz, carry_slots=plan.N, block_log2=plan.block_log2, blocks=nb,
                stages=len(plan.fine_dists) + sum(len(g[0]) for g in plan.pre_groups + plan.post_groups),
                fine_stages=len(plan.fine_dists), coarse_groups=groups, row_tiles=len(rl.row_tiles),
                row_slots=sum(R * Lr for R, Lr in rl.row_shapes), col_offsets=rl.col_offsets,
                mask_bytes=plan.fine_masks.numel() + sum(m.numel() for m in plan.pre_masks + plan.post_masks))
            say(what, objective_build_s=f"{captured['build_s']:.2f}", layout_build_s=f"{rl.build_seconds['total']:.2f}",
                routing_s=f"{rl.build_seconds['route']:.2f}", router=bf.last_route.get("router"),
                run_solver_s=f"{solve_s:.2f}", peak_device_bytes=peak)
            ms_it = ms_per_iteration(obj.events)
            say(what, iterations=len(res.dual_objective_log), ms_per_iteration=f"{ms_it:.4f}",
                iterations_per_s=f"{1e3 / ms_it:.2f}", final_dual_objective=res.dual_objective)
            want = {"K3": n_tiles * args.iters, "K4": n_tiles, "K5": 2 * evals, expect_coarse: 4 * evals}
            say(what, launches=n_launch, expected=want)
            check_solution(res, obj, data, args.iters, what)
            for k, v in want.items():
                check(n_launch[k] == v, f"{what}: {k} launches {n_launch[k]} != {v}")
            check(n_launch["K1"] == 0 and n_launch["segsum"] == 0, f"{what}: the csc kernels ran: {n_launch}")
            log = np.asarray(res.dual_objective_log)
            plain_dev = rel_dev(first_iterations(variant(obj, PlainButterfly), obj.bcsc.m), log[:n_chk])
            say(what, plain_check_iterations=n_chk, max_rel_dev_vs_plain=float(plain_dev.max()), tolerance=1e-5)
            check(plain_dev.max() <= 1e-5, f"{what}: kernels vs plain versions differ by {plain_dev.max()} relative")
            res2, _, _ = solve(data, args.iters, False, objective_type="matching_smoke_prebuilt", objective=obj)
            rep = rel_dev(res2.dual_objective_log, log)
            say(what, repeat_of_the_solve="bit-identical" if rep.max() == 0 else "DIFFERS", max_rel_dev=float(rep.max()))
            check(rep.max() == 0.0, f"{what}: two butterfly solves differ by {rep.max()} relative")
            return res, obj, n_launch, ms_it

        res, obj, bfly_launches, bfly_ms = butterfly_solve(inp, args.sources, "butterfly", "K7")
        log = np.asarray(res.dual_objective_log)
        if csc_log is not None:
            vs_csc = rel_dev(log[:n_chk], csc_log[:n_chk])
            say("butterfly", max_rel_dev_vs_csc_first_iterations=float(vs_csc.max()), tolerance=1e-4,
                final_dual_csc=csc_log[-1], final_dual_butterfly=float(log[-1]))
            check(vs_csc.max() <= 1e-4, f"butterfly vs csc logs differ by {vs_csc.max()} relative")

        # Options on the same layout, 20 iterations each, timed.
        def timed_variant(name, objective):
            r, n_launch, _ = solve(inp, n_chk, False, objective_type="matching_smoke_prebuilt", objective=objective)
            ms_it = ms_per_iteration(objective.events)
            dev_log = rel_dev(r.dual_objective_log, log[:n_chk])
            say("butterfly", option=repr(name), iterations=n_chk, ms_per_iteration=f"{ms_it:.4f}",
                max_rel_dev_vs_fp32_butterfly=float(dev_log.max()), launches=n_launch)
            return dev_log.max(), n_launch

        d, _ = timed_variant("carry_dtype=bfloat16", variant(obj, carry_dtype=torch.bfloat16))
        check(d <= 4e-2, f"bf16 carry drifts {d} relative from the fp32 carry")
        rl_gather = copy.copy(obj.row_layout)
        t0 = time.perf_counter()
        rl_gather.srow_colidx = route_row_ids(obj.row_layout, obj.bcsc.m)
        torch.cuda.synchronize()
        say("butterfly", srow_colidx_setup_s=f"{time.perf_counter() - t0:.3f}")
        d, n_launch = timed_variant("srow_gather=True", variant(obj, row_layout=rl_gather, srow_gather=True))
        check(d == 0.0, f"srow_gather is not bit-identical to the routed srow: {d}")
        check(n_launch["K5"] == n_chk, f"srow_gather: K5 launches {n_launch['K5']} != {n_chk} (reverse carry only)")
        del rl_gather

        # ---- each kernel timed at the slice's shapes
        rl, plan = obj.row_layout, obj.row_layout.plan
        N = plan.N
        nig = torch.full((), -1.0 / 1e-3, dtype=torch.float32, device=dev)
        buf = torch.from_numpy(np.random.default_rng(5).normal(size=N).astype(np.float32)).to(dev)
        ids = torch.arange(N, dtype=torch.int32, device=dev)

        def time_benes(name, replaces, fn, ref_fn, mask_planes, n_launches):
            """ms of one launch group, the plain version's, the bound, and the
            library call: index_select by the group's own permutation."""
            src = fn(ids.clone())  # the kernel moves 4-byte payloads of any type
            check(torch.equal(src, ref_fn(ids)), f"{name}: kernel differs from its plain version at the slice's shape")
            ms = cuda_ms(lambda: fn(buf), reps=10)
            plain_ms = cuda_ms(lambda: ref_fn(buf), reps=2, warmup=1)
            lib_ms = cuda_ms(lambda: buf.index_select(0, src), reps=5)
            bound = N * (8 + mask_planes) / PEAK_BYTES_PER_S * 1e3
            say("timing", kernel=repr(name), ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.4f}",
                library_index_select_ms=f"{lib_ms:.4f}", mask_planes=mask_planes, slots=N)
            kernels.append({
                "name": name, "route": "cuda", "source": "dualip_tpu_torch/csrc/benes.cu", "replaces": replaces,
                "launches": n_launches, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes", "library_ms": lib_ms,
            })
            return ms

        k5_ms = time_benes(
            "K5 benes_fine", "dualip_tpu/ops/butterfly.py:520",
            lambda v: bf.benes_fine(v, plan.fine_masks, plan.fine_dists),
            lambda v: bf.benes_fine_reference(v, plan.fine_masks, plan.fine_dists),
            plan.fine_masks.shape[0], bfly_launches["K5"])
        (steps7, E7, R7), m7 = plan.pre_groups[0], plan.pre_masks[0]
        check(isinstance(E7, tuple), "the slice's coarse side is not a two-axis group")
        k7_ms = time_benes(
            "K7 benes_coarse2", "dualip_tpu/ops/butterfly.py:606",
            lambda v: bf.benes_coarse2(v, m7, steps7, *E7, R7),
            lambda v: bf.benes_coarse2_reference(v, m7, steps7, *E7, R7),
            m7.shape[0], bfly_launches["K7"])
        carry_src = bf.apply_butterfly_cuda(plan, ids.clone(), truncate=False)
        carry_ms = cuda_ms(lambda: bf.apply_butterfly_cuda(plan, buf, truncate=False), reps=10)
        carry_lib_ms = cuda_ms(lambda: buf.index_select(0, carry_src), reps=5)
        say("timing", whole_carry_ms=f"{carry_ms:.4f}", K5_plus_two_K7_ms=f"{k5_ms + 2 * k7_ms:.4f}",
            library_one_index_select_ms=f"{carry_lib_ms:.4f}", slots=N)
        del carry_src, ids

        packs = rl.col_pack if rl.col_pack is not None else (None,) * len(rl.col_tiles_T)
        specs = obj.bcsc.specs

        def run_panel(fn, want_x, b):
            return [fn(b, pt.a, pt.c, pt.length, off, s.proj_type, s.proj_params, want_x=want_x,
                       neg_inv_gamma=nig, pack=pk)
                    for pt, s, off, pk in zip(rl.col_tiles_T, specs, rl.col_offsets, packs)]

        real = sum(pt.a.numel() for pt in rl.col_tiles_T)
        ghost = sum(pt.a.shape[0] * (1 << max(pt.a.shape[1] - 1, 0).bit_length()) * 128 - pt.a.numel()
                    for pt in rl.col_tiles_T)
        cols = sum(pt.length.numel() for pt in rl.col_tiles_T)
        for name, want_x, replaces in (
            ("K3 fused_panel_project", False, "dualip_tpu/ops/pallas_matching.py:305"),
            ("K4 fused_panel_project want_x", True, "dualip_tpu/ops/pallas_matching.py:287"),
        ):
            srow = buf * 0.01
            got = run_panel(fused_panel_project, want_x, srow.clone())
            ref = run_panel(fused_panel_project_reference, want_x, srow.clone())
            e = float((got[-1][0] - ref[-1][0]).abs().max())  # the buffer after all tiles
            tol = tol_x(ref[-1][0])
            if want_x:
                e = max([e] + [float((g[3] - r[3]).abs().max()) for g, r in zip(got, ref)])
            check(e <= tol, f"{name} on the slice's tiles: err {e} > {tol}")
            for g, r in zip(got, ref):
                for i in (1, 2):
                    check(abs(float(g[i]) - float(r[i])) <= 1e-3 + 1e-4 * abs(float(r[i])), f"{name} sums on slice tile")
            del got, ref
            ms = cuda_ms(lambda: run_panel(fused_panel_project, want_x, srow), reps=10)
            plain_ms = cuda_ms(lambda: run_panel(fused_panel_project_reference, want_x, srow), reps=2, warmup=1)
            nbytes = real * (20 if want_x else 16) + ghost * 4 + cols * 4
            nops = sum(pt.a.numel() * ops_per_slot(s.proj_type) for pt, s in zip(rl.col_tiles_T, specs))
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_FLOP_PER_S * 1e3
            say("timing", kernel=repr(name), per_iteration_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}",
                bound_ms=f"{max(t_bytes, t_ops):.4f}", bytes=nbytes, ops=nops, real_slots=real, ghost_slots=ghost)
            kernels.append({
                "name": name, "route": "cuda", "source": "dualip_tpu_torch/csrc/panel_matching.cu",
                "replaces": replaces, "launches": bfly_launches["K4" if want_x else "K3"],
                "max_abs_err": max(e, panel_err[want_x]), "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,  # no single PyTorch call computes the projection
            })
            del srow
        k3_ms = kernels[-2]["ms"]
        say("timing", butterfly_iteration_ms=f"{bfly_ms:.4f}", two_carries_ms=f"{2 * carry_ms:.4f}", K3_ms=f"{k3_ms:.4f}",
            rest_ms=f"{bfly_ms - 2 * carry_ms - k3_ms:.4f}", rest="srow build, row sums, (m,) gather, calc_grad, AGD step")
        del buf, obj, res, captured["obj"], rl, plan, m7
        torch.cuda.empty_cache()
        say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

        # ---- compact packing on the same data, 20 iterations
        r_c, n_launch, _ = solve(inp, n_chk, False, layout="butterfly", compact=True, keep_col_tiles=False,
                                 keep_flat_idx=False)
        obj_c = captured["obj"]
        rl_c = obj_c.row_layout
        d = rel_dev(r_c.dual_objective_log, log[:n_chk]).max()
        say("butterfly", option="'compact=True'", iterations=n_chk, ms_per_iteration=f"{ms_per_iteration(obj_c.events):.4f}",
            carry_slots=rl_c.plan.N, tiles=len(rl_c.col_tiles_T), packs_L_L2_q=rl_c.col_pack,
            objective_build_s=f"{captured['build_s']:.2f}", routing_s=f"{rl_c.build_seconds['route']:.2f}",
            max_rel_dev_vs_plain_panels=float(d), launches=n_launch)
        check(d <= 1e-4, f"compact packing drifts {d} relative from the plain panels")
        check(n_launch["K3"] == len(rl_c.col_tiles_T) * n_chk, f"compact: K3 launches {n_launch['K3']}")
        del obj_c, rl_c, r_c, captured["obj"]
        torch.cuda.empty_cache()

        # ---- the smaller solve: nb <= 256, one single-axis group a side (K6)
        t0 = time.perf_counter()
        small = generate_synthetic_matching_input_args(
            SMALL_SOURCES, args.destinations, args.sparsity, seed=args.seed)
        say("butterfly-small", generate_s=f"{time.perf_counter() - t0:.2f}")
        res_s, obj_s, small_launches, _ = butterfly_solve(small, SMALL_SOURCES, "butterfly-small", "K6")
        plan = obj_s.row_layout.plan
        N = plan.N
        buf = torch.from_numpy(np.random.default_rng(6).normal(size=N).astype(np.float32)).to(dev)
        ids = torch.arange(N, dtype=torch.int32, device=dev)
        (steps6, E6, I6), m6 = plan.pre_groups[0], plan.pre_masks[0]
        time_benes(
            "K6 benes_coarse", "dualip_tpu/ops/butterfly.py:568",
            lambda v: bf.benes_coarse(v, m6, steps6, E6, I6),
            lambda v: bf.benes_coarse_reference(v, m6, steps6, E6, I6),
            m6.shape[0], small_launches["K6"])
        del buf, ids, obj_s, res_s, plan, m6, captured["obj"]
        say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

    if not full:
        say("done", phases=phases, note="a partial run prints no result lines")
        return 0
    order = {n: i for i, n in enumerate(("K1", "K2", "K3", "K4", "K5", "K6", "K7", "segment_sum_rows"))}
    kernels.sort(key=lambda k: order[k["name"].split()[0]])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
