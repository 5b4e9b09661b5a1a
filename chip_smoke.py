#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dualip_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--sources N] [--iters N] [--phases a,b,...]

Phases, one output line or more each (``--phases`` runs a subset; the two
result lines at the end are printed only by a run of every default phase):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile every hand-written kernel from this checkout (one ``nvcc``
   per source, all started together) and the native Benes router (``g++``);
3. kernels: the fused tile kernel (K1/K2) against its plain PyTorch version on
   the card, for every projection kind, at L in {1, 2, 8, 16, 32, 100, 29},
   and its gather form against its lam_g form bit for bit at m = 64, 10,000
   and 70,000;
4. segsum: the windowed fixed-order row segment-sum over several tiles at
   once against a float64 ``index_add_``, and two launches bit for bit;
5. benes: the three Benes kernels (K5 fine and K7 two-axis coarse side, the
   gathers through the plan's source index; K6 coarse group, stage windows)
   against the plain stages with ``torch.equal``, forward and reverse, fp32
   and bf16, in every regime of the block count, and the index the window
   kernels build on the card against the index the plain stages build;
6. panel: the panel kernel (K3/K4) one tile a launch against its plain
   version for every projection kind, q = 1 and q > 1, L a power of two and
   not, either side of the largest L the kernel's ring holds (47, 57, 71 or
   95 by carry and tile type), in all four instances: fp32 and bf16 carry x
   fp32 and bf16 a/c tiles, a bf16 tile's launch bit for bit with the fp32
   launch on the same values; the rest of the buffer unchanged, ghost lanes
   zero; then all tiles of a mixed table (L = 1, 2, 5, 16, 29, 48, 64, 100
   plain, 3, 29, 34 compact, the kinds mixed across tiles) in one launch, in
   all four instances, against the plain version, against one launch per
   tile bit for bit on a*x and x, and repeated bit for bit on (obj, reg);
7. golden: the 5x5 matching golden trace through ``run_solver`` on the card,
   csc layout and butterfly layout (plain, compact, ``srow_gather``, bf16);
8. slice: the synthetic matching LP (2,500,000 sources x 10,000 destinations,
   sparsity 1e-3, seed 42) through ``run_solver`` on the csc layout with the
   fused kernel in its gather form, its launches counted, its first 20
   iterations repeated with the plain version and compared, a repeat that must
   be bit-identical, the gather form held against the lam_g form bit for bit
   and the segment-sum against a float64 ``index_add_`` and against its plain
   version (bit for bit) on the tiles' own a*x,
   each kernel timed on the slice's tiles beside its plain version and bound,
   and a ``torch.profiler`` window over 10 iterations (device busy share,
   kernels by name, no per-iteration ``index_select``); then tiles in bf16
   (``dtype="bfloat16"``, the plain csc path) for 20 iterations against the
   segment-sum's plain version (bit for bit) and beside the fp32 tiles' run;
9. butterfly: the same data through ``run_solver`` with
   ``layout="butterfly"``: launches counted, plain versions compared, the csc
   log compared, a bit-identical repeat, a 250,000-source solve (the K6
   regime), then ``compact``, ``carry_dtype=bfloat16`` and ``srow_gather``,
   each kernel timed at the slice's shapes (K5 and K7 beside their window
   forms, which build the index, and K7 at 32 B rows as well as 64 B; K3/K4
   in one launch for all tiles beside one launch per tile, and each tile
   alone, on the plain and the compact packing), and ``torch.profiler``
   windows over 10 butterfly and 10 compact iterations; then tiles in bf16
   for 20 iterations (K3/K4's bf16-tile instances, timed and bounded) against
   the plain versions and beside the fp32 tiles' run;
10. cert: the exact matching certificate at the csc solve's final dual on
   the csc and butterfly layouts (they agree to 1e-3 relative) and at the
   butterfly solve's own dual: ``dual_lb <= primal_ub`` and its time;
11. lp: the general LP through ``run_solver(objective_type="miplib2017")``:
   the bundled MIPLIB instance v150d30 (10,000 iterations on the COO layout,
   the dual at 27 +- 1, a bit-identical repeat, the butterfly layout on the
   whole instance against COO per ``calculate``, the PDLP bound), and the
   slice's matrix as an LP in the box [0, 1] with c ~ U(-1, 0) (lp-2.5M: COO
   200 iterations and butterfly 50, timed and profiled, COO repeated bit for
   bit, the layouts against each other per ``calculate``);
12. io: the I/O tiers at the slice's shape on the native generator's data
   (the native library must build), in a fresh temporary cache directory:
   generation timed beside the numpy generator, a warm load equal to the cold
   arrays, the native tile fill equal to the numpy fill (both timed), and the
   butterfly objective built cold (routing, plan and tile caches written) and
   warm (from the tile cache): each one's time to first iteration, K3, K5, K7
   and the index-building window kernels launched on the warm objective, and
   the two 20-iteration dual logs bit-identical;
13. obs: ``run_solver`` with MLflow enabled completes (a no-op without
   mlflow) and gives the log of the solve without it, ``trace`` around three
   csc iterations writes a trace naming K1's and the segment-sum's kernels and
   the ``annotate`` span, and ``collect_stats`` fills ``last_run_stats``.

Opt-in, not in the default list (its host work exceeds the default run's
budget): ``--phases canonical`` generates the canonical shape (25,000,000
sources) with the native generator, checks its nnz against the JAX package's
canonical run exactly (249,665,824) and holds the csc solve's 200-iteration
dual within 1e-2 relative of that run's fp32 dual (-1,421,878.75).

Kernel times (``ms``) are CUDA-graph replays of the wrapper's calls, so the
host's launch gaps are not in them; each ``[timing]`` line also gives the eager
loop's device time, the host's time to enqueue it and ``host_bound``.

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
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12  # counts an FMA as two operations
# fp32 operations that are not FMAs (the bisection's subtract, max and add):
# one per lane and clock, 132 SMs x 128 lanes x 1.98 GHz
NON_FMA_OPS_PER_S = 132 * 128 * 1.98e9
BISECTION_ITERS = 30

SMALL_SOURCES = 250_000  # the second butterfly solve: few enough blocks for one single-axis group a side
ALL_PHASES = ("kernels", "segsum", "benes", "panel", "golden", "slice", "butterfly", "cert", "lp", "io", "obs")
OPT_IN_PHASES = ("canonical",)  # host time beyond the default run's budget: run alone
CANONICAL_SOURCES = 25_000_000
# benchmark/results/canonical_250m.json: the native generator's nnz at the
# canonical shape and the JAX package's fp32 dual after 200 iterations
CANONICAL_NNZ = 249_665_824
CANONICAL_DUAL = -1_421_878.75

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


class Timing(NamedTuple):
    ms: float  # device time per run: CUDA-graph replays when graphed, else the eager loop
    eager_ms: float  # device time per run, launched from Python one run after another
    host_ms: float  # host time to enqueue one run in that eager loop
    reps: int

    @property
    def host_bound(self) -> bool:
        """The eager loop's device time is the host's: while the host
        enqueues, the card waits, so the two come out about equal."""
        return self.host_ms >= 0.9 * self.eager_ms


def cuda_ms(fn, reps: int, warmup: int = 2, window_ms: float = 10.0, graph: bool = False) -> Timing:
    """Device time of ``fn`` between CUDA events, and the host's time to
    enqueue it, over at least ``reps`` runs and over enough runs to fill
    ``window_ms``.  ``graph=True`` also captures one run in a CUDA graph and
    times its replays: the device time without the host's gaps between
    launches (``fn`` must not synchronise)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = int(min(5000, max(reps, np.ceil(window_ms / max(start.elapsed_time(end), 1e-3)))))
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / reps
    ms = eager
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        g.replay()
        start.record()
        for _ in range(reps):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        del g
    return Timing(ms, eager, host * 1e3 / reps, reps)


def timing_kv(t: Timing) -> dict:
    return {"eager_ms": f"{t.eager_ms:.4f}", "host_enqueue_ms": f"{t.host_ms:.4f}",
            "host_over_device": f"{t.host_ms / t.eager_ms:.3f}", "reps": t.reps, "host_bound": t.host_bound}


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
    """K1/K2: every (kind, params) case at each width and both want_x, kernel
    vs plain, and the gather form against the lam_g form bit for bit, at
    m = 64, 10,000 and 70,000 (a 280 KB table, more than L1 holds), the last
    with K = 4102 (4 B copies and a ragged last slab)."""
    from dualip_tpu_torch.ops.fused_matching import (
        fused_tile_eval_T,
        fused_tile_eval_T_reference,
        fused_tile_gather_eval_T,
    )

    rng = np.random.default_rng(0)
    err = {False: 0.0, True: 0.0}
    n = 0
    for kind, params in CASES:
        for L in widths:
            for m, K, block_k in ((64, 4 * 1024, 1024), (10_000, 4 * 1024, 1024), (70_000, 4102, 2051)):
                a = np.abs(rng.normal(size=(L, K))).astype(np.float32)
                c = -np.abs(rng.normal(size=(L, K))).astype(np.float32)
                length = rng.integers(1, L + 1, size=K).astype(np.int32)
                length[-5:] = 0
                mask = np.arange(L)[:, None] < length[None, :]
                a, c = np.where(mask, a, 0).astype(np.float32), np.where(mask, c, 0).astype(np.float32)
                lam = np.abs(rng.normal(size=m)).astype(np.float32)
                rows = torch.from_numpy(rng.integers(0, m, size=(L, K)).astype(np.int32)).to(dev)
                t = [torch.from_numpy(v).to(dev) for v in (a, c, length)]
                for scale in (-100.0, -2.0):
                    scaled = torch.from_numpy(np.float32(scale) * lam).to(dev)
                    lam_g = scaled[rows.long()]
                    for want_x in (False, True):
                        name = f"{kind}{params} L={L} m={m} K={K} want_x={want_x}"
                        got = fused_tile_eval_T(lam_g, *t, scale, kind, params, block_k=block_k, want_x=want_x)
                        gat = fused_tile_gather_eval_T(scaled, rows, *t, scale, kind, params, block_k=block_k,
                                                       want_x=want_x)
                        ref = fused_tile_eval_T_reference(lam_g, *t, scale, kind, params, want_x=want_x)
                        torch.cuda.synchronize()
                        check(all(torch.equal(u, v) for u, v in zip(got, gat)),
                              f"{name}: the gather form differs from the lam_g form")
                        tol = tol_x(ref[3] if want_x else ref[0])
                        e_ax = float((got[0] - ref[0]).abs().max())
                        e = e_ax
                        check(e_ax <= tol, f"{name}: |ax| err {e_ax} > {tol}")
                        if want_x:
                            e_x = float((got[3] - ref[3]).abs().max())
                            check(e_x <= tol, f"{name}: |x| err {e_x} > {tol}")
                            e = max(e, e_x)
                        for i, nm in ((1, "obj"), (2, "reg")):
                            g, r = float(got[i]), float(ref[i])
                            check(abs(g - r) <= 1e-3 + 1e-4 * abs(r), f"{name}: {nm} {g} vs {r}")
                        err[want_x] = max(err[want_x], e)
                        n += 1
    say("kernels", cases=n, widths=list(widths), m_K=[(64, 4096), (10_000, 4096), (70_000, 4102)],
        max_abs_err_K1=err[False], max_abs_err_K2=err[True],
        tolerance="ax,x: 5e-5*max(1,max|x|); obj,reg: 1e-3+1e-4*|ref|",
        gather_vs_lam_g_form="bit for bit in every case")
    return err


def phase_segsum(dev) -> float:
    """The windowed segment-sum against a float64 index_add_, two launches bit
    for bit; padding slots hold NaN, which the kernel must never read."""
    from dualip_tpu_torch.ops.segment_sum import segment_sum_rows
    from dualip_tpu_torch.sparse.bcsc import build_row_sum_plan

    rng = np.random.default_rng(1)
    worst = 0.0
    # (m, (L, K) tiles?, tiles as (K, L), window bytes)
    cases = [
        (1000, True, ((1 << 16, 16), (3000, 2)), 16 << 20),
        (1000, True, ((1 << 16, 16), (3000, 2)), 1 << 16),  # 64 KB windows: many of them
        (70_000, False, ((1 << 15, 5), (100, 1)), 16 << 20),
        (7, True, ((16384, 3),), 16 << 20),  # rows cut into segments
    ]
    for m, transposed, shapes, window_bytes in cases:
        rows_l, len_l, vals_l, valid_l = [], [], [], []
        for K, L in shapes:
            length = rng.integers(0, L + 1, size=K).astype(np.int32)
            shape = (L, K) if transposed else (K, L)
            lane = np.arange(L)
            valid = (lane[:, None] < length[None, :]) if transposed else (lane[None, :] < length[:, None])
            rows_l.append(np.where(valid, rng.integers(0, m, size=shape), 0).astype(np.int32))
            vals_l.append(np.where(valid, rng.normal(size=shape), 0.0).astype(np.float32).reshape(-1))
            len_l.append(length)
            valid_l.append(valid.reshape(-1))
        plan = build_row_sum_plan(rows_l, len_l, m, transposed, window_bytes=window_bytes)
        plan = plan._replace(**{f: torch.from_numpy(getattr(plan, f)).to(dev)
                                for f in ("order", "seg_ptr", "seg_row", "item_ptr", "row_ptr", "row_segs")})
        vals, valid = np.concatenate(vals_l), np.concatenate(valid_l)
        v = torch.from_numpy(np.where(valid, vals, np.float32(np.nan))).to(dev)
        r = torch.from_numpy(np.concatenate([x.reshape(-1) for x in rows_l])).to(dev)
        v64 = torch.from_numpy(vals.astype(np.float64)).to(dev)
        start = torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(dev)
        got = segment_sum_rows(start.clone(), v, plan)
        again = segment_sum_rows(start.clone(), v, plan)
        ref = start.double().index_add_(0, r.long(), v64)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"segment-sum m={m}: two launches differ")
        scale = float(torch.zeros(m, dtype=torch.float64, device=dev).index_add_(0, r.long(), v64.abs()).max())
        e = float((got.double() - ref).abs().max())
        check(e <= 1e-5 * max(1.0, scale), f"segment-sum m={m}: err {e} vs sum|v| {scale}")
        worst = max(worst, e)
        say("segsum", m=m, tiles_K_L=shapes, transposed=transposed, window_bytes=window_bytes,
            windows=len(plan.windows), segments=plan.seg_row.numel(), items=plan.item_ptr.numel() - 1,
            max_abs_err_vs_float64=e)
    say("segsum", cases=len(cases), max_abs_err_vs_float64=worst, tolerance="1e-5*max(1, max row sum of |v|)",
        repeat="bit-identical", padding="NaN, never read")
    return worst


def plain_blocked(bf, p, v, reverse=False):
    """A packed plan's blocked application by every kernel's plain version
    (the stages on the masks), group by group, on the full (N,) buffer."""
    pre, post = list(zip(p.pre_groups, p.pre_masks)), list(zip(p.post_groups, p.post_masks))
    if reverse:
        pre, post = ([((st[::-1], E, I), mk) for (st, E, I), mk in reversed(post)],
                     [((st[::-1], E, I), mk) for (st, E, I), mk in reversed(pre)])

    def coarse(v, side):
        for (st, E, I), mk in side:
            v = bf.benes_coarse2_reference(v, mk, st, *E, I) if isinstance(E, tuple) else \
                bf.benes_coarse_reference(v, mk, st, E, I)
        return v

    v = coarse(v, pre)
    v = bf.benes_fine_reference(v, p.fine_masks, p.fine_dists, reverse)
    return coarse(v, post)


def phase_benes(dev) -> None:
    """K5, K6, K7 against the plain stages, bit for bit, in every regime; the
    card-built index against the plain-built one."""
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
        # the index the window kernels built on the card, against the plain stages' build
        plain_index = bf.build_index(copy.copy(packed), plain=True)
        got_index, want_index = bf.index_tensors(packed), bf.index_tensors(plain_index)
        check(len(got_index) == len(want_index) and all(torch.equal(g, w) for g, w in zip(got_index, want_index)),
              f"benes {what}: the card-built index differs from the plain-built one")
        del plain_index, want_index
        kinds = ["K7" if isinstance(g[1], tuple) else "K6" for g in packed.pre_groups]
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev).to(dtype)
            want = bf._pad_to(x, N)[torch.from_numpy(np.concatenate([perm, np.arange(n, N)])).to(dev)]
            before = (bf.benes_fine.launches, bf.benes_coarse.launches, bf.benes_coarse2.launches)
            y = bf.apply_butterfly_cuda(packed, x.clone(), truncate=False)
            used = tuple(b - a for a, b in zip(before, (bf.benes_fine.launches, bf.benes_coarse.launches,
                                                        bf.benes_coarse2.launches)))
            v = plain_blocked(bf, packed, bf._pad_to(x, N))
            torch.cuda.synchronize()
            check(torch.equal(y, v), f"benes {what} {dtype}: kernels differ from the plain stages")
            check(torch.equal(y[:n_out], want[:n_out]), f"benes {what} {dtype}: forward is not x[perm]")
            back = bf.apply_butterfly_cuda(packed, y.clone(), reverse=True, truncate=False)
            plain_back = plain_blocked(bf, packed, y, reverse=True)
            torch.cuda.synchronize()
            check(torch.equal(back, plain_back), f"benes {what} {dtype}: reverse differs from the plain stages")
            check(torch.equal(back[:n_in], bf._pad_to(x, N)[:n_in]), f"benes {what} {dtype}: reverse does not undo forward")
        say("benes", slots=N, block_log2=bl, regime=repr(what), pre_groups=kinds,
            launches_fine_coarse_coarse2=used, router=bf.last_route.get("router"), route_s=f"{route_s:.2f}",
            index_build_s=f"{packed.index_build_s:.3f}", index_bytes=bf.index_bytes(packed),
            equal="bit for bit, forward and reverse, fp32 and bf16; index as the plain stages build it")
        if "two launches" in what:  # 8192 positions do not fit one gather strip: one gather per axis
            check(used[2] == 4, f"benes {what}: expected 4 K7 launches, got {used[2]}")
        if "one launch" in what:
            check(used[2] == 2, f"benes {what}: expected 2 K7 launches, got {used[2]}")
        if "K6 twice" in what:
            check(used[1] == 4 and used[2] == 0, f"benes {what}: expected 4 K6 launches, got {used}")


def panel_tile(rng, L, compact, KP, dev, tiles=torch.float32):
    """Random panel-form a, c, length of one tile (masked columns included),
    a and c in ``tiles``: (PanelTile, pack, L2, q)."""
    from dualip_tpu_torch.sparse.rowmajor import PanelTile, _pack_geometry

    if compact:
        L2, q = _pack_geometry(L)
        pack = (L, L2, q)
    else:
        L2, q, pack = (1 << max(L - 1, 0).bit_length()) if L > 1 else 1, 1, None
    a = np.abs(rng.normal(size=(KP, q, L, 128))).astype(np.float32)
    c = -np.abs(rng.normal(size=(KP, q, L, 128))).astype(np.float32)
    length = rng.integers(0, L + 1, size=(KP, q, 1, 128)).astype(np.int32)
    mask = np.arange(L)[None, None, :, None] < length
    a = np.where(mask, a, 0).astype(np.float32).reshape(KP, q * L, 128)
    c = np.where(mask, c, 0).astype(np.float32).reshape(KP, q * L, 128)
    t = PanelTile(torch.from_numpy(a).to(dev).to(tiles), torch.from_numpy(c).to(dev).to(tiles),
                  torch.from_numpy(length.reshape(KP, q, 128)).to(dev))
    return t, pack, L2, q


def widened(tile):
    """The same tile with a and c in float32 (bf16 values widen exactly)."""
    return tile._replace(a=tile.a.float(), c=tile.c.float())


def panel_tol(ref: torch.Tensor, carry) -> float:
    """a bf16 carry rounds a*x once: one bf16 ulp of slack on top"""
    return tol_x(ref) + (float(ref.abs().max()) * 2.0 ** -7 if carry == torch.bfloat16 else 0.0)


DTYPES = (torch.float32, torch.bfloat16)


def phase_panel(dev):
    """K3/K4 one tile a launch against the plain version: every case, q = 1
    and q > 1, both carries, both tile types (a bf16 tile's launch also
    against the fp32 launch on the same values, bit for bit)."""
    from dualip_tpu_torch.ops.fused_matching import fused_panel_project, fused_panel_project_reference

    rng = np.random.default_rng(3)
    err = {(w, c, t): 0.0 for w in (False, True) for c in DTYPES for t in DTYPES}
    plain_bits = {k: True for k in err}
    n = 0
    # (L, compact): plain panels with L a power of two and not; compact packings with q > 1
    shapes = [(1, False), (2, False), (5, False), (16, False), (29, False), (48, False), (64, False),
              (100, False), (3, True), (5, True), (29, True), (34, True)]
    for kind, params in CASES:
        for L, compact in shapes:
            KP = 16
            tile16, pack, L2, q = panel_tile(rng, L, compact, KP, dev, tiles=torch.bfloat16)
            region = KP * L2 * 128
            off = 3 * region  # the region lies inside a larger buffer
            N = 8 * region
            for carry, tiles in ((c, t) for c in DTYPES for t in DTYPES):
                # fp32 tiles hold the bf16 tile's values, so both tile types must give the same bits
                tile = tile16 if tiles == torch.bfloat16 else widened(tile16)
                buf0 = torch.from_numpy(rng.normal(size=N).astype(np.float32) * 50).to(dev).to(carry)
                for want_x in (False, True):
                    got = fused_panel_project(buf0.clone(), *tile, off, kind, params, want_x=want_x,
                                              neg_inv_gamma=-2.0, pack=pack)
                    ref = fused_panel_project_reference(buf0.clone(), *tile, off, kind, params, want_x=want_x,
                                                        neg_inv_gamma=-2.0, pack=pack)
                    if tiles == torch.bfloat16:
                        wide = fused_panel_project(buf0.clone(), *widened(tile), off, kind, params, want_x=want_x,
                                                   neg_inv_gamma=-2.0, pack=pack)
                    torch.cuda.synchronize()
                    name = f"{kind}{params} L={L} q={q} carry {carry} tiles {tiles} want_x={want_x}"
                    if tiles == torch.bfloat16:
                        check(all(torch.equal(u, v) for u, v in zip(got, wide)),
                              f"panel {name}: bf16 tiles differ from fp32 tiles of the same values")
                    key = (want_x, carry, tiles)
                    plain_bits[key] &= torch.equal(got[0], ref[0]) and (not want_x or torch.equal(got[3], ref[3]))
                    gb, rb = got[0], ref[0]
                    check(torch.equal(gb[:off], buf0[:off]) and torch.equal(gb[off + region:], buf0[off + region:]),
                          f"panel {name}: wrote outside its region")
                    g_reg, r_reg = gb[off:off + region].view(KP, L2, 128).float(), rb[off:off + region].view(KP, L2, 128).float()
                    check(not g_reg[:, q * L:, :].any(), f"panel {name}: ghost lanes not zero")
                    tol = panel_tol(r_reg, carry)
                    e = float((g_reg - r_reg).abs().max())
                    check(e <= tol, f"panel {name}: |ax| err {e} > {tol}")
                    if want_x:
                        e_x = float((got[3] - ref[3]).abs().max())
                        check(e_x <= tol_x(ref[3]), f"panel {name}: |x| err {e_x}")
                        e = max(e, e_x)
                    for i, nm in ((1, "obj"), (2, "reg")):
                        g, r = float(got[i]), float(ref[i])
                        check(abs(g - r) <= 1e-3 + 1e-4 * abs(r), f"panel {name}: {nm} {g} vs {r}")
                    err[key] = max(err[key], e)
                    n += 1
    for (want_x, carry, tiles), e in err.items():
        say("panel", form="one tile a launch", kernel="K4" if want_x else "K3", carry=str(carry)[6:],
            tiles=str(tiles)[6:], max_abs_err=e, bit_for_bit_with_plain=plain_bits[(want_x, carry, tiles)])
    say("panel", form="one tile a launch", cases=n, shapes_L_compact=shapes,
        tolerance="ax,x: 5e-5*max(1,max|.|) (+1 bf16 ulp on a bf16 carry); obj,reg: 1e-3+1e-4*|ref|",
        bf16_tiles_vs_fp32_tiles="bit for bit on a*x, x, obj and reg", outside_region="unchanged",
        ghost_lanes="zero")
    return phase_panel_tiles(dev, err)


TABLE_SHAPES = [(1, False), (2, False), (5, False), (16, False), (29, False), (48, False), (64, False),
                (100, False), (3, True), (29, True), (34, True)]


def phase_panel_tiles(dev, err):
    """All tiles of a mixed table in one launch: against the plain version,
    against one launch per tile bit for bit on a*x and x, and a second launch
    bit for bit on (obj, reg); the kinds rotate across the tiles; every carry
    and tile type, bf16 tiles bit for bit with fp32 tiles of the same values."""
    from dualip_tpu_torch.ops.fused_matching import (
        build_panel_table,
        fused_panel_project,
        fused_panel_project_tiles,
        fused_panel_project_tiles_reference,
    )

    rng = np.random.default_rng(4)
    KP = 16
    tiles, packs, geo = [], [], []
    for L, compact in TABLE_SHAPES:
        tile, pack, L2, q = panel_tile(rng, L, compact, KP, dev, tiles=torch.bfloat16)
        tiles.append(tile)
        packs.append(pack)
        geo.append((L, L2, q))
    # regions as build_row_layout places them (descending L2), after an
    # untouched stretch, with another one after the last region
    base = cum = 2 * 128 * 512
    offsets = [0] * len(tiles)
    for i in sorted(range(len(tiles)), key=lambda i: -geo[i][1]):
        offsets[i] = cum
        cum += KP * geo[i][1] * 128
    N = cum + 128 * 512
    n = 0
    for shift in range(len(CASES)):
        kinds = [CASES[(i + shift) % len(CASES)] for i in range(len(tiles))]
        tables = {torch.bfloat16: build_panel_table(tiles, offsets, packs, kinds),
                  torch.float32: build_panel_table([widened(t) for t in tiles], offsets, packs, kinds)}
        for carry, tile_dt in ((c, t) for c in DTYPES for t in DTYPES):
            table = tables[tile_dt]
            buf0 = torch.from_numpy(rng.normal(size=N).astype(np.float32) * 50).to(dev).to(carry)
            for want_x in (False, True):
                got = fused_panel_project_tiles(buf0.clone(), table, -2.0, want_x=want_x)
                if tile_dt == torch.bfloat16:
                    wide = fused_panel_project_tiles(buf0.clone(), tables[torch.float32], -2.0, want_x=want_x)
                    check(all(torch.equal(u, v) for u, v in zip(got[:3], wide[:3]))
                          and (not want_x or all(torch.equal(u, v) for u, v in zip(got[3], wide[3]))),
                          f"panel all tiles, case {shift}, carry {carry}: bf16 tiles differ from fp32 tiles")
                again = fused_panel_project_tiles(buf0.clone(), table, -2.0, want_x=want_x)
                ref = fused_panel_project_tiles_reference(buf0.clone(), table, -2.0, want_x=want_x)
                per, per_x = buf0.clone(), []
                for t in table.tiles:
                    per_x += fused_panel_project(per, t.a, t.c, t.length, t.off, t.kind, t.params, want_x=want_x,
                                                 neg_inv_gamma=-2.0, pack=t.pack)[3:]
                torch.cuda.synchronize()
                name = f"all tiles, kinds from case {shift}, carry {carry}, tiles {tile_dt}, want_x={want_x}"
                key = (want_x, carry, tile_dt)
                check(torch.equal(got[0], per), f"panel {name}: a*x differs from one launch per tile")
                check(all(torch.equal(g, p) for g, p in zip(got[3], per_x)) if want_x else True,
                      f"panel {name}: x differs from one launch per tile")
                check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]) and torch.equal(got[2], again[2]),
                      f"panel {name}: two launches differ")
                check(torch.equal(got[0][:base], buf0[:base]) and torch.equal(got[0][cum:], buf0[cum:]),
                      f"panel {name}: wrote outside the regions")
                for t in table.tiles:
                    region = slice(t.off, t.off + t.KP * t.L2 * 128)
                    g_reg = got[0][region].view(t.KP, t.L2, 128).float()
                    r_reg = ref[0][region].view(t.KP, t.L2, 128).float()
                    check(not g_reg[:, t.q * t.L:, :].any(), f"panel {name}: ghost lanes of L={t.L} not zero")
                    e = float((g_reg - r_reg).abs().max())
                    check(e <= panel_tol(r_reg, carry), f"panel {name}: |ax| err {e} on L={t.L} q={t.q}")
                    err[key] = max(err[key], e)
                if want_x:
                    for g, r, t in zip(got[3], ref[3], table.tiles):
                        e_x = float((g - r).abs().max())
                        check(e_x <= tol_x(r), f"panel {name}: |x| err {e_x} on L={t.L} q={t.q}")
                        err[key] = max(err[key], e_x)
                for i, nm in ((1, "obj"), (2, "reg")):
                    g, r = float(got[i]), float(ref[i])
                    check(abs(g - r) <= 1e-3 + 1e-4 * abs(r), f"panel {name}: {nm} {g} vs {r}")
                n += 1
    say("panel", form="all tiles a launch", cases=n, tiles_L_compact=TABLE_SHAPES,
        max_abs_err={f"{'K4' if k[0] else 'K3'} carry {str(k[1])[6:]} tiles {str(k[2])[6:]}": v for k, v in err.items()},
        vs_one_launch_per_tile="bit for bit on a*x and x", repeat="bit for bit on a*x, obj and reg",
        bf16_tiles_vs_fp32_tiles="bit for bit", outside_regions="unchanged", ghost_lanes="zero")
    return err


def time_panel(what, obj, dev, kernels, panel_err, launches=None):
    """K3/K4 on a butterfly objective's tiles (its panel table): all tiles
    in one launch against the plain version, against one launch per tile
    bit for bit and against itself (obj, reg too) bit for bit; timed beside
    the per-tile form, the plain version and, for K3, each tile alone and a
    bf16 carry.  With ``launches`` (the solve's counts), K3 and K4 join
    ``kernels``, named for bf16 tiles where the table's a and c are bf16."""
    from dualip_tpu_torch.ops.fused_matching import (
        fused_panel_project,
        fused_panel_project_tiles,
        fused_panel_project_tiles_reference,
    )
    from dualip_tpu_torch.objectives.matching import _plan_size

    nig = torch.full((), -1.0 / 1e-3, dtype=torch.float32, device=dev)
    table = obj.panel_table
    ts = table.tiles
    tile_bytes = ts[0].a.element_size()
    suffix = " (bf16 tiles)" if table.tile_dtype == torch.bfloat16 else ""
    n_carry = _plan_size(obj.row_layout.plan)  # the carry buffer's length
    srow0 = torch.from_numpy(np.random.default_rng(7).normal(size=n_carry).astype(np.float32) * 0.01).to(dev)

    def bound(tiles_, want_x, carry_bytes=4):
        real = sum(t.a.numel() for t in tiles_)
        ghost = sum(t.KP * t.L2 * 128 - t.a.numel() for t in tiles_)
        cols = sum(t.length.numel() for t in tiles_)
        nbytes = real * (2 * tile_bytes + 2 * carry_bytes + (4 if want_x else 0)) + ghost * carry_bytes + cols * 4
        nops = sum(t.a.numel() * ops_per_slot(t.kind) for t in tiles_)
        t_b, t_o = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_FLOP_PER_S * 1e3
        return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), nbytes, nops, real, ghost

    def per_tile(b, want_x, tiles_=ts):
        return [fused_panel_project(b, t.a, t.c, t.length, t.off, t.kind, t.params, want_x=want_x,
                                    neg_inv_gamma=nig, pack=t.pack) for t in tiles_]

    for want_x in (False, True):
        name = ("K4 fused_panel_project_tiles want_x" if want_x else "K3 fused_panel_project_tiles") + suffix
        got = fused_panel_project_tiles(srow0.clone(), table, nig, want_x=want_x)
        again = fused_panel_project_tiles(srow0.clone(), table, nig, want_x=want_x)
        per = srow0.clone()
        per_x = [r[3:] for r in per_tile(per, want_x)]  # (x,) each with want_x, else ()
        ref = fused_panel_project_tiles_reference(srow0.clone(), table, nig, want_x=want_x)
        torch.cuda.synchronize()
        check(torch.equal(got[0], per) and all(torch.equal(g, p_[0]) for g, p_ in zip(got[3] if want_x else [], per_x)),
              f"{what} {name}: the all-tiles launch differs from one launch per tile")
        check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]) and torch.equal(got[2], again[2]),
              f"{what} {name}: two launches differ")
        e = float((got[0] - ref[0]).abs().max())
        tol = tol_x(ref[0])
        if want_x:
            e = max([e] + [float((g - r).abs().max()) for g, r in zip(got[3], ref[3])])
        check(e <= tol, f"{what} {name}: err {e} > {tol}")
        for i in (1, 2):
            g, r = float(got[i]), float(ref[i])
            check(abs(g - r) <= 1e-3 + 1e-4 * abs(r), f"{what} {name}: sums {g} vs {r}")
        del got, again, per_x, ref
        srow = srow0.clone()
        t_k = cuda_ms(lambda: fused_panel_project_tiles(srow, table, nig, want_x=want_x), reps=10, graph=True)
        t_per = cuda_ms(lambda: per_tile(srow, want_x), reps=10, graph=True)
        plain_ms = cuda_ms(lambda: fused_panel_project_tiles_reference(srow, table, nig, want_x=want_x),
                           reps=2, warmup=1).ms
        b_ms, b_by, nbytes, nops, real, ghost = bound(ts, want_x)
        ops_ms = nops / NON_FMA_OPS_PER_S * 1e3
        extra = {}
        if not want_x:
            srow_bf = srow0.to(torch.bfloat16)
            extra["bf16_carry_ms"] = cuda_ms(lambda: fused_panel_project_tiles(srow_bf, table, nig),
                                             reps=10, graph=True).ms
            extra["bf16_carry_bound_ms"] = bound(ts, False, 2)[0]
            del srow_bf
            tile_rows = []
            for t in ts:  # each tile alone: one launch of the same kernel
                ms_t = cuda_ms(lambda: per_tile(srow, False, [t]), reps=10, graph=True).ms
                lcap = "stream" if t.L > 32 else 1 << max(t.L - 1, 0).bit_length()
                tile_rows.append((t.L, t.q, lcap, t.a.numel(), round(ms_t, 4), round(bound([t], False)[0], 4)))
            say("timing", path=what, kernel="'K3, each tile alone'",
                per_tile_L_q_LCAP_slots_ms_bound=tile_rows,
                sum_ms=f"{sum(r[4] for r in tile_rows):.4f}")
        del per
        say("timing", path=what, kernel=repr(name), per_iteration_ms=f"{t_k.ms:.4f}",
            per_tile_form_ms=f"{t_per.ms:.4f}", plain_ms=f"{plain_ms:.3f}", bound_ms=f"{b_ms:.4f}",
            bound_by=b_by, share_of_bound=f"{b_ms / t_k.ms:.3f}", ops_ms_at_non_fma_rate=f"{ops_ms:.4f}",
            bytes=nbytes, ops=nops, real_slots=real, ghost_slots=ghost, tiles=len(ts), items=table.n_items,
            **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in extra.items()},
            per_tile_form_host_enqueue_ms=f"{t_per.host_ms:.4f}", **timing_kv(t_k))
        if launches is not None:
            kernels.append({
                "name": name, "route": "cuda", "source": "dualip_tpu_torch/csrc/panel_matching.cu",
                "replaces": "dualip_tpu/ops/pallas_matching.py:" + ("287" if want_x else "305"),
                "launches": launches["K4" if want_x else "K3"],
                "max_abs_err": max(e, panel_err.get((want_x, torch.float32, table.tile_dtype), 0.0)),
                "ms": t_k.ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None,  # no single PyTorch call computes the projection
                "per_tile_form_ms": t_per.ms,
            })
        del srow


V150D30 = ROOT / "examples" / "miplib_2017" / "v150d30-2hopcds.mps.gz"
V150D30_JAX_DUAL = 27.62  # the JAX package's dual at 10,000 iterations (PARITY.md, section 2.5)
LP_SOLVER = dict(gamma=1e-3, initial_step_size=1e-5)  # the reference's MIPLIB solve


def phase_lp(dt, inp, card, captured, counts, reset_counts, profile_window, ms_per_iteration, Timed):
    """The general LP through ``run_solver(objective_type="miplib2017")``:
    the bundled MIPLIB instance (10,000 iterations on the COO layout, a
    bit-identical repeat, the butterfly layout on the whole instance held to
    COO per ``calculate``, the PDLP bound) and the slice's matrix read as a
    general LP (COO and butterfly, timed and profiled)."""
    import dualip_tpu_torch.objectives.miplib as miplib_mod
    from dualip_tpu_torch.io.mps import read_mps_file
    from dualip_tpu_torch.objectives.matching import _plan_size
    from dualip_tpu_torch.objectives.miplib import MIPLIB2017ObjectiveFunction, MIPLIBInputArgs
    from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent
    from dualip_tpu_torch.projections import ProjectionEntry

    class TimedMIPLIB(Timed, MIPLIB2017ObjectiveFunction):
        def __init__(self, *a, **kw):
            t = time.perf_counter()
            super().__init__(*a, **kw)
            torch.cuda.synchronize()
            self.events = []
            captured["obj"], captured["build_s"] = self, time.perf_counter() - t

    def lp_solve(data, iters, **kw):
        """run_solver's miplib2017 branch, its objective timed: (result,
        launches, seconds), counts set to 0 just before."""
        reset_counts()
        t = time.perf_counter()
        with rebound(miplib_mod, MIPLIB2017ObjectiveFunction=TimedMIPLIB):
            res = dt.run_solver(data, dt.SolverArgs(max_iter=iters, **LP_SOLVER), dt.ComputeArgs(),
                                dt.ObjectiveArgs(objective_type="miplib2017", objective_kwargs=kw))
        torch.cuda.synchronize()
        n = counts()
        check(res.dual_val.device.type == "cuda", "lp: the solve did not run on the card")
        check(len(res.dual_objective_log) == iters and all(np.isfinite(res.dual_objective_log)),
              "lp: non-finite dual objective log")
        return res, n, time.perf_counter() - t

    def repeat(obj, iters):
        r = AcceleratedGradientDescent(max_iter=iters, **LP_SOLVER).maximize(
            obj, torch.zeros(obj.b_vec.shape[0], device=obj.device))
        return np.asarray(r.dual_objective_log)

    def agree(what, coo, bfly, m, seeds, obj_rtol):
        """COO and butterfly per calculate at seeded duals: the gradient
        within 1e-3 of its largest entry, the objective to ``obj_rtol``, the
        penalty to 1e-4; returns the largest deviations and the butterfly's
        Benes launches."""
        worst = [0.0, 0.0, 0.0]
        reset_counts()
        for seed in seeds:
            lam = torch.from_numpy(np.abs(np.random.default_rng(seed).normal(size=m)).astype(np.float32)).to(coo.device)
            r1, r2 = coo.calculate(lam, gamma=1e-3), bfly.calculate(lam, gamma=1e-3)
            g1 = r1.dual_gradient
            d = [float((g1 - r2.dual_gradient).abs().max() / max(1.0, float(g1.abs().max()))),
                 abs(float(r1.dual_objective) - float(r2.dual_objective)) / max(1.0, abs(float(r1.dual_objective))),
                 abs(float(r1.reg_penalty) - float(r2.reg_penalty)) / max(1e-6, abs(float(r1.reg_penalty)))]
            worst = [max(u, v) for u, v in zip(worst, d)]
        n = counts()
        check(worst[0] <= 1e-3 and worst[1] <= obj_rtol and worst[2] <= 1e-4,
              f"lp {what}: butterfly vs COO per calculate: gradient, objective, penalty {worst}")
        check(n["K5"] > 0 and n["segsum"] > 0, f"lp {what}: kernels not launched: {n}")
        return worst, n

    # ---- v150d30: the bundled MIPLIB 2017 instance
    lp = read_mps_file(str(V150D30))
    args = lp.to_miplib_input_args()
    check(lp.shape == (7822, 150) and args.A.nnz == 103991, f"lp v150d30: read {lp.shape}, {args.A.nnz} nnz")
    res, n_launch, solve_s = lp_solve(args, 10000)
    obj = captured["obj"]
    final = res.dual_objective
    say("lp", instance="v150d30-2hopcds", rows=lp.shape[0], variables=lp.shape[1], nnz=args.A.nnz, layout="coo",
        iterations=10000, final_dual_objective=final, reference_assertion="27 +- 1",
        deviation_from_jax_package_27_62=final - V150D30_JAX_DUAL, run_solver_s=f"{solve_s:.2f}",
        objective_build_s=f"{captured['build_s']:.3f}", ms_per_iteration=f"{ms_per_iteration(obj.events):.4f}",
        launches=n_launch, card=card)
    check(abs(final - 27.0) < 1.0, f"lp v150d30: dual {final}, the reference asserts 27 +- 1")
    check(n_launch["segsum"] == 2 * 10000 and n_launch["K5"] == 0, f"lp v150d30: launches {n_launch}")
    again = repeat(obj, 10000)
    check(np.array_equal(again, np.asarray(res.dual_objective_log)), "lp v150d30: two COO solves differ")
    x = obj.calculate(res.dual_val, gamma=1e-3, save_primal=True).primal_var
    gap_ub, gap_lb, p_feas, d_feas, conv = obj.calculate_convergence_bound(res.dual_val, x=x, tol=1e-4)
    say("lp", instance="v150d30-2hopcds", repeat_of_the_solve="bit-identical", pdlp_gap_upperbound=gap_ub,
        pdlp_gap_lowerbound=gap_lb, primal_feasibility=p_feas, dual_feasibility=d_feas, converged_at_1e_4=conv)
    t0 = time.perf_counter()
    bfly = MIPLIB2017ObjectiveFunction(args, layout="butterfly")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    worst, n_b = agree("v150d30", obj, bfly, lp.shape[0], (0, 1, 2), 1e-5)
    say("lp", instance="v150d30-2hopcds", butterfly_vs_coo_gradient_objective_penalty=worst,
        tolerance="1e-3 of max|grad|, 1e-5, 1e-4 (tests/test_mps_reader.py)", butterfly_build_s=f"{build_s:.2f}",
        carry_slots=_plan_size(bfly.ops.rl.plan), launches_three_calculates=n_b)
    del obj, bfly, res, captured["obj"], x
    torch.cuda.empty_cache()

    # ---- lp-2.5M: the slice's matrix as a general LP, x in [0, 1], c ~ U(-1, 0)
    m, n = inp.A.shape
    c_lp = np.random.default_rng(42).uniform(-1.0, 0.0, size=n).astype(np.float32)
    lp_args = MIPLIBInputArgs(A=inp.A, c=c_lp, b_vec=inp.b_vec,
                              projection_map={"box": ProjectionEntry("box", {"lower": 0.0, "upper": 1.0}, np.arange(n))})
    results = {}
    for layout, iters in (("coo", 200), ("butterfly", 50)):
        res, n_launch, solve_s = lp_solve(lp_args, iters, layout=layout)
        obj = captured["obj"]
        ev = obj.events
        first_ms = ev[0][0].elapsed_time(ev[0][1])
        say("lp", instance="lp-2.5M", rows=m, variables=n, nnz=inp.A.nnz, layout=layout, iterations=iters,
            ms_per_iteration=f"{ms_per_iteration(ev):.4f}", objective_build_s=f"{captured['build_s']:.2f}",
            time_to_first_iteration_s=f"{captured['build_s'] + first_ms / 1e3:.3f}", first_iteration_ms=f"{first_ms:.3f}",
            run_solver_s=f"{solve_s:.2f}", final_dual_objective=res.dual_objective,
            peak_device_bytes=torch.cuda.max_memory_allocated(), launches=n_launch, card=card)
        check(res.dual_objective_log[-1] > res.dual_objective_log[0], f"lp-2.5M {layout}: the dual objective did not rise")
        if layout == "coo":
            check(n_launch["segsum"] == 2 * iters, f"lp-2.5M coo: launches {n_launch}")
            again = repeat(obj, iters)
            check(np.array_equal(again, np.asarray(res.dual_objective_log)), "lp-2.5M: two COO solves differ")
            say("lp", instance="lp-2.5M", layout=layout, repeat_of_the_solve="bit-identical")
        else:
            check(n_launch["K5"] == 2 * iters and n_launch["segsum"] == 0, f"lp-2.5M butterfly: launches {n_launch}")
            say("lp", instance="lp-2.5M", layout=layout, carry_slots=_plan_size(obj.ops.rl.plan),
                layout_build_s=f"{obj.ops.rl.build_seconds['total']:.2f}",
                routing_s=f"{obj.ops.rl.build_seconds['route']:.2f}")
        profile_window(f"lp-2.5M {layout}", obj, res.dual_val, kw=LP_SOLVER)
        results[layout] = (obj, res.dual_val)
        del res, captured["obj"]
        if layout == "coo":
            obj.events = []
        torch.cuda.empty_cache()
    worst, _ = agree("lp-2.5M", results["coo"][0], results["butterfly"][0], m, (0,), 1e-4)
    say("lp", instance="lp-2.5M", butterfly_vs_coo_gradient_objective_penalty=worst,
        tolerance="1e-3 of max|grad|, 1e-4, 1e-4 (25M-term fp32 sums in two orders)")
    del results
    torch.cuda.empty_cache()


def phase_io(dt, args, card, numpy_gen_s, numpy_inp, captured, counts, solve, ms_per_iteration, n_chk):
    """The I/O tiers at the slice's shape on the native generator's data, in
    a fresh temporary cache directory: generation cold and warm (the warm load
    equal to the cold arrays), the native tile fill against the numpy fill
    (equal tiles, both timed), then the butterfly objective with the plan and
    tile caches built cold and loaded warm: each one's time to first
    iteration, the launches on the warm objective (counts set to 0 just
    before it is built: K3, K5, K7 and the window kernels that build the
    source index) and the two 20-iteration dual logs bit-identical."""
    import dualip_tpu_torch.sparse.bcsc as bcsc_mod
    from dualip_tpu_torch.io import native_loader
    from dualip_tpu_torch.synthetic import generate_synthetic_matching_input_args

    check(native_loader.native_available(),
          "io: the native library did not build (g++); the data would silently be the numpy generator's")
    shape = (args.sources, args.destinations, args.sparsity)
    native_env = mock.patch.dict(os.environ, DUALIP_GEN_BACKEND="native")
    with tempfile.TemporaryDirectory(prefix="dualip-io-") as tmp, native_env:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        raw = native_loader.generate_matching_native(*shape, seed=args.seed)
        native_s = time.perf_counter() - t0
        del raw
        t0 = time.perf_counter()
        inp = generate_synthetic_matching_input_args(*shape, seed=args.seed, cache_dir=tmp / "gen")
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = generate_synthetic_matching_input_args(*shape, seed=args.seed, cache_dir=tmp / "gen")
        warm_s = time.perf_counter() - t0
        fields = lambda a: (a.A.indptr, a.A.row_indices, a.A.data, a.c.data, a.b_vec)  # noqa: E731
        check(all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(fields(inp), fields(warm))),
              "io: the warm generator load differs from the cold arrays")
        del warm
        say("io", backend="native", sources=args.sources, nnz=inp.A.nnz, native_generate_s=f"{native_s:.2f}",
            generate_and_cache_write_s=f"{cold_s:.2f}", warm_load_s=f"{warm_s:.2f}", warm_equals_cold=True,
            numpy_generate_s=f"{numpy_gen_s:.2f}" if numpy_inp is not None else "not run",
            numpy_nnz=numpy_inp.A.nnz if numpy_inp is not None else "not run", card=card)

        # the slice's tiles filled natively and by numpy: equal element for element
        def tiles(threshold):
            with rebound(bcsc_mod, NATIVE_FILL_SLOTS=threshold):
                t = time.perf_counter()
                b = bcsc_mod.build_blockcsc(inp.A, inp.c, inp.projection_map, pad_cols_to=128, keep_flat_idx=True)
                return b, time.perf_counter() - t

        b_nat, nat_s = tiles(1)
        b_np, np_s = tiles(1 << 62)
        for t1, t2, s1, s2 in zip(b_nat.tiles, b_np.tiles, b_nat.specs, b_np.specs):
            check(all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(t1, t2))
                  and np.array_equal(s1.flat_idx, s2.flat_idx), f"io: native and numpy fills differ on tile {s1.L}")
        at_default = sum(int((t.length > 0).sum()) * s.L >= bcsc_mod.NATIVE_FILL_SLOTS for t, s in zip(b_np.tiles, b_np.specs))
        say("io", tiles=len(b_np.tiles), tile_shapes=[(s.L, s.K) for s in b_np.specs], native_fill_build_s=f"{nat_s:.2f}",
            numpy_fill_build_s=f"{np_s:.2f}", fills_equal=True, keep_flat_idx=True,
            native_at_default_threshold=f"{at_default} of {len(b_np.tiles)} tiles")
        del b_nat, b_np

        # the butterfly objective cold (routing, layout, both caches written), then warm
        kw = dict(layout="butterfly", keep_col_tiles=False, keep_flat_idx=False,
                  plan_cache_dir=str(tmp / "plans"), tile_cache_dir=str(tmp / "tiles"))
        out = {}
        for what in ("cold", "warm"):
            res, n_launch, solve_s = solve(inp, n_chk, False, **kw)  # counts set to 0 just before the build
            obj = captured["obj"]
            rl = obj.row_layout
            first_ms = obj.events[0][0].elapsed_time(obj.events[0][1])
            out[what] = (res.dual_objective_log, n_launch, obj.tile_cache_key)
            say("io", objective=what, objective_build_s=f"{captured['build_s']:.2f}",
                time_to_first_iteration_s=f"{captured['build_s'] + first_ms / 1e3:.3f}",
                layout_build_s=f"{rl.build_seconds['total']:.2f}", routing_s=f"{rl.build_seconds['route']:.2f}",
                index_build_s=f"{rl.plan.index_build_s:.3f}", iterations=n_chk,
                ms_per_iteration=f"{ms_per_iteration(obj.events):.4f}", launches=n_launch, card=card,
                # a miss's save: the leaves copied back from the card, then written
                **{k: f"{v:.3f}" for k, v in rl.build_seconds.items() if k.startswith("tile_cache_")})
            del res, obj, rl, captured["obj"]
            torch.cuda.empty_cache()
            if what == "cold":
                entry = tmp / "tiles" / f"butterfly_{out['cold'][2]}"
                check((entry / "meta.json").exists(), "io: the cold build wrote no tile-cache entry")
                say("io", tile_cache_entry_bytes=sum(f.stat().st_size for f in entry.iterdir()),
                    plan_cache_bytes=sum(f.stat().st_size for f in (tmp / "plans").iterdir()))
        (log_c, _, key_c), (log_w, n_w, key_w) = out["cold"], out["warm"]
        check(key_c == key_w, "io: the warm objective computed another cache key")
        want = {"K3": n_chk, "K5": 2 * n_chk, "K7": 4 * n_chk}
        check(all(n_w[k] == v for k, v in want.items()), f"io: warm launches {n_w}, expected {want}")
        check(n_w["K5w"] > 0 and n_w["K7w"] > 0, f"io: the warm plan's source index was not built on the card: {n_w}")
        check(n_w["K1g"] == n_w["segsum"] == 0, f"io: the csc kernels ran: {n_w}")
        dev_ = rel_dev(log_w, log_c)
        say("io", warm_vs_cold_dual_log="bit-identical" if dev_.max() == 0 else "DIFFERS",
            max_rel_dev=float(dev_.max()), final_dual_objective=log_w[-1])
        check(list(log_w) == list(log_c), f"io: the warm solve's dual log differs from the cold one by {dev_.max()}")


def phase_obs(dt, inp, card, captured, reset_counts, counts, n_chk, solver_kw):
    """Observability on the card at the slice's shape: ``run_solver`` with
    MLflow enabled completes (mlflow is not installed there: a no-op) and
    repeats the solve without it bit for bit; ``trace`` around three csc
    iterations writes a trace naming K1's kernel, the segment-sum's two and
    the ``annotate`` span; ``collect_stats`` fills ``last_run_stats``."""
    from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent
    from dualip_tpu_torch.utils.mlflow_utils import MLflowConfig, is_mlflow_available
    from dualip_tpu_torch.utils.profiling import annotate, trace

    def run(mlflow_config=None, **kw):
        reset_counts()
        res = dt.run_solver(inp, dt.SolverArgs(max_iter=n_chk, **solver_kw), dt.ComputeArgs(),
                            dt.ObjectiveArgs(objective_type="matching_smoke", objective_kwargs={"use_pallas": True}),
                            mlflow_config=mlflow_config)
        torch.cuda.synchronize()
        return res, counts()

    res_m, n_m = run(MLflowConfig(enabled=True))
    obj = captured["obj"]
    res_p, _ = run()
    check(res_m.dual_val.device.type == "cuda" and all(np.isfinite(res_m.dual_objective_log)),
          "obs: the solve with MLflow enabled did not complete on the card")
    check(res_m.dual_objective_log == res_p.dual_objective_log, "obs: MLflow logging changed the solve")
    check(n_m["K1g"] == len(obj.bcsc.tiles) * n_chk and n_m["segsum"] == n_chk, f"obs: launches {n_m}")
    say("obs", mlflow_enabled=True, mlflow_available=is_mlflow_available(), iterations=n_chk,
        same_log_as_without_mlflow=True, launches=n_m)

    span = "dualip.csc_three_iterations"
    agd = AcceleratedGradientDescent(max_iter=3, **solver_kw)
    dual = torch.zeros(obj.bcsc.m, device=obj.device)
    agd.maximize(obj, dual)  # warm
    with tempfile.TemporaryDirectory(prefix="dualip-trace-") as tmp:
        t0 = time.perf_counter()
        with trace(tmp):
            with annotate(span):
                agd.maximize(obj, dual)
        trace_s = time.perf_counter() - t0
        files = list(Path(tmp).glob("*.json"))
        check(len(files) == 1, f"obs: trace wrote {len(files)} files")
        events = json.loads(files[0].read_text())["traceEvents"]
        size = files[0].stat().st_size
    names = {e.get("name", "") for e in events}
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    k1 = sorted(n for n in kernels if re.search(r"(column|wide|clamp)_kernel", n))
    seg = sorted(n for n in kernels if re.search(r"window_sums|add_rows", n))
    say("obs", trace_events=len(events), trace_bytes=size, kernel_names=len(kernels), K1=[n[:60] for n in k1],
        segment_sum=[n[:40] for n in seg], annotate_span=span in names, traced_s=f"{trace_s:.2f}")
    check(k1 and len(seg) == 2 and span in names, "obs: the trace lacks K1's or the segment-sum's kernels or the span")

    agd = AcceleratedGradientDescent(max_iter=n_chk, **solver_kw)
    agd.collect_stats = True
    agd.maximize(obj, dual)
    st = agd.last_run_stats
    check(st is not None and st["iters"] == n_chk and st["total_s"] >= st["drain_s"] >= 0, f"obs: stats {st}")
    say("obs", last_run_stats={k: (round(v, 4) if isinstance(v, float) else v) for k, v in st.items()}, card=card)
    del obj, captured["obj"], res_m, res_p
    torch.cuda.empty_cache()


def phase_canonical(args, card, captured, solve, ms_per_iteration, solver_kw):
    """The canonical shape (25,000,000 sources x 10,000 destinations,
    sparsity 1e-3, seed 42) on the native generator: its nnz must be the JAX
    package's canonical run's exactly, and the csc solve with the fused kernel
    (200 iterations, gamma 1e-3, steps 1e-3/1e-1) must end within 1e-2
    relative of that run's fp32 dual (the records' widest gap between two fp32
    layouts of this solve is 3.14e-3).  That limit is the solve's own
    spread, not a test of precision: rounding differences grow along the AGD
    trajectory, and the JAX package's bf16-carry solve lands 1.16e-3 from its
    fp32 one.  So a second witness solves the same problem in float64 on the
    card (the plain csc path; the segment-sum's plain version, whose
    ``index_add_`` takes float64): the fused solve's first 10 iterations must
    lie within 1e-5 relative of it, and where the two logs part is printed."""
    import dualip_tpu_torch.objectives.matching as matching_mod
    from dualip_tpu_torch.io import native_loader
    from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent
    from dualip_tpu_torch.ops.segment_sum import segment_sum_rows_reference
    from dualip_tpu_torch.synthetic import generate_synthetic_matching_input_args

    check(native_loader.native_available(), "canonical: the native library did not build (g++)")
    native_env = mock.patch.dict(os.environ, DUALIP_GEN_BACKEND="native")
    with tempfile.TemporaryDirectory(prefix="dualip-canonical-") as tmp, native_env:
        t0 = time.perf_counter()
        can = generate_synthetic_matching_input_args(CANONICAL_SOURCES, args.destinations, args.sparsity,
                                                     seed=args.seed, cache_dir=tmp)
        gen_s = time.perf_counter() - t0
        say("canonical", sources=CANONICAL_SOURCES, nnz=can.A.nnz, expected_nnz=CANONICAL_NNZ,
            generate_s=f"{gen_s:.2f}", memmap_tier=not can.A.data.flags.writeable)
        check(can.A.nnz == CANONICAL_NNZ, f"canonical: nnz {can.A.nnz} != the JAX package's {CANONICAL_NNZ}")
        res, n_launch, solve_s = solve(can, args.iters, False, use_pallas=True)
        obj = captured["obj"]
        first_ms = obj.events[0][0].elapsed_time(obj.events[0][1])
        dual = res.dual_objective
        rel = abs(dual - CANONICAL_DUAL) / abs(CANONICAL_DUAL)
        slots = sum(s.L * s.K for s in obj.bcsc.specs)
        say("canonical", iterations=len(res.dual_objective_log), tiles=len(obj.bcsc.specs), slots=slots,
            objective_build_s=f"{captured['build_s']:.2f}",
            time_to_first_iteration_s=f"{captured['build_s'] + first_ms / 1e3:.3f}",
            ms_per_iteration=f"{ms_per_iteration(obj.events):.4f}", run_solver_s=f"{solve_s:.2f}",
            peak_device_bytes=torch.cuda.max_memory_allocated(), launches=n_launch, card=card)
        say("canonical", final_dual_objective=dual, jax_fp32_dual=CANONICAL_DUAL, rel_diff=f"{rel:.3e}",
            tolerance=1e-2, note="the limit would pass a bf16 computation too (JAX bf16 carry: 1.16e-3)")
        check(all(np.isfinite(res.dual_objective_log)) and n_launch["K1g"] == len(obj.bcsc.specs) * args.iters,
              f"canonical: launches {n_launch}")
        check(rel <= 1e-2, f"canonical: dual {dual} is {rel:.3e} relative from the JAX package's {CANONICAL_DUAL}")
        log32 = np.array(res.dual_objective_log, dtype=np.float64)
        dev = obj.device
        del obj, res, captured["obj"]
        torch.cuda.empty_cache()

        # the second witness: the same tiles, the dual and every sum in float64
        t0 = time.perf_counter()
        with rebound(matching_mod, segment_sum_rows=segment_sum_rows_reference):
            obj64 = matching_mod.MatchingSolverDualObjectiveFunction(can, gamma=solver_kw["gamma"], device=dev)
            build_s = time.perf_counter() - t0
            dual0 = torch.zeros(obj64.bcsc.m, dtype=torch.float64, device=dev)
            res64 = AcceleratedGradientDescent(max_iter=args.iters, **solver_kw).maximize(obj64, dual0)
            torch.cuda.synchronize()
        log64 = np.array(res64.dual_objective_log, dtype=np.float64)
        dev32 = np.abs(log32 - log64) / np.abs(log64)

        def parts(tol):
            return int(np.argmax(dev32 > tol)) + 1 if (dev32 > tol).any() else "never"

        say("canonical", witness="float64 plain csc", dtype=str(res64.dual_val.dtype), iterations=len(log64),
            build_s=f"{build_s:.2f}", solve_s=f"{time.perf_counter() - t0 - build_s:.2f}",
            final_dual_objective_fp64=float(log64[-1]), fp32_vs_fp64_final=f"{dev32[-1]:.3e}",
            jax_fp32_vs_fp64_final=f"{abs(CANONICAL_DUAL - log64[-1]) / abs(log64[-1]):.3e}",
            fp32_vs_fp64_max_first_10=f"{dev32[:10].max():.3e}", fp32_vs_fp64_max_first_20=f"{dev32[:20].max():.3e}",
            first_iteration_apart_1e_6=parts(1e-6), first_iteration_apart_1e_5=parts(1e-5),
            first_iteration_apart_1e_4=parts(1e-4), first_iteration_apart_1e_3=parts(1e-3),
            fp32_vs_fp64_max=f"{dev32.max():.3e}", tolerance_first_10=1e-5)
        check(res64.dual_val.dtype == torch.float64 and np.isfinite(log64).all(), "canonical: the fp64 solve failed")
        check(dev32[:10].max() <= 1e-5,
              f"canonical: the fused solve's first 10 iterations part from the fp64 solve by {dev32[:10].max():.3e}")
        del obj64, res64, can
        torch.cuda.empty_cache()


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


def ptxas_summary(logs, log_dir: Path) -> None:
    """Registers and spills from ``-Xptxas -v``; the whole log goes to
    ``log_dir/ptxas.log``."""
    if logs:
        (log_dir / "ptxas.log").write_text("".join(f"== {k}\n{v}\n" for k, v in logs.items()))
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
                    help="comma-separated subset of: " + ", ".join(ALL_PHASES + OPT_IN_PHASES)
                    + f" (default: all but {', '.join(OPT_IN_PHASES)})")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in ALL_PHASES + OPT_IN_PHASES:
            ap.error(f"unknown phase {p!r}")
    full = set(ALL_PHASES) <= set(phases)

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
        fused_panel_project_tiles,
        fused_panel_project_tiles_reference,
        fused_tile_eval_T,
        fused_tile_eval_T_reference,
        fused_tile_gather_eval_T,
        fused_tile_gather_eval_T_reference,
    )
    from dualip_tpu_torch.ops.segment_sum import segment_sum_rows, segment_sum_rows_reference
    from dualip_tpu_torch.sparse.bcsc import WINDOW_BYTES, build_row_sum_plan
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
    ptxas_summary(logs, _build.BUILD_DIR)
    t0 = time.perf_counter()
    say("build", native_router="built" if native_loader.native_available() else "unavailable (numpy router)",
        seconds=f"{time.perf_counter() - t0:.2f}")

    # 8a. generate the slice's data once, for both layouts
    need_data = bool({"slice", "butterfly", "lp", "obs"} & set(phases))
    inp, gen_s, l_max = None, 0.0, 29
    if need_data:
        t0 = time.perf_counter()
        inp = generate_synthetic_matching_input_args(args.sources, args.destinations, args.sparsity, seed=args.seed)
        gen_s = time.perf_counter() - t0
        l_max = int(inp.A.col_lengths.max())
        say("generate", sources=args.sources, destinations=args.destinations, sparsity=args.sparsity,
            seed=args.seed, nnz=inp.A.nnz, max_column_degree=l_max, seconds=f"{gen_s:.2f}")

    check_err = {False: 0.0, True: 0.0}
    panel_err = {}
    segsum_err = 0.0
    if "kernels" in phases:
        check_err = phase_kernels(sorted({1, 2, 8, 16, 32, 100, l_max}), dev)
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
        fused_tile_gather_eval_T.launches = fused_tile_gather_eval_T.launches_x = 0
        fused_panel_project.launches = fused_panel_project.launches_x = 0
        fused_panel_project_tiles.launches = fused_panel_project_tiles.launches_x = 0
        bf.benes_fine.launches = bf.benes_coarse.launches = bf.benes_coarse2.launches = 0
        bf.benes_fine_window.launches = bf.benes_coarse2_window.launches = 0
        segment_sum_rows.launches = 0

    def counts():
        return {"K1g": fused_tile_gather_eval_T.launches, "K2g": fused_tile_gather_eval_T.launches_x,
                "K1": fused_tile_eval_T.launches, "K2": fused_tile_eval_T.launches_x,
                "K3": fused_panel_project_tiles.launches, "K4": fused_panel_project_tiles.launches_x,
                "K3t": fused_panel_project.launches, "K4t": fused_panel_project.launches_x,
                "K5": bf.benes_fine.launches, "K6": bf.benes_coarse.launches, "K7": bf.benes_coarse2.launches,
                "K5w": bf.benes_fine_window.launches, "K7w": bf.benes_coarse2_window.launches,
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

    def profile_window(path, objective, dual, iters=10, kw=None):
        """A torch.profiler window over ``iters`` iterations of ``path``: the
        device's busy share of the window and the kernels' time by name;
        returns the kernels' launches per name (None if nothing was
        recorded)."""
        from torch.profiler import ProfilerActivity, profile

        agd = AcceleratedGradientDescent(max_iter=iters, **(kw or solver_kw))
        agd.maximize(objective, dual)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            agd.maximize(objective, dual)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start)
        if not spans:
            say("profile", path=path, device_busy_share="not measured", note="the profiler recorded no device time")
            return None
        busy, lo, hi = 0.0, spans[0][0], spans[0][1]
        for s0, e0, _ in spans[1:]:  # union of the device intervals
            if s0 > hi:
                busy, lo, hi = busy + hi - lo, s0, e0
            else:
                hi = max(hi, e0)
        busy += hi - lo
        span = spans[-1][1] - spans[0][0]
        by_name = {}
        for s0, e0, nm in spans:
            c, t = by_name.get(nm, (0, 0.0))
            by_name[nm] = (c + 1, t + e0 - s0)
        n_select = sum(c for nm, (c, _) in by_name.items() if "ndexSelect" in nm or "index_select" in nm)
        say("profile", path=path, iterations=iters, window_wall_ms=f"{wall_us / 1e3:.4f}",
            device_span_ms=f"{span / 1e3:.4f}", device_busy_ms=f"{busy / 1e3:.4f}",
            busy_share_of_wall=f"{busy / wall_us:.4f}", busy_share_of_span=f"{busy / span:.4f}",
            device_activities_per_iteration=len(spans) / iters, index_select_kernels_per_iteration=n_select / iters)
        for nm, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:14]:
            say("profile", path=path, kernel=repr(nm[:80]), per_iteration=c / iters,
                ms_per_iteration=f"{t / iters / 1e3:.4f}")
        return {nm: c for nm, (c, _) in by_name.items()}

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

    def variant(obj, cls=None, **attrs):
        """A shallow copy of a built objective with some attributes replaced."""
        new = (cls or type(obj)).__new__(cls or type(obj))
        new.__dict__.update({k: v for k, v in obj.__dict__.items() if k != "events"})
        new.events = []
        for k, v in attrs.items():
            setattr(new, k, v)
        return new

    certs, cert_dual = {}, None

    def certify(what, objective, dual):
        """The exact certificate at ``dual``: its numbers and its time."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = objective.exact_certificate(dual)
        ms = (time.perf_counter() - t0) * 1e3
        say("cert", layout=what, primal_ub=c["primal_ub"], dual_lb=c["dual_lb"], gap_rel=c["gap_rel"],
            max_row_violation=c["max_row_violation"], ms=f"{ms:.1f}", card=card)
        check(c["dual_lb"] <= c["primal_ub"], f"cert {what}: dual_lb {c['dual_lb']} > primal_ub {c['primal_ub']}")
        check(all(np.isfinite(v) for v in c.values()), f"cert {what}: not finite: {c}")
        return c

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
        want = {"K1g": n_tiles * args.iters, "K2g": n_tiles, "K1": 0, "K2": 0, "segsum": args.iters + 1}
        say("slice", launches=n_launch, expected=want,
            note="K1g/K2g: the gather form; K1/K2: the lam_g form, off the main path; segsum: one call "
                 "(two CUDA launches) per evaluation, all tiles at once")
        check_solution(res, obj, inp, args.iters, "csc slice")
        for k, v in want.items():
            check(n_launch[k] == v, f"csc slice: {k} launches {n_launch[k]} != {v}")
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
                plain_eval = lambda *a, block_k, want_x, out: fused_tile_gather_eval_T_reference(  # noqa: E731
                    *a, want_x=want_x, out=out)
                with rebound(fm, fused_tile_gather_eval_T=plain_eval):
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
        plan = obj.bcsc.row_sum
        ax_all = torch.empty(plan.slots, device=dev)
        views = [ax_all[off:off + t.a.numel()].view(t.a.shape) for off, t in zip(plan.offsets, tiles)]
        rows = [t.rows.reshape(-1) for t in tiles]
        lam_g = [scaled.index_select(0, r).view(t.a.shape) for r, t in zip(rows, tiles)]

        def run_gather(want_x, fn=None):
            fn = fn or fused_tile_gather_eval_T
            kw = {} if fn is fused_tile_gather_eval_T_reference else {"block_k": 1024}
            return [fn(scaled, t.rows, t.a, t.c, t.length, nig, s.proj_type, s.proj_params, want_x=want_x,
                       out=views[i] if fn is fused_tile_gather_eval_T else None, **kw)
                    for i, (t, s) in enumerate(zip(tiles, specs))]

        def run_lam_g(want_x):
            return [fused_tile_eval_T(lam_g[i], t.a, t.c, t.length, nig, s.proj_type, s.proj_params, block_k=1024,
                                      want_x=want_x) for i, (t, s) in enumerate(zip(tiles, specs))]

        def bound(bytes_per_slot):
            nbytes = slots * bytes_per_slot + cols * 4 + obj.bcsc.m * 4
            nops = sum(s.L * s.K * ops_per_slot(s.proj_type) for s in specs)
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_FLOP_PER_S * 1e3
            return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, nops

        biggest = specs[max(range(n_tiles), key=lambda i: specs[i].L * specs[i].K)]
        k1 = {}
        for name, want_x, replaces in (
            ("K1 fused_tile_gather_eval_T", False,
             "dualip_tpu/ops/pallas_matching.py:141, with the lambda gather XLA ran before it"),
            ("K2 fused_tile_gather_eval_T want_x", True, "dualip_tpu/ops/pallas_matching.py:159"),
        ):
            got = [tuple(v.clone() for v in g) for g in run_gather(want_x)]
            ref = run_gather(want_x, fn=fused_tile_gather_eval_T_reference)
            same = run_lam_g(want_x)
            torch.cuda.synchronize()
            err = check_err[want_x]
            for g, r, l_ in zip(got, ref, same):
                check(all(torch.equal(u, v) for u, v in zip(g, l_)), f"{name}: gather form != lam_g form on a slice tile")
                tol = tol_x(r[3] if want_x else r[0])
                e = float((g[0] - r[0]).abs().max())
                if want_x:
                    e = max(e, float((g[3] - r[3]).abs().max()))
                check(e <= tol, f"{name} on slice tile: err {e} > {tol}")
                for i in (1, 2):
                    check(abs(float(g[i]) - float(r[i])) <= 1e-3 + 1e-4 * abs(float(r[i])), f"{name} sums on slice tile")
                err = max(err, e)
            del got, ref, same
            t_k = cuda_ms(lambda: run_gather(want_x), reps=20, graph=True)
            t_lam = cuda_ms(lambda: run_lam_g(want_x), reps=20, graph=True)
            t_plain = cuda_ms(lambda: run_gather(want_x, fn=fused_tile_gather_eval_T_reference), reps=3, warmup=1)
            b_ms, b_by, nbytes, nops = bound(20 if want_x else 16)
            say("timing", kernel=repr(name), per_iteration_ms=f"{t_k.ms:.4f}", plain_ms=f"{t_plain.ms:.3f}",
                bound_ms=f"{b_ms:.4f}", share_of_bound=f"{b_ms / t_k.ms:.3f}", bytes=nbytes, ops=nops,
                lam_g_form_ms=f"{t_lam.ms:.4f}",
                largest_tile=(biggest.L, biggest.K), **timing_kv(t_k))
            kernels.append({
                "name": name, "route": "cuda", "source": "dualip_tpu_torch/csrc/fused_matching.cu",
                "replaces": replaces, "launches": csc_launches["K2g" if want_x else "K1g"], "max_abs_err": err,
                "ms": t_k.ms, "plain_ms": t_plain.ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None,  # no single PyTorch call computes the projection
            })
            k1[want_x] = (t_lam, err)
        # the lam_g form (the TPU kernel's contract), off the main path since the gather moved in
        t_lam, err = k1[False]
        t_plain = cuda_ms(lambda: [fused_tile_eval_T_reference(lam_g[i], t.a, t.c, t.length, nig, s.proj_type,
                                                                s.proj_params) for i, (t, s) in enumerate(zip(tiles, specs))],
                          reps=3, warmup=1)
        gather_t = cuda_ms(lambda: [scaled.index_select(0, r) for r in rows], reps=20, graph=True)
        b_ms, b_by, _, _ = bound(16)
        say("timing", kernel="'K1 fused_tile_eval_T (lam_g form)'", per_iteration_ms=f"{t_lam.ms:.4f}",
            gather_index_select_ms=f"{gather_t.ms:.4f}", lam_g_form_plus_gather_ms=f"{t_lam.ms + gather_t.ms:.4f}",
            gather_form_ms=f"{kernels[-2]['ms']:.4f}", **timing_kv(t_lam))
        kernels.append({
            "name": "K1 fused_tile_eval_T (lam_g form)", "route": "cuda",
            "source": "dualip_tpu_torch/csrc/fused_matching.cu", "replaces": "dualip_tpu/ops/pallas_matching.py:141",
            "launches": csc_launches["K1"], "max_abs_err": err, "ms": t_lam.ms, "plain_ms": t_plain.ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })

        # The segment-sum on the tiles' own a*x (the gather form's output at
        # the final dual): all tiles, then each tile alone (the others zero),
        # against a float64 index_add_, two launches bit for bit, and the plain
        # version (the kernel's order of additions) bit for bit.
        run_gather(False)
        rows_all = torch.cat(rows).long()
        ax_tiles = [ax_all]
        for off, t in zip(plan.offsets, tiles):
            only = torch.zeros_like(ax_all)
            only[off:off + t.a.numel()] = ax_all[off:off + t.a.numel()]
            ax_tiles.append(only)
        seg_err = 0.0
        for what, ax in zip(["all tiles"] + [(s_.L, s_.K) for s_ in specs], ax_tiles):
            got = segment_sum_rows(torch.zeros(obj.bcsc.m, device=dev), ax, plan)
            again = segment_sum_rows(torch.zeros(obj.bcsc.m, device=dev), ax, plan)
            plain_sum = segment_sum_rows_reference(torch.zeros(obj.bcsc.m, device=dev), ax, plan)
            v64 = ax.double()
            ref = torch.zeros(obj.bcsc.m, dtype=torch.float64, device=dev).index_add_(0, rows_all, v64)
            scale = float(torch.zeros(obj.bcsc.m, dtype=torch.float64, device=dev).index_add_(0, rows_all, v64.abs()).max())
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"segment-sum on slice {what}: two launches differ")
            check(torch.equal(got, plain_sum), f"segment-sum on slice {what}: kernel and plain version differ "
                                               f"by {float((got - plain_sum).abs().max())}")
            e = float((got.double() - ref).abs().max())
            check(e <= 1e-5 * max(1.0, scale), f"segment-sum on slice {what}: err {e} vs sum|v| {scale}")
            seg_err = max(seg_err, e)
            del got, again, plain_sum, v64, ref
        del ax_tiles
        say("slice", segment_sum_on=["all tiles"] + [(s_.L, s_.K) for s_ in specs], rows=obj.bcsc.m,
            windows=len(plan.windows), segments=plan.seg_row.numel(), items=plan.item_ptr.numel() - 1,
            max_abs_err_vs_float64=seg_err, tolerance="1e-5*max(1, max row sum of |v|)", repeat="bit-identical",
            vs_plain_version="bit-identical",
            max_abs_err_synthetic_shapes=segsum_err)
        grad = torch.zeros(obj.bcsc.m, device=dev)
        seg_t = cuda_ms(lambda: segment_sum_rows(grad, ax_all, plan), reps=20, graph=True)
        seg_plain = cuda_ms(lambda: segment_sum_rows_reference(grad, ax_all, plan), reps=3, warmup=1)
        atomic_t = cuda_ms(lambda: grad.index_add_(0, rows_all, ax_all), reps=5, graph=True)
        # the same kernel with every tile in one window: the gathers range over all of a*x
        one = build_row_sum_plan([t.rows.cpu().numpy() for t in tiles], [t.length.cpu().numpy() for t in tiles],
                                 obj.bcsc.m, True, window_bytes=plan.slots * 4)
        one = one._replace(**{f: torch.from_numpy(getattr(one, f)).to(dev)
                              for f in ("order", "seg_ptr", "seg_row", "item_ptr", "row_ptr", "row_segs")})
        one_t = cuda_ms(lambda: segment_sum_rows(grad, ax_all, one), reps=20, graph=True)
        del one
        seg_bound = nnz * 8 / PEAK_BYTES_PER_S * 1e3
        k1_ms = kernels[-3]["ms"]
        say("timing", segment_sum_kernel_ms=f"{seg_t.ms:.4f}", segment_sum_bound_ms=f"{seg_bound:.4f}",
            share_of_bound=f"{seg_bound / seg_t.ms:.3f}", plain_ms=f"{seg_plain.ms:.3f}",
            one_window_ms=f"{one_t.ms:.4f}", window_bytes=WINDOW_BYTES,
            index_add_atomic_ms=f"{atomic_t.ms:.4f}", K1_ms=f"{k1_ms:.4f}", iteration_ms=f"{ms_per_iter:.4f}",
            rest_ms=f"{ms_per_iter - seg_t.ms - k1_ms:.4f}", **timing_kv(seg_t))
        kernels.append({
            "name": "segment_sum_rows", "route": "cuda", "source": "dualip_tpu_torch/csrc/segment_sum.cu",
            "replaces": "none: XLA's segment_sum at dualip_tpu/objectives/matching.py:182, outside any TPU kernel",
            "launches": csc_launches["segsum"], "max_abs_err": seg_err, "ms": seg_t.ms, "plain_ms": seg_plain.ms,
            "bound_ms": seg_bound, "bound_by": "bytes", "library_ms": atomic_t.ms,
        })
        del lam_g, ax_all, views, rows_all, plain, r_f, r_p, res2
        torch.cuda.empty_cache()
        names = profile_window("csc", obj, res.dual_val)
        if names is not None:
            n_select = sum(c for nm, c in names.items() if "ndexSelect" in nm or "index_select" in nm)
            check(n_select < n_tiles * 10, f"{n_select} index_select kernels in 10 iterations: the lambda gather runs")
        if "cert" in phases:
            cert_dual = res.dual_val.clone()
            certs["csc at the csc dual"] = certify("csc", obj, cert_dual)
        del obj, captured["obj"], res
        torch.cuda.empty_cache()

        # Tiles in bf16 (the plain csc path: K1 has no bf16 form), 20 iterations,
        # beside the fp32 tiles' csc run; the same tiles with the segment-sum's
        # plain version (the kernel's order of additions) give the same log, bit
        # for bit.
        r16, n_launch, _ = solve(inp, n_chk, False, dtype="bfloat16")
        obj16 = captured["obj"]
        check(obj16.bcsc.tiles[0].a.dtype == torch.bfloat16, "csc bf16 tiles: the tiles are not bf16")
        log16 = np.asarray(r16.dual_objective_log)

        class PlainSegsum(MatchingSolverDualObjectiveFunction):
            def _local(self, *a, **kw):
                with rebound(matching_mod, segment_sum_rows=segment_sum_rows_reference):
                    return super()._local(*a, **kw)

        plain16 = rel_dev(first_iterations(variant(obj16, PlainSegsum), obj16.bcsc.m), log16)
        vs32 = rel_dev(log16, csc_log[:n_chk])
        say("slice", option="'dtype=bfloat16 (tiles), use_pallas=False'", iterations=n_chk,
            ms_per_iteration=f"{ms_per_iteration(obj16.events):.4f}", fp32_tiles_use_pallas_ms_per_iteration=f"{ms_per_iter:.4f}",
            objective_build_s=f"{captured['build_s']:.2f}", max_rel_dev_vs_plain=float(plain16.max()),
            max_rel_dev_vs_fp32_tiles=float(vs32.max()), launches=n_launch, card=card)
        check(plain16.max() == 0.0, f"csc bf16 tiles: kernel vs plain versions differ by {plain16.max()} relative")
        check(vs32.max() <= 4e-2, f"csc bf16 tiles drift {vs32.max()} relative from the fp32 tiles")
        check(n_launch["segsum"] == n_chk and n_launch["K1g"] == 0, f"csc bf16 tiles: launches {n_launch}")
        del obj16, r16, captured["obj"]
        torch.cuda.empty_cache()
        say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

    # ------------------------------------------------------------------ 9. butterfly slice
    if "butterfly" in phases:
        class PlainButterfly(MatchingSolverDualObjectiveFunction):
            """The same layout with every kernel's plain version, on the card."""

            def _local(self, bcsc, dual_val, gamma, want_primal=False, row_layout=None):
                def plain_carry(rl, vec, reverse, truncate=True):
                    p = rl.plan
                    v = plain_blocked(bf, p, vec, reverse)
                    return v if not truncate else v[: (p.n_in if reverse else p.n_out)]

                with rebound(matching_mod, _carry=plain_carry), \
                        rebound(fm, fused_panel_project_tiles=fused_panel_project_tiles_reference):
                    return super()._local(bcsc, dual_val, gamma, want_primal, row_layout)

        def butterfly_solve(data, sources, what, expect_coarse, index_launches):
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
                mask_bytes=plan.fine_masks.numel() + sum(m.numel() for m in plan.pre_masks + plan.post_masks),
                index_bytes=bf.index_bytes(plan), index_build_s=f"{plan.index_build_s:.3f}")
            say(what, objective_build_s=f"{captured['build_s']:.2f}", layout_build_s=f"{rl.build_seconds['total']:.2f}",
                routing_s=f"{rl.build_seconds['route']:.2f}", router=bf.last_route.get("router"),
                run_solver_s=f"{solve_s:.2f}", peak_device_bytes=peak)
            ms_it = ms_per_iteration(obj.events)
            say(what, iterations=len(res.dual_objective_log), ms_per_iteration=f"{ms_it:.4f}",
                iterations_per_s=f"{1e3 / ms_it:.2f}", final_dual_objective=res.dual_objective)
            # K3/K4: one launch per evaluation, all tiles; K3t/K4t: the per-tile form, off the main path;
            # K5w/K7w: the window kernels building the index once, at pack time
            want = {"K3": args.iters, "K4": 1, "K3t": 0, "K4t": 0, "K5": 2 * evals, expect_coarse: 4 * evals,
                    "K5w": 2, "K7w": index_launches}
            say(what, launches=n_launch, expected=want)
            check_solution(res, obj, data, args.iters, what)
            for k, v in want.items():
                check(n_launch[k] == v, f"{what}: {k} launches {n_launch[k]} != {v}")
            check(n_launch["K1g"] == n_launch["K1"] == n_launch["segsum"] == 0, f"{what}: the csc kernels ran: {n_launch}")
            log = np.asarray(res.dual_objective_log)
            plain_dev = rel_dev(first_iterations(variant(obj, PlainButterfly), obj.bcsc.m), log[:n_chk])
            say(what, plain_check_iterations=n_chk, max_rel_dev_vs_plain=float(plain_dev.max()), tolerance=1e-5)
            check(plain_dev.max() <= 1e-5, f"{what}: kernels vs plain versions differ by {plain_dev.max()} relative")
            res2, _, _ = solve(data, args.iters, False, objective_type="matching_smoke_prebuilt", objective=obj)
            rep = rel_dev(res2.dual_objective_log, log)
            say(what, repeat_of_the_solve="bit-identical" if rep.max() == 0 else "DIFFERS", max_rel_dev=float(rep.max()))
            check(rep.max() == 0.0, f"{what}: two butterfly solves differ by {rep.max()} relative")
            return res, obj, n_launch, ms_it

        res, obj, bfly_launches, bfly_ms = butterfly_solve(inp, args.sources, "butterfly", "K7", 4)
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

        def time_benes(name, replaces, fn, ref_fn, side_bytes, n_launches, window_fn=None, variants=()):
            """ms of one launch group, the plain version's, the bound (8 B of
            payload and ``side_bytes`` of index or mask planes per slot), the
            payload-only floor, the library call (index_select by the group's
            own permutation) and, for a gather, its window form (the stage
            windows that build the index) in the same call; ``variants`` are
            (label, module attributes) timed beside it."""
            src = fn(ids.clone())  # the kernel moves 4-byte payloads of any type
            check(torch.equal(src, ref_fn(ids)), f"{name}: kernel differs from its plain version at the slice's shape")
            t_k = cuda_ms(lambda: fn(buf), reps=10, graph=True)
            ms = t_k.ms
            plain_ms = cuda_ms(lambda: ref_fn(buf), reps=2, warmup=1).ms
            lib_ms = cuda_ms(lambda: buf.index_select(0, src), reps=5, graph=True).ms
            bound = N * (8 + side_bytes) / PEAK_BYTES_PER_S * 1e3
            floor = N * 8 / PEAK_BYTES_PER_S * 1e3
            extra = {}
            if window_fn is not None:
                check(torch.equal(window_fn(ids.clone()), src), f"{name}: the window form differs from the gather")
                extra["window_ms"] = cuda_ms(lambda: window_fn(buf), reps=10, graph=True).ms
            for label, attrs in variants:
                with rebound(bf, **attrs):
                    check(torch.equal(fn(ids.clone()), src), f"{name} {label}: differs from the plain version")
                    extra[f"ms_{label}"] = cuda_ms(lambda: fn(buf), reps=10, graph=True).ms
            say("timing", kernel=repr(name), ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.4f}",
                share_of_bound=f"{bound / ms:.3f}", payload_floor_ms=f"{floor:.4f}",
                library_index_select_ms=f"{lib_ms:.4f}", **{k: f"{v:.4f}" for k, v in extra.items()},
                side_bytes_per_slot=side_bytes, slots=N, **timing_kv(t_k))
            kernels.append({
                "name": name, "route": "cuda", "source": "dualip_tpu_torch/csrc/benes.cu", "replaces": replaces,
                "launches": n_launches, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes", "library_ms": lib_ms, "payload_floor_ms": floor, **extra,
            })
            return ms

        k5_ms = time_benes(
            "K5 benes_fine", "dualip_tpu/ops/butterfly.py:520",
            lambda v: bf.benes_fine(v, plan.fine_masks, plan.fine_dists, src=plan.fine_src_fwd),
            lambda v: bf.benes_fine_reference(v, plan.fine_masks, plan.fine_dists),
            2, bfly_launches["K5"],
            window_fn=lambda v: bf.benes_fine_window(v, plan.fine_masks, plan.fine_dists))
        (steps7, E7, R7), m7 = plan.pre_groups[0], plan.pre_masks[0]
        check(isinstance(E7, tuple), "the slice's coarse side is not a two-axis group")
        src7 = bf._direction(plan.pre_src[0], False)
        check(len(src7) == 1, "the slice's coarse side is not one gather launch")
        k7_ms = time_benes(
            "K7 benes_coarse2", "dualip_tpu/ops/butterfly.py:606",
            lambda v: bf.benes_coarse2(v, m7, steps7, *E7, R7, src7),
            lambda v: bf.benes_coarse2_reference(v, m7, steps7, *E7, R7),
            2, bfly_launches["K7"],
            window_fn=lambda v: bf.benes_coarse2_window(v, m7, steps7, *E7, R7),
            variants=(("rows_32B", {"GATHER_ROW_BYTES": 32}),))  # 8 fp32 lanes, a 96 KB strip
        carry_src = bf.apply_butterfly_cuda(plan, ids.clone(), truncate=False)
        carry_ms = cuda_ms(lambda: bf.apply_butterfly_cuda(plan, buf, truncate=False), reps=10, graph=True).ms
        carry_lib_ms = cuda_ms(lambda: buf.index_select(0, carry_src), reps=5, graph=True).ms
        say("timing", whole_carry_ms=f"{carry_ms:.4f}", K5_plus_two_K7_ms=f"{k5_ms + 2 * k7_ms:.4f}",
            library_one_index_select_ms=f"{carry_lib_ms:.4f}", slots=N)
        del carry_src, ids

        time_panel("butterfly", obj, dev, kernels, panel_err, bfly_launches)
        k3_ms = kernels[-2]["ms"]
        say("timing", butterfly_iteration_ms=f"{bfly_ms:.4f}", two_carries_ms=f"{2 * carry_ms:.4f}", K3_ms=f"{k3_ms:.4f}",
            rest_ms=f"{bfly_ms - 2 * carry_ms - k3_ms:.4f}", rest="srow build, row sums, (m,) gather, calc_grad, AGD step")
        names = profile_window("butterfly", obj, res.dual_val)
        if names is not None:
            check(not any("reduce_partials" in nm for nm in names), "butterfly: reduce_partials ran")
            n_panel = sum(c for nm, c in names.items() if "panel_tiles_kernel" in nm)
            check(n_panel == 10, f"butterfly: {n_panel} panel launches in 10 iterations, expected 10")
        if "cert" in phases:
            certs["butterfly at its own dual"] = certify("butterfly", obj, res.dual_val)
            if cert_dual is not None:
                certs["butterfly at the csc dual"] = certify("butterfly", obj, cert_dual)
        del buf, obj, res, captured["obj"], rl, plan, m7, src7
        torch.cuda.empty_cache()
        say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

        # ---- tiles in bf16: the panel kernel's bf16-tile instances, 20 iterations
        r16, n16, _ = solve(inp, n_chk, True, layout="butterfly", dtype="bfloat16")
        obj16 = captured["obj"]
        check(obj16.panel_table.tile_dtype == torch.bfloat16, "butterfly bf16 tiles: the panel table is not bf16")
        log16 = np.asarray(r16.dual_objective_log)
        plain16 = rel_dev(first_iterations(variant(obj16, PlainButterfly), obj16.bcsc.m), log16)
        vs32 = rel_dev(log16, log[:n_chk])
        say("butterfly", option="'dtype=bfloat16 (tiles)'", iterations=n_chk,
            ms_per_iteration=f"{ms_per_iteration(obj16.events):.4f}", fp32_tiles_ms_per_iteration=f"{bfly_ms:.4f}",
            objective_build_s=f"{captured['build_s']:.2f}", max_rel_dev_vs_plain=float(plain16.max()),
            max_rel_dev_vs_fp32_tiles=float(vs32.max()), launches=n16, card=card)
        check(plain16.max() <= 1e-5, f"butterfly bf16 tiles: kernels vs plain versions differ by {plain16.max()}")
        check(vs32.max() <= 4e-2, f"butterfly bf16 tiles drift {vs32.max()} relative from the fp32 tiles")
        check(n16["K3"] == n_chk and n16["K4"] == 1, f"butterfly bf16 tiles: launches {n16}")
        time_panel("butterfly, bf16 tiles", obj16, dev, kernels, panel_err, n16)
        del obj16, r16, captured["obj"]
        torch.cuda.empty_cache()
        say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

        # ---- compact packing on the same data, 20 iterations
        r_c, n_launch, _ = solve(inp, n_chk, False, layout="butterfly", compact=True, keep_col_tiles=False,
                                 keep_flat_idx=False)
        obj_c = captured["obj"]
        rl_c = obj_c.row_layout
        d = rel_dev(r_c.dual_objective_log, log[:n_chk]).max()
        say("butterfly", option="'compact=True'", iterations=n_chk, ms_per_iteration=f"{ms_per_iteration(obj_c.events):.4f}",
            carry_slots=rl_c.plan.N, tiles=len(rl_c.col_tiles_T), row_tiles=len(rl_c.row_tiles),
            packs_L_L2_q=rl_c.col_pack, objective_build_s=f"{captured['build_s']:.2f}",
            routing_s=f"{rl_c.build_seconds['route']:.2f}", max_rel_dev_vs_plain_panels=float(d), launches=n_launch)
        check(d <= 1e-4, f"compact packing drifts {d} relative from the plain panels")
        check(n_launch["K3"] == n_chk and n_launch["K3t"] == 0, f"compact: K3 launches {n_launch}, expected {n_chk}")
        time_panel("compact", obj_c, dev, kernels, panel_err)
        names = profile_window("compact", obj_c, r_c.dual_val)
        if names is not None:
            n_panel = sum(c for nm, c in names.items() if "panel_tiles_kernel" in nm)
            check(n_panel == 10, f"compact: {n_panel} panel launches in 10 iterations, expected 10")
        del obj_c, rl_c, r_c, captured["obj"]
        torch.cuda.empty_cache()

        # ---- the smaller solve: nb <= 256, one single-axis group a side (K6)
        t0 = time.perf_counter()
        small = generate_synthetic_matching_input_args(
            SMALL_SOURCES, args.destinations, args.sparsity, seed=args.seed)
        say("butterfly-small", generate_s=f"{time.perf_counter() - t0:.2f}")
        res_s, obj_s, small_launches, _ = butterfly_solve(small, SMALL_SOURCES, "butterfly-small", "K6", 0)
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

    # ------------------------------------------------------------------ 10. cert
    if "cert" in phases:
        same = [certs.get(k) for k in ("csc at the csc dual", "butterfly at the csc dual")]
        check(all(same), "cert: needs the slice and butterfly phases")
        devs = {k: abs(same[0][k] - same[1][k]) / max(1.0, abs(same[0][k])) for k in ("primal_ub", "dual_lb")}
        say("cert", csc_vs_butterfly_at_one_dual=devs, tolerance="1e-3 relative (fp32 sums in another order)",
            certificates=len(certs))
        check(max(devs.values()) <= 1e-3, f"cert: csc and butterfly differ at one dual: {devs}")

    # ------------------------------------------------------------------ 11. lp
    if "lp" in phases:
        phase_lp(dt, inp, card, captured, counts, reset_counts, profile_window, ms_per_iteration, Timed)
        say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

    # ------------------------------------------------------------------ 12. io
    if "io" in phases:
        phase_io(dt, args, card, gen_s, inp, captured, counts, solve, ms_per_iteration, n_chk)
        say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

    # ------------------------------------------------------------------ 13. obs
    if "obs" in phases:
        phase_obs(dt, inp, card, captured, reset_counts, counts, n_chk, solver_kw)
        say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

    # ------------------------------------------------------------------ canonical (opt-in)
    if "canonical" in phases:
        phase_canonical(args, card, captured, solve, ms_per_iteration, solver_kw)
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
