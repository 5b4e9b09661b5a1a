#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dualip_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--sources N] [--iters N]

Phases, one output line or more each:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the hand-written kernels from this checkout (``nvcc``);
3. kernels: each kernel against its plain PyTorch version on the card, for
   every projection kind, at L in {1, 2, 8, 32, 100, the slice's largest L};
4. golden: the 5x5 matching golden trace through ``run_solver`` on the card;
5. slice: the synthetic matching LP (2,500,000 sources x 10,000 destinations,
   sparsity 1e-3, seed 42; ``--sources 25000000`` is the full canonical
   shape) solved through ``run_solver`` with the fused kernel for 200
   iterations, its kernel launches counted, its first 20 iterations
   repeated with the plain version on the card and compared; then each
   kernel timed on the slice's tiles beside its plain version and its bound.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
the last line.  Without a CUDA device, or without the repository beside it,
the script exits non-zero.
"""

from __future__ import annotations

import argparse
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
    """Arithmetic per tile slot, counted from csrc/fused_matching.cu."""
    base = 3 + 1 + 1 + 4  # z (2 mul, 1 add), mask, a*x, c*x and x*x sums
    if kind in ("simplex", "simplex_eq"):
        return base + 4 + 3 * BISECTION_ITERS + 3  # clamp/div/max/shift, (sub, max, add) per step, final
    if kind in ("box_cut", "box_cut_eq"):
        return base + 5 + 4 * BISECTION_ITERS + 3  # min/max/clip sum, (sub, clip, add) per step, final
    return base + 2  # clamps


def tol_x(ref: torch.Tensor) -> float:
    return 5e-5 * max(1.0, float(ref.abs().max()))


def phase_kernels(widths, dev):
    """Every (kind, params) case at each width and both want_x, kernel vs plain."""
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
    res = dt.run_solver(
        MatchingInputArgs(
            A=csc_from_dense(A_COMPACT.T), c=csc_from_dense(-A_COMPACT.T),
            projection_map=create_projection_map("simplex", {"z": 1}, 5), b_vec=np.full(5, 0.7, np.float32),
        ),
        dt.SolverArgs(max_iter=30, gamma=1e-3, initial_dual_path=str(dual0)),
        dt.ComputeArgs(),
        dt.ObjectiveArgs(objective_kwargs={"use_pallas": True, "pallas_block_k": 8}),
    )
    check(res.dual_val.device.type == "cuda", "golden solve did not run on the card")
    worst = 0.0
    for i, want in GOLDEN:
        got = res.dual_objective_log[i - 1]
        worst = max(worst, abs(got - want))
        check(abs(got - want) < 1e-5, f"golden trace iter {i}: {got} vs {want}")
    say("golden", iterations=len(res.dual_objective_log), max_abs_dev=worst, tolerance=1e-5, card=dev_name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sources", type=int, default=2_500_000)
    ap.add_argument("--destinations", type=int, default=10_000)
    ap.add_argument("--sparsity", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--check-iters", type=int, default=20)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import dualip_tpu_torch as dt
    from dualip_tpu_torch.objectives.matching import MatchingSolverDualObjectiveFunction, matching_local_parts_pallas
    from dualip_tpu_torch.ops import _build
    from dualip_tpu_torch.ops.fused_matching import (
        fused_tile_eval_T,
        fused_tile_eval_T_reference,
        num_partial_blocks,
    )
    from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent
    from dualip_tpu_torch.synthetic import generate_synthetic_matching_input_args

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

    # 2. build (one nvcc per source, all started together)
    t0 = time.perf_counter()
    logs = _build.build(["fused_matching"])
    build_s = time.perf_counter() - t0
    regs = [int(r) for log in logs.values() for r in re.findall(r"Used (\d+) registers", log)]
    say("build", seconds=f"{build_s:.2f}", kernels_compiled=len(regs), max_registers=max(regs, default="cached"))
    for log in logs.values():  # ptxas -v: name each kernel that spills registers
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            entry = m.group(1) if m else entry
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and int(m.group(1)) > 0:
                say("build", spilling_kernel=entry, spill_store_bytes=m.group(1))

    # 5a. generate the slice's data (the largest L is needed by phase 3)
    t0 = time.perf_counter()
    inp = generate_synthetic_matching_input_args(
        args.sources, args.destinations, args.sparsity, seed=args.seed
    )
    gen_s = time.perf_counter() - t0
    l_max = int(inp.A.col_lengths.max())
    say("generate", sources=args.sources, destinations=args.destinations, sparsity=args.sparsity,
        seed=args.seed, nnz=inp.A.nnz, max_column_degree=l_max, seconds=f"{gen_s:.2f}")

    # 3. each kernel against its plain version on the card
    widths = sorted({1, 2, 8, 32, 100, l_max})
    check_err = phase_kernels(widths, dev)

    # 4. golden trace
    phase_golden(dev_name)

    # 5. the slice through run_solver; the objective is the port's, subclassed
    # only to record a CUDA event around each evaluation (no host sync).
    captured = {}

    class TimedMatching(MatchingSolverDualObjectiveFunction):
        def calculate_traceable(self, params, dual_val, gamma):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            res = super().calculate_traceable(params, dual_val, gamma)
            e.record()
            self.events.append((s, e))
            return res

    @dt.register_objective("matching_smoke")
    def _factory(input_args, solver_args, compute_args, mesh, **kw):
        t = time.perf_counter()
        obj = TimedMatching(input_args, gamma=solver_args.gamma, device=compute_args.host_device, **kw)
        torch.cuda.synchronize()
        obj.events = []
        captured["obj"], captured["build_s"] = obj, time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats()
        return obj

    solver_args = dt.SolverArgs(
        max_iter=args.iters, gamma=1e-3, initial_step_size=1e-3, max_step_size=1e-1, save_primal=True
    )
    objective_args = dt.ObjectiveArgs(objective_type="matching_smoke", objective_kwargs={"use_pallas": True})
    fused_tile_eval_T.launches = 0  # counts from here on are the main path's
    fused_tile_eval_T.launches_x = 0
    t0 = time.perf_counter()
    res = dt.run_solver(inp, solver_args, dt.ComputeArgs(), objective_args)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches, launches_x = fused_tile_eval_T.launches, fused_tile_eval_T.launches_x
    peak = torch.cuda.max_memory_allocated()
    obj = captured["obj"]
    ev = obj.events
    specs, tiles = obj.bcsc.specs, obj.bcsc.tiles
    n_tiles = len(tiles)
    slots = sum(s.L * s.K for s in specs)
    cols = sum(s.K for s in specs)
    first_iter_ms = ev[0][0].elapsed_time(ev[0][1])
    ms_per_iter = ev[1][0].elapsed_time(ev[-1][1]) / (len(ev) - 1)
    log = res.dual_objective_log
    say("slice", nnz=obj.bcsc.nnz, tiles=n_tiles, tile_shapes=[(s.L, s.K) for s in specs],
        max_bucket_L=max(s.L for s in specs), slots=slots, pad_ratio=f"{slots / obj.bcsc.nnz:.4f}")
    say("slice", generate_s=f"{gen_s:.2f}", objective_build_s=f"{captured['build_s']:.2f}",
        time_to_first_iteration_s=f"{captured['build_s'] + first_iter_ms / 1e3:.3f}",
        first_iteration_ms=f"{first_iter_ms:.3f}", run_solver_s=f"{solve_s:.2f}")
    say("slice", iterations=len(log), ms_per_iteration=f"{ms_per_iter:.4f}",
        iterations_per_s=f"{1e3 / ms_per_iter:.2f}", window="start of iteration 2 to end of the last evaluation",
        final_dual_objective=res.dual_objective, peak_device_bytes=peak)
    say("slice", K1_launches=launches, K2_launches=launches_x, expected_K1=n_tiles * args.iters,
        expected_K2=n_tiles)
    check(len(log) == args.iters and all(np.isfinite(log)), "non-finite dual objective log")
    check(launches == n_tiles * args.iters, f"K1 launches {launches} != tiles x iterations {n_tiles * args.iters}")
    check(launches_x == n_tiles, f"K2 launches {launches_x} != tiles {n_tiles}")
    check(res.dual_val.device.type == "cuda" and bool(torch.isfinite(res.dual_val).all()), "dual not finite on card")
    check(bool((res.dual_val >= 0).all()), "dual left the nonnegative cone")
    x = res.objective_result.primal_var
    check(x.shape == (obj.bcsc.nnz,) and np.isfinite(x).all() and (x >= 0).all(), "primal_var malformed")
    col_sums = np.add.reduceat(x, inp.A.indptr[:-1][inp.A.col_lengths > 0])
    check(col_sums.max() <= 1.0 + 1e-4, f"primal column sums exceed the simplex: {col_sums.max()}")
    check(log[-1] > log[0], "the dual objective did not rise")

    # The first iterations again, with the plain version on the card (same tiles).
    class PlainTiles(MatchingSolverDualObjectiveFunction):
        def _local(self, bcsc, dual_val, gamma, want_primal=False):
            return matching_local_parts_pallas(
                bcsc, dual_val, gamma, self.pallas_block_k, want_primal,
                tile_eval=lambda *a, block_k, want_x: fused_tile_eval_T_reference(*a, want_x=want_x),
            )

    plain = PlainTiles.__new__(PlainTiles)
    plain.__dict__.update({k: v for k, v in obj.__dict__.items() if k != "events"})
    n_chk = min(args.check_iters, args.iters)

    def first_iterations(objective):
        return np.array(AcceleratedGradientDescent(
            max_iter=n_chk, gamma=1e-3, initial_step_size=1e-3, max_step_size=1e-1
        ).maximize(objective, torch.zeros(obj.bcsc.m, device=dev)).dual_objective_log)

    def rel_dev(got, want):
        return np.abs(got - want) / np.maximum(1.0, np.abs(want))

    # The segment-sum's float atomics add in a new order on every run, and
    # once the step size opens (iteration 15) that alone moves the log by up
    # to ~1e-3 relative at the canonical shape.  Fused and plain are compared
    # with torch's deterministic index_add_, so only the kernel differs; a
    # repeat of the fused run with atomics shows the run-to-run spread.
    repeat_dev = rel_dev(first_iterations(obj), np.asarray(log[:n_chk]))
    g_t = torch.full((), 1e-3, dtype=torch.float32, device=dev)
    torch.use_deterministic_algorithms(True)
    try:
        fused_det = first_iterations(obj)
        plain_dev = rel_dev(first_iterations(plain), fused_det)
        # and one evaluation of both at the final dual
        r_f = obj.calculate_traceable(obj.params, res.dual_val, g_t)
        r_p = plain.calculate_traceable(plain.params, res.dual_val, g_t)
    finally:
        torch.use_deterministic_algorithms(False)
    say("slice", plain_check_iterations=n_chk, max_rel_dev_vs_plain=float(plain_dev.max()), tolerance=1e-4,
        scatter="deterministic", max_rel_dev_fused_repeat_atomic_scatter=float(repeat_dev.max()))
    say("slice", rel_dev_vs_plain_per_iteration=",".join(f"{v:.2e}" for v in plain_dev))
    say("slice", rel_dev_fused_repeat_per_iteration=",".join(f"{v:.2e}" for v in repeat_dev))
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

    kernels = []
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
        ms = cuda_ms(lambda: run(fused_tile_eval_T, want_x), reps=20)
        plain_ms = cuda_ms(lambda: run(fused_tile_eval_T_reference, want_x), reps=3, warmup=1)
        nbytes = slots * (20 if want_x else 16) + cols * 4
        nops = sum(s.L * s.K * ops_per_slot(s.proj_type) for s in specs)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_FLOP_PER_S * 1e3
        biggest = max(range(n_tiles), key=lambda i: specs[i].L * specs[i].K)
        big = specs[biggest]

        def run_big():
            t = tiles[biggest]
            fused_tile_eval_T(lam_g[biggest], t.a, t.c, t.length, nig, big.proj_type, big.proj_params,
                              block_k=1024, want_x=want_x)

        big_ms = cuda_ms(run_big, reps=50)
        big_bound = (big.L * big.K * (20 if want_x else 16) + big.K * 4) / PEAK_BYTES_PER_S * 1e3
        say("timing", kernel=repr(name), per_iteration_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}",
            bound_ms=f"{max(t_bytes, t_ops):.4f}", bytes=nbytes, ops=nops,
            largest_tile=(big.L, big.K), largest_tile_ms=f"{big_ms:.4f}", largest_tile_bound_ms=f"{big_bound:.4f}",
            partial_blocks=num_partial_blocks(big.proj_type, big.L, big.K))
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "dualip_tpu_torch/csrc/fused_matching.cu",
            "replaces": replaces,
            "launches": launches_x if want_x else launches,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,  # no single PyTorch call computes the projection
        })

    # The torch ops around the kernel on the main path: gather and segment-sum.
    grad = torch.zeros(obj.bcsc.m, device=dev)
    axs = [torch.ones_like(t.a) for t in tiles]
    gather_ms = cuda_ms(lambda: [scaled.index_select(0, r) for r in rows], reps=20)
    scatter_ms = cuda_ms(lambda: [grad.index_add_(0, r, ax.view(-1)) for r, ax in zip(rows, axs)], reps=20)
    torch.use_deterministic_algorithms(True)
    try:
        scatter_det_ms = cuda_ms(lambda: [grad.index_add_(0, r, ax.view(-1)) for r, ax in zip(rows, axs)], reps=1, warmup=1)
    finally:
        torch.use_deterministic_algorithms(False)
    say("timing", gather_index_select_ms=f"{gather_ms:.4f}", segment_sum_index_add_ms=f"{scatter_ms:.4f}",
        segment_sum_deterministic_ms=f"{scatter_det_ms:.4f}", K1_ms=f"{kernels[0]['ms']:.4f}",
        iteration_ms=f"{ms_per_iter:.4f}")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
