#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dualip_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--sources N] [--iters N] [--phases a,b,...]

Phases, one output line or more each (``--phases`` runs a subset; the two
result lines at the end are printed only by a run of every default phase):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile every hand-written kernel from this checkout (one ``nvcc``
   per source, all started together) and the native Benes router (``g++``);
3. kernels: the fused tile kernel (K1/K2) against its plain PyTorch version on
   the card, for every projection kind, at L in {1, 2, 8, 16, 29, 32, 65, 100,
   128, 394, 513, 1000, 1024, 2048, 2100, 4096, 8192, 9254, 20000, 60000}
   (above 64 one warp a column, in registers, to 512; above, one block a
   column of 128 to 1024 threads, its lanes in registers to 16,384, in shared
   memory to 57,856, re-read above), at m = 64, 10,000 and 70,000, and a
   second launch bit for bit against the first; ml20m: K1 on each csc tile of the benchmark's ml20m-csc-fused cell
   (``gpubench/``'s movielens-20m stand-in, built as the cell builds it),
   each tile's launch timed alone by graph replays beside its bound, and held
   to the plain version; ml20m_panel: K3 the same way on each tile of the
   ml20m-butterfly cell's layout (one tile a launch), then the all-tiles
   call, and as tables of their own the tiles above L = 512 (the kernel's
   block form) and the rest, the all-tiles call held to the plain version,
   to one call a tile and to itself bit for bit, its calls to the block form
   counted;
4. segsum: the windowed fixed-order row segment-sum over several tiles at
   once against a float64 ``index_add_``, and two launches bit for bit;
   simplex: the sort-and-scan simplex kernel of the default csc path against
   its plain version bit for bit at every L from 1 to 64 and within fp32 of
   the torch ops, then on the tiles the path projects at the canonical shape
   (the benchmark generator's column lengths, bucketed as the tiles are
   built) timed and held bit for bit again;
5. benes: the three Benes kernels (K5 fine and K7 two-axis coarse side, the
   gathers through the plan's source index; K6 coarse group, stage windows)
   against the plain stages with ``torch.equal``, forward and reverse, fp32
   and bf16, in every regime of the block count, and the index the window
   kernels build on the card against the index the plain stages build;
6. panel: the panel kernel (K3/K4) one tile a launch against its plain
   version for every projection kind, q = 1 and q > 1, L a power of two and
   not, either side of the largest L the kernel's ring holds (47, for every
   carry and tile type) and above it, where a warp projects a column
   (L = 96, 200, 394 with 64 buffer rows, over the whole grid) and above 512,
   where a block projects a column (L = 600, 2100: the kernel's block form, a
   launch a tile), in all four instances: fp32 and bf16 carry x
   fp32 and bf16 a/c tiles, a bf16 tile's launch bit for bit with the fp32
   launch on the same values; the rest of the buffer unchanged, ghost lanes
   zero; then all tiles of a mixed table (L = 1, 2, 5, 16, 29, 48, 64, 96,
   100, 200, 394, 600, 2100 plain, 3, 29, 34 compact, the kinds mixed across
   tiles) in one call, in all four instances, against the plain version, against one
   launch per tile bit for bit on a*x and x, and repeated bit for bit on a*x,
   x, obj and reg;
7. golden: the 5x5 matching golden trace through ``run_solver`` on the card,
   csc layout and butterfly layout (plain, compact, ``srow_gather``, bf16);
8. slice: the synthetic matching LP (2,500,000 sources x 10,000 destinations,
   sparsity 1e-3, seed 42) through ``run_solver`` on the csc layout with the
   fused kernel in its gather form, its launches counted, its first 20
   iterations repeated with the plain version and compared, a repeat that must
   be bit-identical, and the segment-sum against a float64 ``index_add_`` and against its plain
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
12. examples: the port's examples (``dualip_tpu_torch/examples``) as a user
   runs them, at the MovieLens-shaped proxy's full shape (26,744 x 138,493,
   1,923,742 nnz, the JAX run's exactly): ``proxy_validation.run_ours`` for
   10,000 iterations on csc (``use_pallas=True``), on butterfly and with the
   two fairness rows, each log held to the reference's committed log by the
   example's own gates (final within 1e-6, fairness within 1.5 x the
   reference's own sensitivity, the last 10% within 2e-4, a positive
   fairness dual) and its first iteration within 1e-6 of the JAX package's;
   the launches counted, the kernels against their plain versions over 20
   iterations, K1 tile by tile (L up to 394; above 64 one warp a column) and
   K3 through all its tiles, each tile alone with its bound and share, the
   fairness solve's first 200
   iterations repeated bit for bit; then the MIPLIB script through its
   command line (exit code 0);
13. graph: every single-device path's CUDA graph (``maximize`` on a CUDA
   dual: iteration 1 eager, then replays of one captured iteration) held to
   the eager loop (``_maximize_eager``) on the same objective and start for
   20 iterations, each on a solver of its own run three times (the first
   run, a second timed by one CUDA event pair, a third under the profiler):
   logs and final duals bit for bit both ways and across the repeats, one
   capture, the graph's first run calling each wrapper for iteration 1 and
   the capture only, and the port's kernels that the profiler sees in the
   graph's replays equal to the eager loop's launches; each one's ms an
   iteration, busy share and activities, peak device bytes and the graph's
   nodes by kind (the profiler's records of a replay): csc ``use_pallas``,
   plain csc and bf16 tiles (in phase slice), butterfly, compact,
   ``srow_gather``, bf16 carry and bf16 tiles (butterfly), the LP's COO and
   butterfly layouts (lp) and the fairness objective on the proxy
   (examples); ``launch_chunk=50`` over the
   slice's csc iterations (four ``chunk_walls``, the same log), a cached
   graph reading each call's params (``b_vec`` rebound between two
   ``maximize`` calls: the eager loop's bits on the new b after one more
   capture), and one graph captured by each golden solve.  Every other
   solve of the script runs on the graph too (the plain versions' in the eager loop): its ms an
   iteration is one CUDA event pair around a second ``maximize`` that only
   replays (``replay_ms``); a ``run_solver`` solve's launches are the
   profiler's records of the kernels on the card, and its wrappers are
   called for iteration 1, the capture and any evaluation after the loop
   (``graph_calls``);
14. io: the I/O tiers at the slice's shape on the native generator's data
   (the native library must build), in a fresh temporary cache directory:
   generation timed beside the numpy generator, a warm load equal to the cold
   arrays, the native tile fill equal to the numpy fill (both timed), and the
   butterfly objective built cold (routing, plan and tile caches written) and
   warm (from the tile cache): each one's time to first iteration, K3, K5, K7
   and the index-building window kernels launched on the warm objective, and
   the two 20-iteration dual logs bit-identical;
15. obs: ``run_solver`` with MLflow enabled completes (a no-op without
   mlflow) and gives the log of the solve without it, ``trace`` around three
   csc iterations writes a trace naming K1's and the segment-sum's kernels and
   the ``annotate`` span, and ``collect_stats`` fills ``last_run_stats``;
16. dist: the entity-sharded solve (``dualip_tpu_torch/parallel``) on this
   one card.  (a) A world of one NCCL rank in this process, every mesh path
   on the AGD's CUDA graph with the all_reduce captured: csc ``use_pallas``
   (200 iterations through ``run_solver``, wrapper calls counted), csc plain (50),
   butterfly and compact (50 each), the general LP split by columns on
   lp-2.5M's COO (200) and on lp-dense-100K (its first 100,000 variables as
   a dense array, 50).  Each whole log bit for bit against the eager mesh
   loop's and the one-device graph log; then over 20 iterations as phase
   graph holds a path (one capture, the log and dual bit for bit, the
   replays' kernels the eager loop's, ms an iteration graph and eager) plus
   the all_reduce's calls (one an eager iteration, two on the graph's first
   run) and NCCL's kernels a replay against an eager iteration's; NCCL's
   version.  The csc
   objective with and without its mesh in turns on the graph, the
   all_reduce of m + 2 floats timed.  Whether NCCL takes two ranks on one
   card (what it says).  (b) Two ranks spawned on the card over gloo (the
   reduction through host memory), reading the slice from the generator
   cache this process writes, each through ``run_solver
   (compute_device_num=2)``: csc ``use_pallas`` 200 iterations and butterfly
   50, each twice, in the eager loop (no capture: the path rule keeps gloo
   off the graph); the ranks' logs bit-identical to each other and to their
   repeats, the first 10 iterations within 1e-5 and the last within 1e-2 of
   the one-device logs, the launches, and each rank's K1 and segment-sum (and
   its carries and K3) against their plain versions on its own shard.  The
   ranks' times are two processes sharing one card, not a multi-GPU figure.

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

from dualip_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12  # counts an FMA as two operations
# fp32 operations that are not FMAs (the bisection's subtract, max and add):
# one per lane and clock, 132 SMs x 128 lanes x 1.98 GHz
NON_FMA_OPS_PER_S = 132 * 128 * 1.98e9
BISECTION_ITERS = 30

SMALL_SOURCES = 250_000  # the second butterfly solve: few enough blocks for one single-axis group a side
ALL_PHASES = ("kernels", "ml20m", "ml20m_panel", "segsum", "simplex", "benes", "panel", "golden", "slice", "butterfly", "cert", "lp",
              "examples", "graph", "io", "obs", "dist")
# the single-device paths phase graph holds to the eager loop (each checked in the phase that builds it)
GRAPH_PATHS = ("csc use_pallas", "csc plain", "csc bf16 tiles", "butterfly", "butterfly compact",
               "butterfly srow_gather", "butterfly carry_dtype=bfloat16", "lp-2.5M coo", "lp-2.5M butterfly",
               "fairness proxy")
GRAPH_TIMING_ITERS = 50  # replays in a solve's ms/iteration on the graph (replay_ms)
# A torch.profiler window on the H100 machines may lose the records of its first kernels on the card: a
# few, an eager window's first iteration, or every record of a short one, in some runs in every window
# (and records may precede their own launch on the host's clock; tools/profiler_clock_probe.py).  So each
# window opens with spin kernels, each waited for, whose records may go (PROFILER_LEAD_KERNELS, more at each
# attempt), and ``lost_records`` holds the window's first launches after them to their records: a window
# that lost any runs again, up to len(PROFILER_LEAD_KERNELS) times in all.
PROFILER_LEAD_KERNELS = (32, 128, 512, 2048, 8192)  # by attempt
PROFILER_ATTEMPTS = len(PROFILER_LEAD_KERNELS)
PROFILER_TALLY = {"windows": 0, "windows_run_again": 0, "records_lost": 0}  # over the run
CAPTURES: list = []  # (start, end) on the host's clock (ns) of the optimizer's graph captures (record_captures)


def profiler_lead(attempt: int) -> int:
    """The opening of a profiler window: spin kernels (``torch.cuda._sleep``;
    ``is_lead`` names their records), each waited for.  Returns the host's
    clock (ns) after them, where the window's counted launches begin."""
    for _ in range(PROFILER_LEAD_KERNELS[attempt - 1]):
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    return time.time_ns()


def is_lead(name: str) -> bool:
    return "spin_kernel" in name


def lost_records(prof, since_ns: int, path: str, attempt: int) -> int:
    """The records of the card that a ``torch.profiler`` window lost from
    the start of its launches after ``since_ns`` (the host's clock, ns), up
    to the first launch it kept whole: a kernel launch on the host
    (``*LaunchKernel*``) with no record under its correlation id, but for
    those a graph capture recorded (``CAPTURES``), which run nothing, and a
    graph launch with fewer records than the window's fullest (every window
    here replays one graph).  Says so when it lost any; adds the window to
    ``PROFILER_TALLY``."""
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    records, host = {}, []
    for e in events:
        if e.device_type() == cuda:
            records[e.correlation_id()] = records.get(e.correlation_id(), 0) + 1
        elif e.start_ns() >= since_ns:
            host.append((e.correlation_id(), e.name(), e.start_ns()))
    most = max((records.get(c, 0) for c, name, _ in host if "GraphLaunch" in name), default=0)
    lost = 0
    for c, name, t in sorted(host, key=lambda h: h[2]):  # the window's first launches, up to one kept whole
        want = 1 if "LaunchKernel" in name and not any(t0 <= t <= t1 for t0, t1 in CAPTURES) else \
            max(most, 1) if "GraphLaunch" in name else 0
        if want and records.get(c, 0) >= want:
            break
        lost += want - min(records.get(c, 0), want)
    PROFILER_TALLY["windows"] += 1
    if lost:
        PROFILER_TALLY["windows_run_again"] += attempt < PROFILER_ATTEMPTS
        PROFILER_TALLY["records_lost"] += lost
        say("profile", path=path, attempt=attempt, lost_records=lost, lead_kernels=PROFILER_LEAD_KERNELS[attempt - 1],
            note="the profiler lost records of the window's launches: the window runs again")
    return lost


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


def graph_calls(per_eval: int, extra_evals: int = 0) -> int:
    """A wrapper's calls in a solve on the CUDA graph: iteration 1 and the
    capture call it ``per_eval`` times each, an evaluation after the loop
    (``save_primal``, an example's final evaluation) ``per_eval`` times
    more; the replays call it never."""
    return per_eval * (2 + extra_evals)


class Timed:
    """Records a CUDA event pair around each evaluation the host launches (no
    host sync).  A graph's capture records none: the graph's replays are
    timed as a whole (``replay_ms`` in ``main``)."""

    def calculate_traceable(self, params, dual_val, gamma):
        if torch.cuda.is_current_stream_capturing():
            return super().calculate_traceable(params, dual_val, gamma)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        res = super().calculate_traceable(params, dual_val, gamma)
        e.record()
        self.events.append((s, e))
        return res


def _counted():
    """The store's counters of the kernels' wrappers
    (``dualip.ops.<wrapper>.enqueued``), by the short name of each count.  A
    wrapper counts its calls on a CUDA tensor: one launch each when the host
    runs it, one recorded launch when a CUDA graph captures it (the graph's
    replays then launch the kernel without calling the wrapper;
    ``device_launches`` counts those on the card)."""
    wrappers = {"K1g": "fused_tile_gather_eval_T", "K2g": "fused_tile_gather_eval_T.x",
                "K3": "fused_panel_project_tiles", "K4": "fused_panel_project_tiles.x",
                "K3t": "fused_panel_project", "K4t": "fused_panel_project.x",
                "K5": "benes_fine", "K6": "benes_coarse", "K7": "benes_coarse2", "K5w": "benes_fine_window",
                "K7w": "benes_coarse2_window", "segsum": "segment_sum_rows", "simplex": "simplex_project"}
    return {k: f"dualip.ops.{w[:-2]}.enqueued_x" if w.endswith(".x") else f"dualip.ops.{w}.enqueued"
            for k, w in wrappers.items()}


def port_kernel(name: str):
    """The short name of the count a CUDA kernel's profiler record belongs
    to, or None for a kernel that is not the port's.  K1's forms are told
    apart by the template flag WANT_X (the last) of ``clamp_kernel``,
    ``column_kernel`` and ``wide_kernel``, K3's by ``panel_tiles_kernel``'s
    WANT_X (its third template argument; the fourth is WIDE); the segment-sum's two kernels are ``segsum_window`` and
    ``segsum``.  ``panel_tiles_kernel`` is also K3t/K4t's and
    ``coarse_kernel`` also K7w's: the records count them under K3, K4 and K6
    (``device_launches`` sorts them out)."""
    m = re.search(r"\b(?:clamp|column|wide)_kernel<([^>]*)>", name)
    if m:
        return "K2g" if m.group(1).split(",")[-1].strip() == "true" else "K1g"
    m = re.search(r"\bpanel_tiles_kernel<([^>]*)>", name)
    if m:
        return "K4" if m.group(1).split(",")[2].strip() == "true" else "K3"
    for sym, short in (("fine_gather_kernel", "K5"), ("rows_gather_kernel", "K7"), ("coarse_kernel", "K6"),
                       ("fine_kernel", "K5w"), ("window_sums", "segsum_window"), ("add_rows", "segsum"),
                       ("duchi_sortscan_kernel", "simplex")):
        if re.search(rf"\b{sym}\b", name):
            return short
    return None


# The forms that only the host launches, never a graph: K3t/K4t check tiles one at a time, K5w/K7w build
# the Benes source index; each call is one launch.
HOST_FORMS = ("K3t", "K4t", "K5w", "K7w")


def device_launches(prof, calls: dict) -> dict:
    """The port's kernels that ``prof`` (a ``torch.profiler`` run with CUDA
    activity) saw run on the card, by the short names of ``_counted``, with
    ``segsum_window`` beside ``segsum``.  K3t/K4t and K7w launch K3/K4's and
    K6's CUDA kernel; they run only from the host (``HOST_FORMS``), so
    ``calls`` (the wrappers' counts over the profiled window) are their
    launches and the rest of the shared records are K3's, K4's and K6's."""
    n = dict.fromkeys(tuple(_counted()) + ("segsum_window",), 0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = port_kernel(e.name)
            if k is not None:
                n[k] += 1
    for shared, own in (("K3", "K3t"), ("K4", "K4t"), ("K6", "K7w")):
        n[own] = calls[own]
        n[shared] -= calls[own]
        check(n[shared] >= 0, f"{own} counted {calls[own]} calls, more than its CUDA kernel's records")
    return n


def capture_spy():
    """Counts the optimizer's graph captures in ``call_count``; each runs the
    package's ``_Graph._capture`` as it is (through ``record_captures``)."""
    from dualip_tpu_torch.optimizers import agd

    return mock.patch.object(agd._Graph, "_capture", autospec=True, side_effect=agd._Graph._capture)


def record_captures() -> None:
    """Wraps the optimizer's ``_Graph._capture`` for the rest of the run so
    that each capture's span on the host's clock lands in ``CAPTURES``: the
    kernel launches inside it are recorded into the graph, not run."""
    from dualip_tpu_torch.optimizers import agd

    capture = agd._Graph._capture

    def timed(self):
        t = time.time_ns()
        try:
            return capture(self)
        finally:
            CAPTURES.append((t, time.time_ns()))

    agd._Graph._capture = timed


def reduce_spy():
    """Counts the meshes' ``all_reduce_`` calls in ``call_count`` (a capture
    records the collective: one call, nothing run); each runs as it is."""
    from dualip_tpu_torch.parallel.mesh import EntityMesh

    return mock.patch.object(EntityMesh, "all_reduce_", autospec=True, side_effect=EntityMesh.all_reduce_)


def nccl_records(by_name: dict) -> int:
    """NCCL's kernels among a profiler window's records by name."""
    return sum(c for nm, c in by_name.items() if "nccl" in nm.lower())


SINCE = [0]  # the store's last span id when the counts were last reset
TORCH_ROWS = "dualip.projections.duchi.torch_rows"  # the rows duchi_project leaves to torch's ops on the card


def reset_counts() -> None:
    for name in (*_counted().values(), TORCH_ROWS):
        profiling.STORE.counters.pop(name, None)
    SINCE[0] = profiling.STORE.ids


def counts() -> dict:
    return {k: profiling.counter(name) for k, name in _counted().items()}


def span_s(name: str, since=None) -> float:
    """Seconds of the store's records of ``name`` opened after the span id
    ``since`` (default: the last ``reset_counts``); 0.0 for none."""
    since = SINCE[0] if since is None else since
    return sum(e.seconds for e in profiling.STORE.events if e.name == name and e.id > since)


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


def event_ms(fn) -> float:
    """Device time of one call of ``fn``, between a CUDA event pair."""
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    s.record()
    fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e)


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


def column_slots(L: int, length: torch.Tensor):
    """(slots of the columns with a length, slots of the padding columns) of
    a tile of L lanes a column.  A bound counts a padding column (length 0)
    only as its writes: the function writes zeros there and reads nothing."""
    real = L * int((length > 0).sum())
    return real, L * length.numel() - real


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
    vs plain, and a second launch bit for bit, at m = 64, 10,000 and 70,000 (a 280 KB table, more than L1 holds), the last
    with K = 4102 (4 B copies and a ragged last slab).  Above 512 lanes (a
    block a column) two shapes: m = 10,000 with K = 1024, and m = 70,000 with
    K = 1026, whose padding holds a whole group of 8 columns and a ragged one."""
    from dualip_tpu_torch.ops.fused_matching import (
        fused_tile_eval_T_reference,
        fused_tile_gather_eval_T,
    )

    rng = np.random.default_rng(0)
    err = {False: 0.0, True: 0.0}
    n = 0
    for L in widths:
        shapes = ((64, 4 * 1024, 1024), (10_000, 4 * 1024, 1024), (70_000, 4102, 2051)) if L <= 512 else \
            ((10_000, 1024, 1024), (70_000, 1026, 513))
        for m, K, block_k in shapes:
            a = np.abs(rng.normal(size=(L, K))).astype(np.float32)
            c = -np.abs(rng.normal(size=(L, K))).astype(np.float32)
            length = rng.integers(1, L + 1, size=K).astype(np.int32)
            length[-13:] = 0
            mask = np.arange(L)[:, None] < length[None, :]
            a, c = np.where(mask, a, 0).astype(np.float32), np.where(mask, c, 0).astype(np.float32)
            lam = np.abs(rng.normal(size=m)).astype(np.float32)
            rows = torch.from_numpy(rng.integers(0, m, size=(L, K)).astype(np.int32)).to(dev)
            t = [torch.from_numpy(v).to(dev) for v in (a, c, length)]
            del a, c, mask
            for kind, params in CASES:
                for scale in (-100.0, -2.0):
                    scaled = torch.from_numpy(np.float32(scale) * lam).to(dev)
                    lam_g = scaled[rows.long()]
                    for want_x in (False, True):
                        name = f"{kind}{params} L={L} m={m} K={K} want_x={want_x}"
                        got = fused_tile_gather_eval_T(scaled, rows, *t, scale, kind, params, block_k=block_k,
                                                       want_x=want_x)
                        again = fused_tile_gather_eval_T(scaled, rows, *t, scale, kind, params, block_k=block_k,
                                                         want_x=want_x)
                        ref = fused_tile_eval_T_reference(lam_g, *t, scale, kind, params, want_x=want_x)
                        torch.cuda.synchronize()
                        check(all(torch.equal(u, v) for u, v in zip(got, again)), f"{name}: two launches differ")
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
            del t, rows
    say("kernels", cases=n, widths=list(widths), m_K=[(64, 4096), (10_000, 4096), (70_000, 4102)],
        m_K_above_512_lanes=[(10_000, 1024), (70_000, 1026)],
        max_abs_err_K1=err[False], max_abs_err_K2=err[True],
        tolerance="ax,x: 5e-5*max(1,max|x|); obj,reg: 1e-3+1e-4*|ref|",
        repeat="bit for bit in every case",
        wide="L > 64: a warp a column, lanes in registers, to 512; above, a block a column of 128-1024 threads, "
             "8 lanes a thread in registers to 8192, 16 to 16,384, then shared memory, then device memory")
    return err


ML20M_CELL = "ml20m-csc-fused"  # the benchmark cell whose csc tiles phase ml20m times
ML20M_SEED = 2147483911
TILE_CALLS, TILE_REPLAYS = 20, 20  # a tile's launch: a CUDA graph of TILE_CALLS launches, replayed TILE_REPLAYS times


def graph_replay_ms(fn) -> float:
    """Device ms of one call of ``fn``: a CUDA graph of ``TILE_CALLS`` calls,
    replayed ``TILE_REPLAYS`` times (``tools/wide_column_probe.py``'s timing),
    so that a launch's time holds neither the host's gaps nor a neighbour's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(TILE_CALLS):
            fn()
    g.replay()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(TILE_REPLAYS):
        g.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / (TILE_CALLS * TILE_REPLAYS)


def phase_ml20m(dev, card) -> list:
    """K1 (gather form) on each csc tile of the benchmark's ml20m-csc-fused
    cell: the movielens-20m stand-in generated and built as the cell builds it
    (``gpubench/core.py``), each tile's launch timed alone by graph replays,
    beside its bound, and held to the plain version at a seeded dual.  The
    path follows from the launch's partial count: one a slab of 256 columns
    (a thread a column), one a group of 8 (a warp a column) or one a column
    (a block a column).  Then one evaluation's launches are counted and a
    call of the cell's length from zero is solved twice, bit for bit."""
    import dualip_tpu_torch.ops.fused_matching as fm
    from gpubench.core import Cell, build_program, make_inputs

    t0 = time.perf_counter()
    cell = Cell(ML20M_CELL, ROOT)
    inputs = make_inputs(cell, ML20M_SEED, dev)
    obj, solver, build_s = build_program(cell, inputs, dev, cell.traffic["objective_kwargs"])
    bcsc = obj.bcsc
    g = torch.Generator(device=dev).manual_seed(ML20M_SEED)
    nig = torch.full((), -1.0 / float(cell.config["solver"]["gamma"]), dtype=torch.float32, device=dev)
    scaled = nig * torch.rand(bcsc.m, generator=g, device=dev)
    rows = []
    for t, s in zip(bcsc.tiles, bcsc.specs):
        def k1(fn=fm.fused_tile_gather_eval_T, t=t, s=s):
            kw = {"block_k": s.K} if fn is fm.fused_tile_gather_eval_T else {}
            return fn(scaled, t.rows, t.a, t.c, t.length, nig, s.proj_type, s.proj_params, **kw)

        got, ref = k1(), k1(fm.fused_tile_gather_eval_T_reference)
        e = float((got[0] - ref[0]).abs().max())
        check(e <= tol_x(ref[0]), f"ml20m K1 on the L={s.L} tile: err {e}")
        for i in (1, 2):
            check(abs(float(got[i]) - float(ref[i])) <= 1e-3 + 1e-4 * abs(float(ref[i])),
                  f"ml20m K1 sums on the L={s.L} tile")
        check(all(torch.equal(u, v) for u, v in zip(got, k1())), f"ml20m K1 on the L={s.L} tile: two launches differ")
        ms = graph_replay_ms(k1)
        nb = fm.num_partial_blocks(s.proj_type, s.L, s.K)
        path = {-(-s.K // 256): "thread", -(-s.K // 8): "warp", s.K: "block"}.get(nb, "?")
        real, pad = column_slots(s.L, t.length)
        nnz = int(t.length.sum())
        nbytes = real * 16 + pad * 4 + s.K * 4
        bound = max(nbytes / PEAK_BYTES_PER_S, real * ops_per_slot(s.proj_type) / PEAK_FP32_FLOP_PER_S) * 1e3
        rows.append((s.L, s.K, int((t.length > 0).sum()), nnz, path, nb, round(ms, 4), round(bound, 4),
                     round(bound / ms, 4), e))
    # one evaluation of the cell's objective: a launch a tile, the block path's counted
    counted = {k: f"dualip.ops.fused_tile_gather_eval_T.{k}" for k in ("enqueued", "block_columns")}
    before = {k: profiling.counter(c) for k, c in counted.items()}
    obj.calculate(torch.zeros(bcsc.m, device=dev))
    torch.cuda.synchronize()
    calls = {k: profiling.counter(c) - before[k] for k, c in counted.items()}
    want = {"enqueued": len(bcsc.tiles), "block_columns": sum(r[4] == "block" for r in rows)}
    check(calls == want, f"ml20m: one evaluation counted {calls}, expected {want}")
    # a call of the cell's length from zero, twice on one objective and maximizer: the same bits
    solves = [solver.maximize(obj, torch.zeros(bcsc.m, device=dev)) for _ in range(2)]
    check(torch.equal(solves[0].dual_val, solves[1].dual_val)
          and solves[0].dual_objective_log == solves[1].dual_objective_log, "ml20m: two solves differ")
    total = sum(r[6] for r in rows)
    say("ml20m", cell=ML20M_CELL, seed=ML20M_SEED, m=bcsc.m, n=bcsc.n, nnz=bcsc.nnz, build_s=f"{build_s:.2f}",
        wrapper_calls_an_evaluation=calls,
        repeat=f"two solves of {len(solves[0].dual_objective_log)} iterations bit for bit",
        L_K_columns_nnz_path_partials_ms_bound_share_err=rows, sum_ms=f"{total:.4f}",
        above_512_ms=f"{sum(r[6] for r in rows if r[0] > 512):.4f}", timing="graph of 20 launches, 20 replays",
        tolerance="ax: 5e-5*max(1,max|x|); obj,reg: 1e-3+1e-4*|ref|; a second launch bit for bit",
        package=str(Path(fm.__file__).parents[1]), card=card, seconds=f"{time.perf_counter() - t0:.1f}")
    del obj, solver, solves, bcsc, inputs, scaled
    torch.cuda.empty_cache()
    return rows


ML20M_PANEL_CELL = "ml20m-butterfly"  # the benchmark cell whose panel tiles phase ml20m_panel times


def phase_ml20m_panel(dev, card) -> list:
    """K3 on each tile of the benchmark's ml20m-butterfly cell: the
    movielens-20m stand-in generated and built as the cell builds it
    (``gpubench/core.py``), each tile's launch (``fused_panel_project``, the
    all-tiles call's code) timed alone by graph replays beside its bound and
    held to the plain version on a seeded carry buffer; then the all-tiles
    call, and the tiles above L = 512 (the block form's) and the rest each as
    a table of their own, timed the same way; the all-tiles call against the
    plain version, against one call a tile (a*x bit for bit) and against
    itself (obj and reg too); and one evaluation of the cell's objective,
    its calls to the block form counted."""
    import dualip_tpu_torch.ops.fused_matching as fm
    from dualip_tpu_torch.objectives.matching import _plan_size
    from dualip_tpu_torch.sparse.rowmajor import PanelTile
    from gpubench.core import Cell, build_program, make_inputs

    t0 = time.perf_counter()
    cell = Cell(ML20M_PANEL_CELL, ROOT)
    inputs = make_inputs(cell, ML20M_SEED, dev)
    obj, solver, build_s = build_program(cell, inputs, dev, cell.traffic["objective_kwargs"])
    table = obj.panel_table
    g = torch.Generator(device=dev).manual_seed(ML20M_SEED)
    nig = torch.full((), -1.0 / float(cell.config["solver"]["gamma"]), dtype=torch.float32, device=dev)
    srow0 = nig * torch.rand(_plan_size(obj.row_layout.plan), generator=g, device=dev)
    warp_cap = getattr(fm, "PANEL_WARP_L_CAP", None)  # None: a tree without the block form

    def path(L):
        if L <= fm.PANEL_RING_L_CAP:
            return "ring"
        return "block" if warp_cap is not None and L > warp_cap else "warp"

    def bound(tiles_):
        real = pad = ghost = cols = nops = 0
        for t in tiles_:
            r, p_ = column_slots(t.L, t.length)
            real, pad, cols = real + r, pad + p_, cols + t.length.numel()
            ghost += t.KP * t.L2 * 128 - t.a.numel()
            nops += r * ops_per_slot(t.kind)
        nbytes = real * (2 * t.a.element_size() + 2 * srow0.element_size()) + (pad + ghost) * srow0.element_size()
        return max((nbytes + 4 * cols) / PEAK_BYTES_PER_S, nops / PEAK_FP32_FLOP_PER_S) * 1e3

    def sub_table(keep):
        idx = [i for i, t in enumerate(table.tiles) if keep(t)]
        ts = [table.tiles[i] for i in idx]
        return fm.build_panel_table([PanelTile(t.a, t.c, t.length) for t in ts], [t.off for t in ts],
                                    [t.pack for t in ts], [(t.kind, t.params) for t in ts]), ts

    rows = []
    for t in table.tiles:
        def k3(b, fn=fm.fused_panel_project, t=t):
            return fn(b, t.a, t.c, t.length, t.off, t.kind, t.params, False, nig, t.pack)

        got, ref = k3(srow0.clone()), k3(srow0.clone(), fm.fused_panel_project_reference)
        region = slice(t.off, t.off + t.KP * t.L2 * 128)
        e = float((got[0][region] - ref[0][region]).abs().max())
        check(e <= tol_x(ref[0][region]), f"ml20m_panel K3 on the L={t.L} tile: err {e}")
        for i in (1, 2):
            check(abs(float(got[i]) - float(ref[i])) <= 1e-3 + 1e-4 * abs(float(ref[i])),
                  f"ml20m_panel K3 sums on the L={t.L} tile")
        check(all(torch.equal(u, v) for u, v in zip(got, k3(srow0.clone()))),
              f"ml20m_panel K3 on the L={t.L} tile: two launches differ")
        buf = srow0.clone()
        ms = graph_replay_ms(lambda: k3(buf))
        b_ms = bound([t])
        rows.append((t.L, t.q, t.KP, int((t.length > 0).sum()), int(t.length.sum()), path(t.L), round(ms, 4),
                     round(b_ms, 4), round(b_ms / ms, 4), e))
        del got, ref, buf
    # the all-tiles call: the plain version, one call a tile, itself
    got = fm.fused_panel_project_tiles(srow0.clone(), table, nig)
    again = fm.fused_panel_project_tiles(srow0.clone(), table, nig)
    ref = fm.fused_panel_project_tiles_reference(srow0.clone(), table, nig)
    per = srow0.clone()
    for t in table.tiles:
        fm.fused_panel_project(per, t.a, t.c, t.length, t.off, t.kind, t.params, False, nig, t.pack)
    check(torch.equal(got[0], per), "ml20m_panel: the all-tiles call differs from one call a tile")
    check(all(torch.equal(u, v) for u, v in zip(got, again)), "ml20m_panel: two all-tiles calls differ")
    e_all = float((got[0] - ref[0]).abs().max())
    check(e_all <= tol_x(ref[0]), f"ml20m_panel: all tiles err {e_all}")
    for i in (1, 2):
        check(abs(float(got[i]) - float(ref[i])) <= 1e-3 + 1e-4 * abs(float(ref[i])), "ml20m_panel: all-tiles sums")
    del got, again, ref, per
    timed = {}
    for name, keep in (("all", lambda t: True), ("above_512", lambda t: t.L > 512), ("to_512", lambda t: t.L <= 512)):
        sub, ts = sub_table(keep) if name != "all" else (table, table.tiles)
        buf = srow0.clone()
        timed[name] = (round(graph_replay_ms(lambda: fm.fused_panel_project_tiles(buf, sub, nig)), 4),
                       round(bound(ts), 4))
        del buf
    # one evaluation of the cell's objective: one all-tiles call, its tiles above 512 to the block form
    counted = {k: f"dualip.ops.fused_panel_project_tiles.{k}" for k in ("enqueued", "block_tiles")}
    before = {k: profiling.counter(c) for k, c in counted.items()}
    obj.calculate(torch.zeros(obj.bcsc.m, device=dev))
    torch.cuda.synchronize()
    calls = {k: profiling.counter(c) - before[k] for k, c in counted.items()}
    if warp_cap is not None:
        want = {"enqueued": 1, "block_tiles": sum(t.L > warp_cap for t in table.tiles)}
        check(calls == want, f"ml20m_panel: one evaluation counted {calls}, expected {want}")
    say("ml20m_panel", cell=ML20M_PANEL_CELL, seed=ML20M_SEED, m=obj.bcsc.m, n=obj.bcsc.n, nnz=obj.bcsc.nnz,
        build_s=f"{build_s:.2f}", wrapper_calls_an_evaluation=calls,
        L_q_KP_columns_nnz_path_ms_bound_share_err=rows, sum_ms=f"{sum(r[6] for r in rows):.4f}",
        above_512_alone_ms=f"{sum(r[6] for r in rows if r[0] > 512):.4f}",
        tables_ms_bound={k: v for k, v in timed.items()}, all_tiles_err=e_all,
        timing="graph of 20 calls, 20 replays", vs_one_call_a_tile="bit for bit on a*x",
        repeat="bit for bit on a*x, obj and reg",
        tolerance="ax: 5e-5*max(1,max|x|); obj,reg: 1e-3+1e-4*|ref|; a second launch bit for bit",
        package=str(Path(fm.__file__).parents[1]), card=card, seconds=f"{time.perf_counter() - t0:.1f}")
    del obj, solver, inputs, srow0, table
    torch.cuda.empty_cache()
    return rows


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


# the benchmark's canonical configuration, whose column lengths give the tiles phase simplex times
CANONICAL_CONFIG = ROOT / "gpubench" / "configs" / "matching-canonical-25m.json"
CANONICAL_TILE_SEED = 2_147_491_104  # the source side's seed (the destination side is the configuration's)


def canonical_simplex_tiles(dev) -> list:
    """The (L, lengths) of each column tile that the default csc path projects
    at the canonical shape: the benchmark generator's matrix (the
    configuration's data, ``CANONICAL_TILE_SEED``) on the card, its column
    lengths bucketed as ``build_blockcsc`` buckets them (``_pow2_thresholds``
    of the row count, empty columns dropped, L the bucket's longest column).
    ``lengths`` is each tile's column lengths on the card, in column order."""
    from gpubench.generators import upstream_synthetic
    from dualip_tpu_torch.sparse.bcsc import _pow2_thresholds

    data = json.loads(CANONICAL_CONFIG.read_text())["data"]
    indptr = upstream_synthetic.generate(data, CANONICAL_TILE_SEED, dev)["indptr"]
    torch.cuda.empty_cache()
    lengths = torch.diff(indptr)
    del indptr
    th = torch.as_tensor(_pow2_thresholds(int(data["num_destinations"])), device=dev)
    bucket = torch.searchsorted(th, lengths, side="left")
    tiles = []
    for j in range(1, th.numel()):
        sel = lengths[(bucket == j) & (lengths > 0)]
        if sel.numel():
            tiles.append((int(sel.max()), sel))
    return tiles


def phase_simplex(dev) -> dict:
    """The sort-and-scan simplex kernel (``ops/simplex_project.py``): bit for
    bit against its plain version at every L from 1 to 64, both kinds, three
    radii, on aligned, strided (copied first) and unaligned rows, and within
    fp32 of the torch ops; then each tile the default csc path projects at
    the canonical shape (``canonical_simplex_tiles``: its K, its L, its
    padding lanes zero), timed beside its plain version, the torch ops and
    its bound (8 B a slot), and held bit for bit to the plain version."""
    from dualip_tpu_torch.ops.simplex_project import simplex_project, simplex_project_reference
    from dualip_tpu_torch.projections.simplex import _duchi_torch

    rng = np.random.default_rng(16)
    n, worst = 0, 0.0
    for L in range(1, 65):
        x = torch.from_numpy((rng.normal(size=(4099, L)) * rng.uniform(0.05, 4.0, size=(4099, 1)))
                             .astype(np.float32)).to(dev)
        x[0] = 0.0
        x[1, 0] = 50.0  # the vertex
        x[2] = torch.round(x[2] * 2) / 2  # ties
        views = (x, x.T.contiguous().T, x.reshape(-1)[1:1 + (x.numel() - L) // L * L].view(-1, L))
        for v in views:
            for z in (1.0, 0.37, 3.0):
                for inequality in (False, True):
                    got = simplex_project(v, z, inequality)
                    check(torch.equal(got, simplex_project_reference(v, z, inequality)),
                          f"simplex L={L} z={z} inequality={inequality}: the kernel differs from its plain version")
                    e = float((got - _duchi_torch(v, z, inequality, 1e-6)).abs().max())
                    scale = 1.0 + float(torch.clamp_min(v, 0).sum(-1).max())
                    check(e <= 2e-6 * scale, f"simplex L={L}: {e} from the torch ops")
                    worst = max(worst, e / scale)
                    n += 1
    say("simplex", cases=n, widths="1..64", vs_plain_version="bit for bit in every case",
        max_err_vs_torch_ops_over_row_sum=f"{worst:.3e}", tolerance="2e-6*(1+max row sum)")
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    tiles = canonical_simplex_tiles(dev)
    say("simplex", canonical_tiles=[(L, lengths.numel()) for L, lengths in tiles], seed=CANONICAL_TILE_SEED,
        note="(L, K) of each tile, from the benchmark generator's column lengths bucketed as build_blockcsc does")
    for L, lengths in tiles:
        K = lengths.numel()
        x = torch.randn(K, L, device=dev) * 3.0
        x.masked_fill_(torch.arange(L, device=dev) >= lengths[:, None], 0.0)  # the padding lanes' zeros
        del lengths
        check(torch.equal(simplex_project(x, 1.0, True), simplex_project_reference(x, 1.0, True)),
              f"simplex canonical tile L={L} K={K}: the kernel differs from its plain version")
        t_k = cuda_ms(lambda: simplex_project(x, 1.0, True), reps=20, graph=True)
        t_p = cuda_ms(lambda: simplex_project_reference(x, 1.0, True), reps=3, warmup=1)
        t_l = cuda_ms(lambda: _duchi_torch(x, 1.0, True, 1e-6), reps=3, warmup=1)
        bound = K * L * 8 / PEAK_BYTES_PER_S * 1e3
        for key, v in (("ms", t_k.ms), ("plain_ms", t_p.ms), ("library_ms", t_l.ms), ("bound_ms", bound)):
            total[key] += v
        say("timing", kernel="'duchi_sortscan_kernel'", K=K, L=L, ms=f"{t_k.ms:.4f}", bound_ms=f"{bound:.4f}",
            share_of_bound=f"{bound / t_k.ms:.3f}", plain_ms=f"{t_p.ms:.3f}", torch_ops_ms=f"{t_l.ms:.3f}",
            **timing_kv(t_k))
        del x
    del tiles
    torch.cuda.empty_cache()
    say("timing", kernel="'duchi_sortscan_kernel, canonical tiles'", ms=f"{total['ms']:.4f}",
        bound_ms=f"{total['bound_ms']:.4f}", share_of_bound=f"{total['bound_ms'] / total['ms']:.3f}",
        plain_ms=f"{total['plain_ms']:.3f}", torch_ops_ms=f"{total['library_ms']:.3f}")
    return {"name": "simplex_project", "route": "cuda", "source": "dualip_tpu_torch/csrc/simplex_project.cu",
            "replaces": "none: XLA's sort and cumsum (dualip_tpu/projections/simplex.py::duchi_project)",
            "bound_by": "bytes", "max_err_vs_torch_ops": worst, **total}


def simplex_counts(bcsc) -> tuple:
    """(simplex tiles the kernel projects, rows left to torch's ops) in one
    evaluation of the registry csc path on ``bcsc``: a Duchi simplex tile of
    at most ``KERNEL_MAX_L`` lanes is one launch, a wider one its K rows in
    ``TORCH_ROWS``."""
    from dualip_tpu_torch.ops.simplex_project import KERNEL_MAX_L

    duchi = [s for s in bcsc.specs if s.proj_type in ("simplex", "simplex_eq")
             and dict(s.proj_params).get("method", "duchi") == "duchi"]
    return sum(s.L <= KERNEL_MAX_L for s in duchi), sum(s.K for s in duchi if s.L > KERNEL_MAX_L)


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
            kernels = [f"dualip.ops.{k}.enqueued" for k in ("benes_fine", "benes_coarse", "benes_coarse2")]
            before = [profiling.counter(k) for k in kernels]
            y = bf.apply_butterfly_cuda(packed, x.clone(), truncate=False)
            used = tuple(profiling.counter(k) - b for k, b in zip(kernels, before))
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
            launches_fine_coarse_coarse2=used, router=profiling.last("dualip.build.route").attrs["router"],
            route_s=f"{route_s:.2f}", index_build_s=f"{profiling.last('dualip.build.index').seconds:.3f}",
            index_bytes=bf.index_bytes(packed),
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
    gen = torch.Generator(device=dev).manual_seed(3)  # the carry buffers, made on the card
    err = {(w, c, t): 0.0 for w in (False, True) for c in DTYPES for t in DTYPES}
    plain_bits = {k: True for k in err}
    n = 0
    # (L, compact): plain panels with L a power of two and not; compact packings with q > 1
    shapes = [(1, False), (2, False), (5, False), (16, False), (29, False), (48, False), (64, False),
              (96, False), (100, False), (200, False), (394, False), (600, False), (2100, False), (3, True), (5, True),
              (29, True), (34, True)]
    for kind, params in CASES:
        for L, compact in shapes:
            KP = TABLE_KP.get(L, 16)
            tile16, pack, L2, q = panel_tile(rng, L, compact, KP, dev, tiles=torch.bfloat16)
            region = KP * L2 * 128
            off = 3 * region  # the region lies inside a larger buffer
            N = 8 * region
            for carry, tiles in ((c, t) for c in DTYPES for t in DTYPES):
                # fp32 tiles hold the bf16 tile's values, so both tile types must give the same bits
                tile = tile16 if tiles == torch.bfloat16 else widened(tile16)
                buf0 = (torch.randn(N, generator=gen, device=dev) * 50).to(carry)
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
                (96, False), (100, False), (200, False), (394, False), (600, False), (2100, False), (3, True),
                (29, True), (34, True)]
# buffer rows of a tile (16 otherwise): at L = 394 1,024 wide units, more than the grid's blocks
TABLE_KP = {394: 64, 2100: 4}


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
    gen = torch.Generator(device=dev).manual_seed(4)  # the carry buffers, made on the card
    tiles, packs, geo = [], [], []
    for L, compact in TABLE_SHAPES:
        tile, pack, L2, q = panel_tile(rng, L, compact, TABLE_KP.get(L, 16), dev, tiles=torch.bfloat16)
        tiles.append(tile)
        packs.append(pack)
        geo.append((L, L2, q))
    # regions as build_row_layout places them (descending L2), after an
    # untouched stretch, with another one after the last region
    base = cum = 2 * 128 * max(L2 for _, L2, _ in geo)
    offsets = [0] * len(tiles)
    for i in sorted(range(len(tiles)), key=lambda i: -geo[i][1]):
        offsets[i] = cum
        cum += tiles[i].a.shape[0] * geo[i][1] * 128
    N = cum + 128 * 512
    n = 0
    for shift in range(len(CASES)):
        kinds = [CASES[(i + shift) % len(CASES)] for i in range(len(tiles))]
        tables = {torch.bfloat16: build_panel_table(tiles, offsets, packs, kinds),
                  torch.float32: build_panel_table([widened(t) for t in tiles], offsets, packs, kinds)}
        for carry, tile_dt in ((c, t) for c in DTYPES for t in DTYPES):
            table = tables[tile_dt]
            buf0 = (torch.randn(N, generator=gen, device=dev) * 50).to(carry)
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
                check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
                      and (not want_x or all(torch.equal(g, a) for g, a in zip(got[3], again[3]))),
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
    say("panel", form="all tiles a launch", cases=n, tiles_L_compact=TABLE_SHAPES, buffer_rows=TABLE_KP,
        work_units=tables[torch.float32].n_items, wide_instance=tables[torch.float32].wide,
        max_abs_err={f"{'K4' if k[0] else 'K3'} carry {str(k[1])[6:]} tiles {str(k[2])[6:]}": v for k, v in err.items()},
        vs_one_launch_per_tile="bit for bit on a*x and x", repeat="bit for bit on a*x, x, obj and reg",
        bf16_tiles_vs_fp32_tiles="bit for bit", outside_regions="unchanged", ghost_lanes="zero")
    return err


def time_panel(what, obj, dev, kernels, panel_err, launches=None, calls=None):
    """K3/K4 on a butterfly objective's tiles (its panel table): all tiles
    in one launch against the plain version, against one launch per tile
    bit for bit and against itself (obj, reg too) bit for bit; timed beside
    the per-tile form, the plain version and, for K3, each tile alone and a
    bf16 carry.  With ``launches`` and ``calls`` (the solve's launches on the
    card and its wrapper calls), K3 and K4 join ``kernels``, named for bf16
    tiles where the table's a and c are bf16."""
    from dualip_tpu_torch.ops.fused_matching import (
        fused_panel_project,
        fused_panel_project_reference,
        fused_panel_project_tiles,
        fused_panel_project_tiles_reference,
        PANEL_RING_L_CAP,
    )
    from dualip_tpu_torch.objectives.matching import _plan_size

    nig = torch.full((), -1.0 / 1e-3, dtype=torch.float32, device=dev)
    table = obj.panel_table
    ts = table.tiles
    tile_bytes = ts[0].a.element_size()
    suffix = " (bf16 tiles)" if table.tile_dtype == torch.bfloat16 else ""
    n_carry = _plan_size(obj.row_layout.plan)  # the carry buffer's length
    srow0 = torch.from_numpy(np.random.default_rng(7).normal(size=n_carry).astype(np.float32) * 0.01).to(dev)

    slots = {id(t): column_slots(t.L, t.length) for t in ts}  # (real, padding)

    def bound(tiles_, want_x, carry_bytes=4):
        # a real column's slot: a, c and srow read, a*x (and x) written; a padding column's: a*x (and x) written
        x_bytes = 4 if want_x else 0
        real = sum(slots[id(t)][0] for t in tiles_)
        pad = sum(slots[id(t)][1] for t in tiles_)
        ghost = sum(t.KP * t.L2 * 128 - t.a.numel() for t in tiles_)
        cols = sum(t.length.numel() for t in tiles_)
        nbytes = (real * (2 * tile_bytes + 2 * carry_bytes + x_bytes) + pad * (carry_bytes + x_bytes)
                  + ghost * carry_bytes + cols * 4)
        nops = sum(slots[id(t)][0] * ops_per_slot(t.kind) for t in tiles_)
        t_b, t_o = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_FLOP_PER_S * 1e3
        return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), nbytes, nops, real, pad, ghost

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
        b_ms, b_by, nbytes, nops, real, pad, ghost = bound(ts, want_x)
        ops_ms = nops / NON_FMA_OPS_PER_S * 1e3
        extra = {}
        if not want_x:
            srow_bf = srow0.to(torch.bfloat16)
            extra["bf16_carry_ms"] = cuda_ms(lambda: fused_panel_project_tiles(srow_bf, table, nig),
                                             reps=10, graph=True).ms
            extra["bf16_carry_bound_ms"] = bound(ts, False, 2)[0]
            del srow_bf
            tile_rows = []
            cap = PANEL_RING_L_CAP
            for t in ts:  # each tile alone: one launch of the same kernel, and its plain version
                ms_t = cuda_ms(lambda: per_tile(srow, False, [t]), reps=10, graph=True).ms
                plain_t = cuda_ms(lambda: fused_panel_project_reference(
                    srow, t.a, t.c, t.length, t.off, t.kind, t.params, False, nig, t.pack), reps=2, warmup=1).ms
                b_t = bound([t], False)[0]
                how = ("block a column" if t.L > 512 else "warp a column" if t.L > cap else "ring, stream" if t.L > 32
                       else f"ring, LCAP {1 << max(t.L - 1, 0).bit_length()}")
                tile_rows.append((t.L, t.q, how, t.a.numel(), int((t.length > 0).sum()), round(ms_t, 4),
                                  round(b_t, 4), round(b_t / ms_t, 4), round(plain_t, 3)))
            say("timing", path=what, kernel="'K3, each tile alone'", ring_cap=cap,
                per_tile_L_q_path_slots_columns_ms_bound_share_plain_ms=tile_rows,
                sum_ms=f"{sum(r[5] for r in tile_rows):.4f}")
        del per
        say("timing", path=what, kernel=repr(name), per_iteration_ms=f"{t_k.ms:.4f}",
            per_tile_form_ms=f"{t_per.ms:.4f}", plain_ms=f"{plain_ms:.3f}", bound_ms=f"{b_ms:.4f}",
            bound_by=b_by, share_of_bound=f"{b_ms / t_k.ms:.3f}", ops_ms_at_non_fma_rate=f"{ops_ms:.4f}",
            bytes=nbytes, ops=nops, real_slots=real, padding_slots=pad, ghost_slots=ghost, tiles=len(ts),
            work_units=table.n_items, wide_instance=table.wide,
            **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in extra.items()},
            per_tile_form_host_enqueue_ms=f"{t_per.host_ms:.4f}", **timing_kv(t_k))
        if launches is not None:
            kernels.append({
                "name": name, "route": "cuda", "source": "dualip_tpu_torch/csrc/panel_matching.cu",
                "replaces": "dualip_tpu/ops/pallas_matching.py:" + ("287" if want_x else "305"),
                "launches": launches["K4" if want_x else "K3"], "wrapper_calls": calls["K4" if want_x else "K3"],
                "max_abs_err": max(e, panel_err.get((want_x, torch.float32, table.tile_dtype), 0.0)),
                "ms": t_k.ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None,  # no single PyTorch call computes the projection
                "per_tile_form_ms": t_per.ms,
            })
        del srow


V150D30 = ROOT / "examples" / "miplib_2017" / "v150d30-2hopcds.mps.gz"
V150D30_JAX_DUAL = 27.62  # the JAX package's dual at 10,000 iterations (PARITY.md, section 2.5)
LP_SOLVER = dict(gamma=1e-3, initial_step_size=1e-5)  # the reference's MIPLIB solve
LP_COO_ITERS = 200  # lp-2.5M's COO solve (phases lp and dist)


def phase_lp(dt, inp, card, captured, counts, reset_counts, profile_window, replay_ms, Timed, graph_check, refs):
    """The general LP through ``run_solver(objective_type="miplib2017")``:
    the bundled MIPLIB instance (10,000 iterations on the COO layout, a
    bit-identical repeat, the butterfly layout on the whole instance held to
    COO per ``calculate``, the PDLP bound) and the slice's matrix read as a
    general LP (COO and butterfly, timed and profiled; the COO log kept in
    ``refs`` for phase dist).  The solves run on the CUDA graph, so their
    wrapper counts are ``graph_calls``."""
    import dualip_tpu_torch.objectives.miplib as miplib_mod
    from dualip_tpu_torch.io.mps import read_mps_file
    from dualip_tpu_torch.objectives.matching import _plan_size
    from dualip_tpu_torch.objectives.miplib import MIPLIB2017ObjectiveFunction
    from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent

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
        objective_build_s=f"{captured['build_s']:.3f}",
        ms_per_iteration=f"{replay_ms(obj, torch.zeros(lp.shape[0], device=obj.device), kw=LP_SOLVER):.4f}",
        wrapper_calls=n_launch, card=card)
    check(abs(final - 27.0) < 1.0, f"lp v150d30: dual {final}, the reference asserts 27 +- 1")
    check(n_launch["segsum"] == graph_calls(2) and n_launch["K5"] == 0, f"lp v150d30: wrapper calls {n_launch}")
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
    lp_args = lp_2p5m(inp)
    results = {}
    for layout, iters in (("coo", LP_COO_ITERS), ("butterfly", 50)):
        res, n_launch, solve_s = lp_solve(lp_args, iters, layout=layout)
        peak = torch.cuda.max_memory_allocated()
        obj = captured["obj"]
        ev = obj.events
        first_ms = ev[0][0].elapsed_time(ev[0][1])
        say("lp", instance="lp-2.5M", rows=m, variables=n, nnz=inp.A.nnz, layout=layout, iterations=iters,
            ms_per_iteration=f"{replay_ms(obj, torch.zeros(m, device=obj.device), kw=LP_SOLVER):.4f}",
            objective_build_s=f"{captured['build_s']:.2f}",
            time_to_first_iteration_s=f"{captured['build_s'] + first_ms / 1e3:.3f}", first_iteration_ms=f"{first_ms:.3f}",
            run_solver_s=f"{solve_s:.2f}", final_dual_objective=res.dual_objective,
            peak_device_bytes=peak, wrapper_calls=n_launch, card=card)
        check(res.dual_objective_log[-1] > res.dual_objective_log[0], f"lp-2.5M {layout}: the dual objective did not rise")
        if layout == "coo":
            refs["lp-2.5M coo"] = list(res.dual_objective_log)
            check(n_launch["segsum"] == graph_calls(2), f"lp-2.5M coo: wrapper calls {n_launch}")
            again = repeat(obj, iters)
            check(np.array_equal(again, np.asarray(res.dual_objective_log)), "lp-2.5M: two COO solves differ")
            say("lp", instance="lp-2.5M", layout=layout, repeat_of_the_solve="bit-identical")
        else:
            check(n_launch["K5"] == graph_calls(2) and n_launch["segsum"] == 0,
                  f"lp-2.5M butterfly: wrapper calls {n_launch}")
            say("lp", instance="lp-2.5M", layout=layout, carry_slots=_plan_size(obj.ops.rl.plan),
                layout_build_s=f"{span_s('dualip.build.rows'):.2f}", routing_s=f"{span_s('dualip.build.route'):.2f}")
        profile_window(f"lp-2.5M {layout}", obj, res.dual_val, kw=LP_SOLVER)
        graph_check(f"lp-2.5M {layout}", obj, torch.zeros(m, device=obj.device), kw=LP_SOLVER)
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


# The MovieLens-shaped proxy (dualip_tpu_torch/examples/movielens_matching/proxy_validation.py):
# its LP's shape and nnz, as the JAX package's run logged them
# (examples/movielens_matching/logs/proxy_movies_log.txt, last line)
PROXY_SHAPE = (26_744, 138_493)
PROXY_NNZ = 1_923_742
FAIR_REPEAT_ITERS = 200


def plain_csc_class():
    """The matching objective on the same csc tiles with K1's plain version in
    place of the kernel (the segment-sum kernel on both sides), on the card."""
    import dualip_tpu_torch.objectives.matching as matching_mod
    import dualip_tpu_torch.ops.fused_matching as fm

    class PlainTiles(matching_mod.MatchingSolverDualObjectiveFunction):
        def _local(self, bcsc, dual_val, gamma, want_primal=False, row_layout=None):
            plain_eval = lambda *a, block_k, want_x, out: fm.fused_tile_gather_eval_T_reference(  # noqa: E731
                *a, want_x=want_x, out=out)
            with rebound(fm, fused_tile_gather_eval_T=plain_eval):
                return super()._local(bcsc, dual_val, gamma, want_primal, row_layout)

    return PlainTiles


def plain_butterfly_class():
    """The matching objective on the same butterfly layout with every
    kernel's plain version (the carries' stages, the panel kernel), on the card."""
    import dualip_tpu_torch.objectives.matching as matching_mod
    import dualip_tpu_torch.ops.butterfly as bf
    import dualip_tpu_torch.ops.fused_matching as fm

    class PlainButterfly(matching_mod.MatchingSolverDualObjectiveFunction):
        def _local(self, bcsc, dual_val, gamma, want_primal=False, row_layout=None):
            def plain_carry(rl, vec, reverse, truncate=True):
                p = rl.plan
                v = plain_blocked(bf, p, vec, reverse)
                return v if not truncate else v[: (p.n_in if reverse else p.n_out)]

            with rebound(matching_mod, _carry=plain_carry), \
                    rebound(fm, fused_panel_project_tiles=fm.fused_panel_project_tiles_reference):
                return super()._local(bcsc, dual_val, gamma, want_primal, row_layout)

    return PlainButterfly


def phase_examples(dev, card, counts, reset_counts, variant, Timed, n_chk, graph_check, replay_ms):
    """``examples_in`` in a temporary directory, removed whatever the outcome."""
    with tempfile.TemporaryDirectory(prefix="proxy_") as tmp:
        examples_in(Path(tmp), dev, card, counts, reset_counts, variant, Timed, n_chk, graph_check, replay_ms)


def examples_in(tmp, dev, card, counts, reset_counts, variant, Timed, n_chk, graph_check, replay_ms):
    """The port's examples as a user runs them, at the proxy's full shape:
    the proxy generated and its LP built (shape and nnz the JAX run's), then
    ``proxy_validation.run_ours`` for 10,000 iterations on csc
    (``use_pallas=True``), on butterfly and with the fairness rows, each log
    held by ``summarize`` to the reference's committed log; the launches, the
    kernels against their plain versions over the first iterations (K1 on the
    wide tiles also tile by tile, K3 through ``time_panel``), the fairness
    solve's first 200 iterations repeated bit for bit; then the MIPLIB
    script through its command line.  The solves run on the CUDA graph, so
    their wrapper counts are ``graph_calls`` (the final evaluation of
    ``run_ours`` is the one after the loop)."""
    import dualip_tpu_torch.examples.movielens_matching.movies_lens_matching as mlm
    import dualip_tpu_torch.ops.fused_matching as fm
    from dualip_tpu_torch.examples.movielens_matching import proxy_validation as pv
    from dualip_tpu_torch.objectives.matching import _plan_size
    from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent
    from dualip_tpu_torch.ops.segment_sum import segment_sum_rows_reference

    t_phase = time.perf_counter()
    pv_kw = dict(gamma=pv.GAMMA, initial_step_size=pv.INITIAL_STEP, max_step_size=pv.MAX_STEP)

    def zeros(objective):
        return torch.zeros(objective.b_ext.numel() if hasattr(objective, "b_ext") else objective.b_vec.numel(),
                           device=dev)

    def first_iterations(objective, iters, eager=True):
        """The first iterations; in the eager loop by default (the plain
        versions are references, not built for a graph)."""
        agd = AcceleratedGradientDescent(max_iter=iters, **pv_kw)
        run = agd._maximize_eager if eager else agd.maximize
        return np.asarray(run(objective, zeros(objective)).dual_objective_log)

    t0 = time.perf_counter()
    ratings = pv.generate_proxy_ratings(tmp / "proxy_ratings.npz")
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lps = {False: pv.build_lp(False, ratings), True: pv.build_lp(True, ratings)}
    lp_s = time.perf_counter() - t0
    shape, nnz = lps[False].A.shape, lps[False].A.nnz
    say("examples", proxy_shape=shape, nnz=nnz, generate_s=f"{gen_s:.2f}", build_lps_s=f"{lp_s:.2f}",
        fairness_rows=(len(lps[True].group_a_rows), len(lps[True].group_b_rows)))
    check(shape == PROXY_SHAPE and nnz == PROXY_NNZ, f"examples: proxy LP {shape} nnz {nnz}, the JAX run's "
                                                     f"{PROXY_SHAPE} nnz {PROXY_NNZ}")
    sensitivity = pv.reference_self_sensitivity()
    refs = {f: pv.parse_log(pv.LOGS / f"{pv._tag(f)}_reference_log.txt") for f in (False, True)}
    # the JAX package's first dual on the proxy (its committed logs): the
    # first iteration, before any step, is where two faithful solves agree
    jax_first = {f: pv.parse_log(pv.LOGS / f"{pv._tag(f)}_log.txt")["trace"][0] for f in (False, True)}

    built_since = [0]  # the store's last span id before the objective's build

    def run(what, fairness, layout):
        """run_ours on a timed copy of the objective: its log held to the
        reference's, its wrapper calls counted from just before to just
        after; ms/iteration from the graph's replays (``replay_ms``)."""
        t0 = time.perf_counter()
        built_since[0] = profiling.STORE.ids
        obj = pv.make_objective(lps[fairness], fairness, layout, "cuda", plan_cache_dir=tmp / "plan_cache")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        timed = variant(obj, type("Timed" + type(obj).__name__, (Timed, type(obj)), {}))
        reset_counts()
        out = pv.run_ours(fairness, pv.MAX_ITER, "cuda", layout, tmp, input_args=lps[fairness], objective=timed)
        torch.cuda.synchronize()
        n = {**counts(), "torch_rows": profiling.counter(TORCH_ROWS)}
        first_ms = timed.events[0][0].elapsed_time(timed.events[0][1])  # iteration 1, eager
        ms_it = replay_ms(timed, zeros(timed), kw=pv_kw)
        s = pv.summarize(refs[fairness], pv.parse_log(out["log_path"]), fairness,
                         sensitivity if fairness else None)
        it1, want1 = out["trace"][0], jax_first[fairness]
        say("examples", run=what, iterations=len(out["trace"]), iteration_1=it1,
            jax_iteration_1=want1, iteration_1_rel_dev_vs_jax=abs(it1 - want1) / abs(want1),
            final_dual=out["final"], reference_final=s["ref_final"], final_rel_err=s["final_rel_err"],
            threshold=s["headline_gate"]["threshold"], tail_max_rel_err=s["tail_max_rel_err"],
            max_rel_err=s["max_rel_err"], fairness_duals=out["fair_duals"], gates_pass=s["pass"],
            ms_per_iteration=f"{ms_it:.4f}", wall_ms_per_iteration=f"{out['solve_s'] * 1e3 / pv.MAX_ITER:.4f}",
            objective_build_s=f"{build_s:.2f}", time_to_first_iteration_s=f"{build_s + first_ms / 1e3:.3f}",
            first_iteration_ms=f"{first_ms:.3f}", wrapper_calls=n, card=card)
        check(np.isfinite(out["trace"]).all() and len(out["trace"]) == pv.MAX_ITER, f"examples {what}: log malformed")
        check(abs(it1 - want1) <= 1e-6 * abs(want1),
              f"examples {what}: iteration 1 {it1} not within 1e-6 of the JAX package's {want1}")
        check(s["headline_gate"]["pass"], f"examples {what}: final {out['final']} is {s['final_rel_err']} from the "
                                          f"reference's {s['ref_final']} (gate {s['headline_gate']['threshold']})")
        check(s["pass_tail_2e-4"], f"examples {what}: the last 10% part by {s['tail_max_rel_err']} (gate 2e-4)")
        check(not fairness or s["fairness_dual_nonzero"], f"examples {what}: fairness duals {out['fair_duals']}")
        return obj, out, n

    # ---- csc, use_pallas=True: K1 in its gather form and the segment-sum
    obj, out, n = run("csc", False, "csc")
    tiles, specs = obj.bcsc.tiles, obj.bcsc.specs
    want = {"K1g": graph_calls(len(tiles), 1), "K2g": 0, "segsum": graph_calls(1, 1)}
    check(all(n[k] == v for k, v in want.items()), f"examples csc: wrapper calls {n}, expected {want}")

    plain_dev = rel_dev(first_iterations(variant(obj, plain_csc_class()), n_chk), out["trace"][:n_chk])
    say("examples", run="csc", plain_check_iterations=n_chk, max_rel_dev_vs_plain=float(plain_dev.max()),
        tolerance=1e-4)
    check(plain_dev.max() <= 1e-4, f"examples csc: kernels vs plain versions differ by {plain_dev.max()}")
    # K1 tile by tile at the solve's final dual, the wide tiles (one warp a column) among them
    nig = torch.full((), -1.0 / pv.GAMMA, dtype=torch.float32, device=dev)
    scaled = nig * out["result"].dual_val
    rows = []
    for t, s in zip(tiles, specs):
        def k1(fn=fm.fused_tile_gather_eval_T, t=t, s=s):
            kw = {"block_k": 1024} if fn is fm.fused_tile_gather_eval_T else {}
            return fn(scaled, t.rows, t.a, t.c, t.length, nig, s.proj_type, s.proj_params, **kw)

        got, ref = k1(), k1(fm.fused_tile_gather_eval_T_reference)
        e = float((got[0] - ref[0]).abs().max())
        check(e <= tol_x(ref[0]), f"examples K1 on the L={s.L} tile: err {e}")
        for i in (1, 2):
            check(abs(float(got[i]) - float(ref[i])) <= 1e-3 + 1e-4 * abs(float(ref[i])),
                  f"examples K1 sums on the L={s.L} tile")
        ms = cuda_ms(k1, reps=20, graph=True).ms
        plain_ms = cuda_ms(lambda: k1(fm.fused_tile_gather_eval_T_reference), reps=2, warmup=1).ms
        real, pad = column_slots(s.L, t.length)  # a real slot: rows, a, c read, a*x written; padding: a*x
        nbytes = real * 16 + pad * 4 + s.K * 4 + obj.bcsc.m * 4
        bound = max(nbytes / PEAK_BYTES_PER_S, real * ops_per_slot(s.proj_type) / PEAK_FP32_FLOP_PER_S) * 1e3
        rows.append((s.L, s.K, int((t.length > 0).sum()), f"{fm.k1_path(s.proj_type, s.L).path} a column", e,
                     round(ms, 4), round(bound, 4), round(bound / ms, 4), round(plain_ms, 3)))
    say("timing", path="examples csc", kernel="'K1 fused_tile_gather_eval_T, each tile'",
        L_K_columns_path_err_ms_bound_share_plain_ms=rows, sum_ms=f"{sum(r[5] for r in rows):.4f}",
        scaled_bytes=obj.bcsc.m * 4, scaled_in_shared_memory=obj.bcsc.m * 4 <= 48 * 1024, card=card)
    del obj, out, scaled
    torch.cuda.empty_cache()

    # ---- butterfly: K3 and the Benes kernels
    obj, out, n = run("butterfly", False, "butterfly")
    plan = obj.row_layout.plan
    N = _plan_size(plan)
    regime = "K6" if n["K6"] else "K7"
    say("examples", run="butterfly", carry_slots=N, blocks=N >> getattr(plan, "block_log2", 15), coarse_regime=regime,
        panel_tiles=[(t.L, t.L2, t.q) for t in obj.panel_table.tiles], routing_s=f"{span_s('dualip.build.route', built_since[0]):.2f}")
    want = {"K3": graph_calls(1, 1), "K4": 0, "K5": graph_calls(2, 1), regime: graph_calls(4, 1), "K1g": 0,
            "segsum": 0}
    check(all(n[k] == v for k, v in want.items()), f"examples butterfly: wrapper calls {n}, expected {want}")
    plain_dev = rel_dev(first_iterations(variant(obj, plain_butterfly_class()), n_chk), out["trace"][:n_chk])
    say("examples", run="butterfly", plain_check_iterations=n_chk, max_rel_dev_vs_plain=float(plain_dev.max()),
        tolerance=1e-5)
    check(plain_dev.max() <= 1e-5, f"examples butterfly: kernels vs plain versions differ by {plain_dev.max()}")
    time_panel("examples butterfly", obj, dev, [], {})  # K3/K4 on the proxy's tiles, L up to 394
    say("examples", run="butterfly", note="K3 projects tiles above its ring's cap (L > 47) "
                                          "one warp a column, from device memory")
    del obj, out, plan
    torch.cuda.empty_cache()

    # ---- fairness: the segment-sum kernel, the fixed order
    obj, out, n = run("fairness", True, "csc")
    tiles, wide_rows = simplex_counts(obj.bcsc)  # the simplex kernel, and torch's ops on the tiles above 64 lanes
    want = {"segsum": graph_calls(1, 1), "K1g": 0, "K3": 0, "simplex": graph_calls(tiles, 1),
            "torch_rows": graph_calls(wide_rows, 1)}
    check(all(n[k] == v for k, v in want.items()), f"examples fairness: wrapper calls {n}, expected {want}")
    again = first_iterations(obj, FAIR_REPEAT_ITERS, eager=False)
    rep = rel_dev(again, out["trace"][:FAIR_REPEAT_ITERS])
    with rebound(mlm, segment_sum_rows=segment_sum_rows_reference):
        plain = rel_dev(first_iterations(obj, n_chk), out["trace"][:n_chk])
    say("examples", run="fairness", repeat_iterations=FAIR_REPEAT_ITERS,
        repeat="bit-identical" if rep.max() == 0 else "DIFFERS", max_rel_dev_repeat=float(rep.max()),
        plain_check_iterations=n_chk, max_rel_dev_vs_plain=float(plain.max()))
    check(rep.max() == 0.0, f"examples fairness: the first {FAIR_REPEAT_ITERS} iterations repeat at {rep.max()}")
    check(plain.max() == 0.0, f"examples fairness: the segment-sum kernel vs its plain version: {plain.max()}")
    graph_check("fairness proxy", obj, zeros(obj), kw=pv_kw)
    del obj, out
    torch.cuda.empty_cache()

    # ---- the MIPLIB script, as a user runs it
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "dualip_tpu_torch.examples.miplib_2017.solve_miplib_dataset"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    tail = p.stdout.strip().splitlines()[-3:]
    say("examples", run="miplib", exit_code=p.returncode, output=tail, seconds=f"{time.perf_counter() - t0:.2f}")
    check(p.returncode == 0, f"examples miplib: exit code {p.returncode}: {p.stderr[-2000:]}")
    say("examples", phase_seconds=f"{time.perf_counter() - t_phase:.1f}", card=card)


def phase_io(dt, args, card, numpy_gen_s, numpy_inp, captured, counts, solve, replay_ms, n_chk):
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
                layout_build_s=f"{span_s('dualip.build.rows'):.2f}", routing_s=f"{span_s('dualip.build.route'):.2f}",
                index_build_s=f"{span_s('dualip.build.index'):.3f}", iterations=n_chk,
                ms_per_iteration=f"{replay_ms(obj, torch.zeros(obj.bcsc.m, device=obj.device)):.4f}",
                launches=n_launch, card=card,
                # a miss's save: the leaves copied back from the card, then written
                tile_cache_copy_s=f"{span_s('dualip.tile_cache.copy'):.3f}",
                tile_cache_write_s=f"{span_s('dualip.tile_cache.write'):.3f}",
                tile_cache_loaded=profiling.counter("dualip.tile_cache.loaded"))
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
    the program's spans (a ``span`` of its own, ``dualip.agd.maximize``) and
    the store's records beside it; ``collect_stats`` fills
    ``last_run_stats``."""
    from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent
    from dualip_tpu_torch.utils.mlflow_utils import MLflowConfig, is_mlflow_available
    from dualip_tpu_torch.utils.profiling import span as store_span, trace

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
    check(n_m["K1g"] == graph_calls(len(obj.bcsc.tiles)) and n_m["segsum"] == graph_calls(1),
          f"obs: wrapper calls {n_m} (a solve on the CUDA graph)")
    say("obs", mlflow_enabled=True, mlflow_available=is_mlflow_available(), iterations=n_chk,
        same_log_as_without_mlflow=True, wrapper_calls=n_m)

    span = "dualip.csc_three_iterations"
    agd = AcceleratedGradientDescent(max_iter=3, **solver_kw)
    dual = torch.zeros(obj.bcsc.m, device=obj.device)
    agd.maximize(obj, dual)  # warm
    with tempfile.TemporaryDirectory(prefix="dualip-trace-") as tmp:
        t0 = time.perf_counter()
        with trace(tmp):
            with store_span(span):
                agd.maximize(obj, dual)
        trace_s = time.perf_counter() - t0
        files, kept = list(Path(tmp).glob("trace_*.json")), list(Path(tmp).glob("spans_*.json"))
        check(len(files) == len(kept) == 1, f"obs: trace wrote {len(files)} traces and {len(kept)} span files")
        events = json.loads(files[0].read_text())["traceEvents"]
        size = files[0].stat().st_size
        kept = json.loads(kept[0].read_text())
    names = {e.get("name", "") for e in events}
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    k1 = sorted(n for n in kernels if re.search(r"(column|wide|clamp)_kernel", n))
    seg = sorted(n for n in kernels if re.search(r"window_sums|add_rows", n))
    say("obs", trace_events=len(events), trace_bytes=size, kernel_names=len(kernels), K1=[n[:60] for n in k1],
        segment_sum=[n[:40] for n in seg], annotate_span=span in names, traced_s=f"{trace_s:.2f}",
        store_marks_ms={k: round(v["total_ns"] / v["count"] * 1e-6, 4) for k, v in kept["aggregates"].items()
                        if k.startswith("dualip.iter.")})
    check(k1 and len(seg) == 2 and {span, "dualip.agd.maximize", "dualip.agd.replay"} <= names,
          "obs: the trace lacks K1's or the segment-sum's kernels or the spans")

    agd = AcceleratedGradientDescent(max_iter=n_chk, **solver_kw)
    agd.collect_stats = True
    agd.maximize(obj, dual)
    st = agd.last_run_stats
    check(st is not None and st["iters"] == n_chk and st["total_s"] >= st["drain_s"] >= 0, f"obs: stats {st}")
    say("obs", last_run_stats={k: (round(v, 4) if isinstance(v, float) else v) for k, v in st.items()}, card=card)
    del obj, captured["obj"], res_m, res_p
    torch.cuda.empty_cache()


def phase_canonical(args, card, captured, solve, replay_ms, solver_kw):
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
        peak = torch.cuda.max_memory_allocated()
        first_ms = obj.events[0][0].elapsed_time(obj.events[0][1])
        dual = res.dual_objective
        rel = abs(dual - CANONICAL_DUAL) / abs(CANONICAL_DUAL)
        slots = sum(s.L * s.K for s in obj.bcsc.specs)
        say("canonical", iterations=len(res.dual_objective_log), tiles=len(obj.bcsc.specs), slots=slots,
            objective_build_s=f"{captured['build_s']:.2f}",
            time_to_first_iteration_s=f"{captured['build_s'] + first_ms / 1e3:.3f}",
            ms_per_iteration=f"{replay_ms(obj, torch.zeros(obj.bcsc.m, device=obj.device)):.4f}",
            run_solver_s=f"{solve_s:.2f}", peak_device_bytes=peak, launches=n_launch, card=card)
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
            # the eager loop: the segment-sum's plain version reads its plan's sizes on the host
            res64 = AcceleratedGradientDescent(max_iter=args.iters, **solver_kw)._maximize_eager(obj64, dual0)
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


DIST_SOLVER = dict(gamma=1e-3, initial_step_size=1e-3, max_step_size=1e-1)  # main's solver_kw
DIST_BUTTERFLY_ITERS = 50  # also the dense LP's
DIST_PLAIN_ITERS = 50  # the plain csc path: about 21 ms an iteration
DIST_CHECK_ITERS = 20  # graph_check's iterations on a mesh path (phase graph's n_chk)
LP_DENSE_COLUMNS = 100_000  # lp-dense-100K: 10,000 x 100,000 fp32, 4 GB (lp-2.5M dense would take 100 GB)
# phase dist's mesh paths on the graph, in the order they run
MESH_PATHS = ("csc use_pallas", "csc plain", "butterfly", "butterfly compact", "lp-2.5M coo", "lp-dense-100K")


def _data_digest(inp) -> str:
    import hashlib

    h = hashlib.sha1()
    for arr in (inp.A.indptr, inp.A.row_indices, inp.A.data, inp.c.data, inp.b_vec):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _dist_rank(mesh, cache_dir, shape, seed, iters, bfly_iters):
    """One of the ranks that share the card in phase ``dist`` (gloo): the
    slice from the generator's ``.npz`` cache, then through ``run_solver
    (compute_device_num=world)`` the csc ``use_pallas`` solve and the
    butterfly solve, each run twice on the same objective, and this rank's
    kernels against their plain versions on its own shard at the final dual.
    Returns numbers only; the parent checks them."""
    import dualip_tpu_torch as dt
    import dualip_tpu_torch.ops.butterfly as bf
    from dualip_tpu_torch.objectives.matching import MatchingSolverDualObjectiveFunction, _srow_carried
    from dualip_tpu_torch.ops.fused_matching import (
        fused_panel_project_tiles,
        fused_panel_project_tiles_reference,
        fused_tile_gather_eval_T,
        fused_tile_gather_eval_T_reference,
    )
    from dualip_tpu_torch.ops.segment_sum import segment_sum_rows, segment_sum_rows_reference
    from dualip_tpu_torch.synthetic import _cache_path, generate_synthetic_matching_input_args

    dev = mesh.device
    path = _cache_path(cache_dir, *shape, np.float32, (seed, "numpy"))
    check(path.exists(), f"rank {mesh.rank}: the parent's generator cache {path} is missing")
    t0 = time.perf_counter()
    inp = generate_synthetic_matching_input_args(*shape, seed=seed, cache_dir=cache_dir)
    out = {"load_s": time.perf_counter() - t0, "digest": _data_digest(inp), "captures": 0}
    built = {}

    class TimedMatching(Timed, MatchingSolverDualObjectiveFunction):
        pass

    @dt.register_objective("dist_smoke")
    def _factory(input_args, solver_args, compute_args, mesh, objective=None, **kw):
        if objective is None:
            t = time.perf_counter()
            objective = TimedMatching(input_args, gamma=solver_args.gamma, mesh=mesh, **kw)
            torch.cuda.synchronize()
            built["obj"], built["s"] = objective, time.perf_counter() - t
        objective.events = []
        return objective

    def solve(n, **kw):
        reset_counts()
        with capture_spy() as cap:  # a gloo mesh runs the eager loop: no capture
            res = dt.run_solver(inp, dt.SolverArgs(max_iter=n, **DIST_SOLVER),
                                dt.ComputeArgs(host_device=str(dev), compute_device_num=mesh.world_size),
                                dt.ObjectiveArgs(objective_type="dist_smoke", objective_kwargs=kw))
        torch.cuda.synchronize()
        out["captures"] += cap.call_count
        return res, counts()

    def timed(path, res, n_launch, obj, build_s):
        ev = obj.events
        again, _ = solve(len(res.dual_objective_log), objective=obj)
        out[path] = {"log": list(res.dual_objective_log), "launches": n_launch, "tiles": len(obj.panel_table.tiles)
                     if obj.panel_table is not None else len(obj.bcsc.tiles),
                     "ms_per_iteration": ev[1][0].elapsed_time(ev[-1][1]) / (len(ev) - 1),
                     "time_to_first_iteration_s": build_s + ev[0][0].elapsed_time(ev[0][1]) / 1e3,
                     "objective_build_s": build_s, "repeat": list(again.dual_objective_log)}

    g = torch.full((), 1e-3, dtype=torch.float32, device=dev)
    nig = -1.0 / g

    # csc, use_pallas=True: K1 per local tile, one segment-sum, one all_reduce
    res, n_launch = solve(iters, use_pallas=True)
    obj = built["obj"]
    timed("csc", res, n_launch, obj, built["s"])
    scaled = nig * res.dual_val
    plan = obj.bcsc.row_sum
    ax_all = torch.empty(plan.slots, device=dev)
    err = 0.0
    for t, s_, off in zip(obj.bcsc.tiles, obj.bcsc.specs, plan.offsets):
        got = fused_tile_gather_eval_T(scaled, t.rows, t.a, t.c, t.length, nig, s_.proj_type, s_.proj_params,
                                       block_k=1024, out=ax_all[off:off + t.a.numel()].view(t.a.shape))
        ref = fused_tile_gather_eval_T_reference(scaled, t.rows, t.a, t.c, t.length, nig, s_.proj_type,
                                                 s_.proj_params)
        e = float((got[0] - ref[0]).abs().max())
        check(e <= tol_x(ref[0]), f"rank {mesh.rank} K1 on its tile {(s_.L, s_.K)}: err {e}")
        for i in (1, 2):
            check(abs(float(got[i]) - float(ref[i])) <= 1e-3 + 1e-4 * abs(float(ref[i])), f"rank {mesh.rank} K1 sums")
        err = max(err, e)
    zero_m = torch.zeros(obj.bcsc.m, device=dev)
    seg = segment_sum_rows(zero_m, ax_all, plan)
    check(torch.equal(seg, segment_sum_rows_reference(zero_m, ax_all, plan)),
          f"rank {mesh.rank}: the segment-sum and its plain version differ on the rank's a*x")
    out["csc"]["K1_max_abs_err"] = err
    out["csc"]["segsum_vs_plain"] = "bit-identical"
    buf = torch.zeros(obj.bcsc.m + 2, device=dev)
    for _ in range(5):
        mesh.all_reduce_(buf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        mesh.all_reduce_(buf)
    torch.cuda.synchronize()
    out["allreduce_ms"] = (time.perf_counter() - t0) * 10.0
    del obj, built["obj"], res, ax_all, seg
    torch.cuda.empty_cache()

    # butterfly: this rank's layout, K7/K5/K7 carries and K3 (K6 where a shard has <= 256 blocks)
    res, n_launch = solve(bfly_iters, layout="butterfly")
    obj = built["obj"]
    timed("butterfly", res, n_launch, obj, built["s"])
    rl, p = obj.row_layout, obj.row_layout.plan
    ids = torch.arange(p.N, dtype=torch.int32, device=dev)
    for reverse in (False, True):
        check(torch.equal(bf.apply_butterfly_cuda(p, ids.clone(), reverse=reverse, truncate=False),
                          plain_blocked(bf, p, ids.clone(), reverse)),
              f"rank {mesh.rank}: the carry (K5/K6/K7) differs from the plain stages, reverse={reverse}")
    srow = _srow_carried(rl, nig * res.dual_val, torch.zeros((), device=dev))
    got = fused_panel_project_tiles(srow.clone(), obj.panel_table, nig)
    ref = fused_panel_project_tiles_reference(srow.clone(), obj.panel_table, nig)
    e = float((got[0] - ref[0]).abs().max())
    check(e <= panel_tol(ref[0], None), f"rank {mesh.rank} K3 on its layout: err {e}")
    for i in (1, 2):
        check(abs(float(got[i]) - float(ref[i])) <= 1e-3 + 1e-4 * abs(float(ref[i])), f"rank {mesh.rank} K3 sums")
    out["butterfly"].update(carry_vs_plain="bit-identical", K3_max_abs_err=e, carry_slots=p.N,
                            blocks=p.N >> p.block_log2, routing_s=span_s("dualip.build.route"))
    return out


def _nccl_probe(mesh):
    mesh.all_reduce_(torch.ones(1, device=mesh.device))
    torch.cuda.synchronize()
    return "all_reduce completed"


def lp_2p5m(inp, dense_columns=None):
    """lp-2.5M: the slice's matrix as a general LP, x in [0, 1], c ~ U(-1, 0)
    from ``default_rng(42)``; with ``dense_columns``, its first that many
    variables as a dense array (lp-dense-100K)."""
    from dualip_tpu_torch.objectives.miplib import MIPLIBInputArgs
    from dualip_tpu_torch.projections import ProjectionEntry

    A = inp.A
    m, n = A.shape
    c = np.random.default_rng(42).uniform(-1.0, 0.0, size=n).astype(np.float32)
    if dense_columns is not None:
        n, end = dense_columns, int(A.indptr[dense_columns])
        dense = np.zeros((m, n), dtype=np.float32)
        dense[A.row_indices[:end], np.repeat(np.arange(n), np.diff(A.indptr[:n + 1]))] = A.data[:end]
        A, c = dense, c[:n]
    return MIPLIBInputArgs(A=A, c=c, b_vec=inp.b_vec,
                           projection_map={"box": ProjectionEntry("box", {"lower": 0.0, "upper": 1.0}, np.arange(n))})


def phase_dist(dt, args, inp, card, dev, refs, solve, captured, replay_ms, graph_check):
    """The entity-sharded solve on the one card.  (a) NCCL, world 1, in this
    process: each mesh path on the AGD's CUDA graph with the all_reduce
    captured (``MESH_PATHS``), its log bit for bit against the eager mesh
    loop's and the one-device graph log, then ``graph_check`` over 20
    iterations (one capture, the replays' kernels the eager loop's, the
    all_reduce's calls and NCCL's kernels, ms graph and eager); the csc ``use_pallas``
    solve through ``run_solver`` (wrapper calls counted), the same objective with
    and without its mesh in turns on the graph, and the all_reduce of m + 2
    floats timed.  Then whether NCCL takes two ranks on one card.  (b) Two
    ranks sharing the card over gloo (the reduction goes through host
    memory), spawned, reading the slice from the generator cache this process
    writes: csc 200 iterations and butterfly 50 in the eager loop (no
    capture), held to each other (bit for bit), to themselves (a repeat), to
    the one-device logs (first 10 iterations within 1e-5, the last within
    1e-2) and each rank's kernels to their plain versions.  Their times are
    two processes time-sharing one card, not a multi-GPU figure."""
    import torch.distributed as dist

    from dualip_tpu_torch import synthetic
    from dualip_tpu_torch.objectives.miplib import MIPLIB2017ObjectiveFunction
    from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent, uses_graph
    from dualip_tpu_torch.parallel import default_mesh, initialize_multihost, run_ranks
    from dualip_tpu_torch.parallel.launch import _free_port

    # (a) one rank over NCCL: an all_reduce over one rank is a copy
    initialize_multihost(f"127.0.0.1:{_free_port()}", world_size=1, rank=0, device=dev, timeout_s=300)
    try:
        mesh = default_mesh(1, device=dev)
        nccl = ".".join(str(v) for v in torch.cuda.nccl.version())
        check(uses_graph(dev, mesh), f"dist (a): the path rule keeps a {mesh.backend()} mesh off the graph")
        say("dist", step="a", backend=mesh.backend(), world=1, nccl_version=nccl, capture_error_mode="global",
            path="graph (uses_graph)", card=card)
        m = inp.b_vec.shape[0]
        zeros = torch.zeros(m, device=dev)
        done = []

        def one_device(obj, iters, kw=DIST_SOLVER):
            """The graph log of the same objective without its mesh (its tiles
            are the whole problem at world 1)."""
            one = copy.copy(obj)
            one.mesh = None
            return list(AcceleratedGradientDescent(max_iter=iters, **kw).maximize(one, zeros).dual_objective_log)

        def mesh_path(path, obj, log, ref, ref_from, kw=DIST_SOLVER):
            """``log``: the mesh graph's whole solve; held to the eager mesh
            loop's and to ``ref`` (one device, on the graph) bit for bit, then
            ``graph_check`` over its first iterations (profiled windows stay
            at phase graph's length)."""
            iters = len(log)
            eager = list(AcceleratedGradientDescent(max_iter=iters, **kw)._maximize_eager(obj, zeros)
                         .dual_objective_log)
            ref = list(ref[:iters])
            row = graph_check(f"dist {path}", obj, zeros, kw=kw, iters=min(iters, DIST_CHECK_ITERS), always=True)
            say("dist", step="a", path=repr(path), iterations=iters,
                log_vs_eager_mesh_loop="bit-identical" if log == eager else "DIFFERS",
                log_vs_one_device_graph="bit-identical" if log == ref else "DIFFERS", one_device=repr(ref_from),
                checked_iterations=row["iterations"], ms_per_iteration_graph=row["graph_ms_per_iteration"],
                ms_per_iteration_eager=row["eager_ms_per_iteration"], eager_over_graph=row["eager_over_graph"],
                all_reduce_calls_graph_run=row["all_reduce_calls_graph_run"],
                nccl_kernels_per_replay=row["nccl_kernels_per_replay"], nccl_version=nccl,
                capture_error_mode="global", card=card)
            check(log == eager, f"dist (a) {path}: the mesh graph's log differs from the eager mesh loop's by "
                                f"{rel_dev(log, eager).max()}")
            check(log == ref, f"dist (a) {path}: the mesh graph's log differs from the one-device graph log by "
                              f"{rel_dev(log, ref).max()}")
            done.append(path)

        # csc use_pallas through run_solver: the graph (one capture), its wrappers called for iteration 1 and
        # the capture, its kernels on the card once an iteration
        with capture_spy() as cap:
            res, n_launch, _ = solve(inp, args.iters, False, use_pallas=True, mesh=mesh)
        obj, n_calls = captured["obj"], captured["calls"]
        log = list(res.dual_objective_log)
        check(cap.call_count == captured["attempts"],  # one a solve: a profiled window that lost records runs again
              f"dist (a): run_solver over the NCCL mesh captured {cap.call_count} graphs in "
              f"{captured['attempts']} solves")
        check(n_calls["K1g"] == graph_calls(len(obj.bcsc.tiles)) and n_calls["segsum"] == graph_calls(1),
              f"dist (a): wrapper calls {n_calls}")
        check(n_launch["K1g"] == len(obj.bcsc.tiles) * args.iters and n_launch["segsum"] == args.iters,
              f"dist (a): launches {n_launch}")
        mesh_path("csc use_pallas", obj, log, refs["csc"], "run_solver without a mesh")
        # the same objective without its mesh, in turns with it (mesh, one device, one device, mesh), on the
        # graph: what the reduction adds to an iteration, within this call
        one = copy.copy(obj)
        one.mesh = None
        turns = [replay_ms(o, zeros, iters=args.iters) for o in (obj, one, one, obj)]
        buf = torch.zeros(m + 2, device=dev)
        t_ar = cuda_ms(lambda: mesh.all_reduce_(buf), reps=200)
        t_ar_graph = cuda_ms(lambda: mesh.all_reduce_(buf), reps=200, graph=True)
        say("dist", step="a", path="'csc use_pallas'", run_solver_captures=cap.call_count, wrapper_calls=n_calls,
            launches=n_launch,
            ms_per_iteration_mesh_one_one_mesh=[f"{t:.4f}" for t in turns], loop="graph, each",
            allreduce_ms=f"{t_ar.eager_ms:.4f}", allreduce_graph_ms=f"{t_ar_graph.ms:.4f}",
            allreduce_host_enqueue_ms=f"{t_ar.host_ms:.4f}", allreduce_floats=m + 2, card=card)
        del obj, one, res, captured["obj"], buf
        torch.cuda.empty_cache()

        # the other matching paths through run_solver over the mesh, then the same checks
        for path, iters, kw in (("csc plain", DIST_PLAIN_ITERS, {}),
                                ("butterfly", DIST_BUTTERFLY_ITERS, {"layout": "butterfly"}),
                                ("butterfly compact", DIST_BUTTERFLY_ITERS,
                                 {"layout": "butterfly", "compact": True, "keep_col_tiles": False,
                                  "keep_flat_idx": False})):
            with capture_spy() as cap:
                res, _, _ = solve(inp, iters, False, profiled=False, mesh=mesh, **kw)
            obj = captured["obj"]
            check(cap.call_count == 1, f"dist (a) {path}: run_solver captured {cap.call_count} graphs")
            if path == "csc plain":  # iteration 1 and the capture: the simplex kernel a tile each
                tiles, wide_rows = simplex_counts(obj.bcsc)
                calls, rows = captured["calls"]["simplex"], profiling.counter(TORCH_ROWS)
                say("dist", step="a", path=repr(path), simplex_tiles=tiles, simplex_wrapper_calls=calls,
                    torch_rows=rows)
                check(tiles > 0 and calls == graph_calls(tiles) and rows == graph_calls(wide_rows),
                      f"dist (a) {path}: simplex calls {calls}, torch rows {rows} for {tiles} tiles")
            if path == "butterfly":
                ref, ref_from = refs["butterfly"], "run_solver without a mesh"
            else:
                ref, ref_from = one_device(obj, iters), "the objective without its mesh"
            mesh_path(path, obj, list(res.dual_objective_log), ref, ref_from)
            del obj, res, captured["obj"]
            torch.cuda.empty_cache()

        # the general LP split by columns: COO (lp-2.5M; phase lp's log where it ran) and dense
        for path, data, iters in (("lp-2.5M coo", lp_2p5m(inp), LP_COO_ITERS),
                                  ("lp-dense-100K", lp_2p5m(inp, LP_DENSE_COLUMNS), DIST_BUTTERFLY_ITERS)):
            ref = refs.get(path)
            if ref is None:
                one = MIPLIB2017ObjectiveFunction(data, device=dev)
                ref = list(AcceleratedGradientDescent(max_iter=iters, **LP_SOLVER).maximize(
                    one, zeros).dual_objective_log)
                del one
            obj = MIPLIB2017ObjectiveFunction(data, mesh=mesh)
            with capture_spy() as cap:
                log = list(AcceleratedGradientDescent(max_iter=iters, **LP_SOLVER).maximize(obj, zeros)
                           .dual_objective_log)
            check(cap.call_count == 1, f"dist (a) {path}: maximize captured {cap.call_count} graphs")
            mesh_path(path, obj, log, ref, "the LP without a mesh", kw=LP_SOLVER)
            del obj, data
            torch.cuda.empty_cache()
        check(list(done) == list(MESH_PATHS), f"dist (a): mesh paths run {done}, expected {MESH_PATHS}")
    finally:
        dist.destroy_process_group()

    # two ranks on one card over NCCL: what it says
    try:
        nccl = run_ranks(_nccl_probe, 2, device=str(dev), backend="nccl", timeout_s=60, join_timeout_s=120)[0]
    except (RuntimeError, TimeoutError) as e:
        lines = [ln.strip() for ln in str(e).splitlines() if ln.strip()]
        said = [ln for ln in lines if any(w in ln for w in ("Duplicate GPU", "ncclInvalidUsage", "NCCL error"))]
        nccl = " | ".join(dict.fromkeys(said)) or lines[-1]
    say("dist", nccl_two_ranks_one_card=repr(nccl[:600]))

    # (b) two ranks sharing the card over gloo
    shape = (args.sources, args.destinations, args.sparsity)
    with tempfile.TemporaryDirectory(prefix="dualip-dist-") as tmp:
        path = synthetic._cache_path(tmp, *shape, np.float32, (args.seed, "numpy"))
        synthetic._save_cached((inp.A.indptr, inp.A.row_indices, inp.A.data, -inp.c.data, inp.b_vec), path,
                               path.with_suffix(".mm"), False, np.float32)
        t0 = time.perf_counter()
        ranks = run_ranks(_dist_rank, 2, args=(tmp, shape, args.seed, args.iters, DIST_BUTTERFLY_ITERS),
                          device=str(dev), backend="gloo", timeout_s=300, join_timeout_s=600)
        wall_s = time.perf_counter() - t0
    digest = _data_digest(inp)
    for path_, n_iter in (("csc", args.iters), ("butterfly", DIST_BUTTERFLY_ITERS)):
        want = np.asarray(refs[path_][:n_iter])
        for r, got in enumerate(ranks):
            g = got[path_]
            check(got["digest"] == digest, f"dist (b) rank {r}: the data read from the cache differ")
            check(g["log"] == ranks[0][path_]["log"], f"dist (b) {path_}: rank {r}'s log differs from rank 0's")
            check(g["repeat"] == g["log"], f"dist (b) {path_}: rank {r}'s second run differs from its first")
            first = rel_dev(g["log"][:10], want[:10]).max()
            last = rel_dev(g["log"][-1:], want[-1:]).max()
            n = g["launches"]
            say("dist", step="b", rank=r, path=path_, iterations=n_iter, ms_per_iteration=f"{g['ms_per_iteration']:.4f}",
                time_to_first_iteration_s=f"{g['time_to_first_iteration_s']:.3f}",
                objective_build_s=f"{g['objective_build_s']:.2f}", launches=n,
                max_rel_dev_first_10_vs_one_device=float(first), rel_dev_last_vs_one_device=float(last),
                final_dual_objective=g["log"][-1], one_device_final=float(want[-1]),
                **{k: v for k, v in g.items() if k.endswith(("_err", "_vs_plain", "_slots", "blocks", "routing_s"))},
                timing="two processes time-sharing one card, all_reduce through host memory (gloo); "
                       "not a multi-GPU figure", card=card)
            check(first <= 1e-5, f"dist (b) {path_} rank {r}: first 10 iterations {first} from the one-device log")
            check(last <= 1e-2, f"dist (b) {path_} rank {r}: final dual {last} from the one-device dual")
            if path_ == "csc":
                check(n["K1g"] == g["tiles"] * n_iter and n["K1g"] > 0 and n["segsum"] == n_iter,
                      f"dist (b) csc rank {r}: launches {n}")
            else:
                check(n["K3"] == n_iter and n["K5"] == 2 * n_iter and n["K6"] + n["K7"] == 4 * n_iter
                      and n["K1g"] == n["segsum"] == 0, f"dist (b) butterfly rank {r}: launches {n}")
    captures = [r["captures"] for r in ranks]
    check(captures == [0, 0], f"dist (b): the gloo ranks captured {captures} graphs; a gloo mesh runs eager")
    say("dist", step="b", ranks=2, backend="gloo", device=str(dev), loop="eager", captures=captures,
        wall_s=f"{wall_s:.1f}",
        data_load_s=[f"{r['load_s']:.2f}" for r in ranks], allreduce_ms=[f"{r['allreduce_ms']:.4f}" for r in ranks],
        allreduce_floats=inp.b_vec.shape[0] + 2, ranks_bit_identical=True, repeats_bit_identical=True, card=card)


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
    return len(variants)


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
    record_captures()

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
    need_data = bool({"slice", "butterfly", "lp", "obs", "dist"} & set(phases))
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
        check_err = phase_kernels(sorted({1, 2, 8, 16, 32, 65, 100, 128, 394, 513, 1000, 1024, 2048, 2100, 4096,
                                          8192, 9254, 20000, 60000, l_max}), dev)
    if "ml20m" in phases:
        phase_ml20m(dev, card)
    if "ml20m_panel" in phases:
        phase_ml20m_panel(dev, card)
    if "segsum" in phases:
        segsum_err = phase_segsum(dev)
    simplex_row = phase_simplex(dev) if "simplex" in phases else None
    if "benes" in phases:
        phase_benes(dev)
    if "panel" in phases:
        panel_err = phase_panel(dev)
    golden = None  # (solves, graphs captured)
    if "golden" in phases:
        with capture_spy() as cap:
            n_golden = phase_golden(dev_name)
        golden = (n_golden, cap.call_count)  # one graph per run_solver call on the card
    say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

    kernels = []
    solver_kw = dict(gamma=1e-3, initial_step_size=1e-3, max_step_size=1e-1)
    n_chk = min(args.check_iters, args.iters)
    captured = {}

    class TimedMatching(Timed, MatchingSolverDualObjectiveFunction):
        pass

    @dt.register_objective("matching_smoke")
    def _factory(input_args, solver_args, compute_args, mesh, **kw):
        t = time.perf_counter()
        obj = TimedMatching(input_args, gamma=solver_args.gamma, device=compute_args.host_device, mesh=mesh, **kw)
        torch.cuda.synchronize()
        obj.events = []
        captured["obj"], captured["build_s"] = obj, time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats()
        if captured.get("on_built"):
            captured["on_built"]()
        return obj

    @dt.register_objective("matching_smoke_prebuilt")
    def _prebuilt(input_args, solver_args, compute_args, mesh, objective=None):
        objective.events = []
        if captured.get("on_built"):
            captured["on_built"]()
        return objective

    def solve(data, iters, save_primal, objective_type="matching_smoke", profiled=True, **objective_kwargs):
        """One solve through run_solver: (result, launches, seconds), the
        wrappers' counts set to 0 just before and left in
        ``captured["calls"]``.  With ``profiled`` the solve runs under a
        profiler of the card's activity from the moment the factory returns
        the built objective to the end, and the launches are the port's
        kernels that ran on the card (``device_launches``), to which the forms
        only the host launches (``HOST_FORMS``) add their calls in the build;
        each kernel that ran was called through its wrapper.  A solve whose
        profiler lost records of its launches (``lost_records``) is run again.
        A solve whose launches are not read (a repeat, a reference log) runs
        with ``profiled=False`` and gives None for them.  ``captured["attempts"]``
        counts the solves run."""
        from torch.profiler import ProfilerActivity, profile

        for attempt in range(1, PROFILER_ATTEMPTS + 1):
            reset_counts()
            prof, window = profile(activities=[ProfilerActivity.CUDA]), {}

            def start(prof=prof, window=window, attempt=attempt):  # the objective is built: the solve starts
                torch.cuda.synchronize()
                window["calls"] = counts()
                prof.start()
                window["since"] = profiler_lead(attempt)

            captured["on_built"] = start if profiled else None
            t = time.perf_counter()
            try:
                res = dt.run_solver(
                    data, dt.SolverArgs(max_iter=iters, save_primal=save_primal, **solver_kw), dt.ComputeArgs(),
                    dt.ObjectiveArgs(objective_type=objective_type, objective_kwargs=objective_kwargs),
                )
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t
            finally:
                captured["on_built"] = None
                if "calls" in window:
                    prof.stop()
            captured["calls"] = calls = counts()
            captured["attempts"] = attempt
            if not profiled:
                return res, None, seconds
            check("calls" in window, "solve: the objective's factory did not start the profiler")
            lost = lost_records(prof, window["since"], f"run_solver {objective_type}", attempt)
            if not lost:
                break
        check(not lost, f"solve: the profiler lost records of the card in {PROFILER_ATTEMPTS} attempts")
        built = window["calls"]
        n = device_launches(prof, {k: calls[k] - built[k] for k in calls})
        for k in HOST_FORMS:
            n[k] += built[k]
        check(n["segsum_window"] == n["segsum"], f"the segment-sum's two kernels ran {n['segsum_window']} and "
                                                 f"{n['segsum']} times")
        unseen = [k for k in calls if n[k] and not calls[k]]
        check(not unseen, f"kernels ran on the card with no call of their wrapper: {unseen} ({n}; calls {calls})")
        return res, n, seconds

    def first_iterations(objective, m):
        """The first iterations of a plain-version objective, in the eager
        loop: the plain versions are references, not built for a graph (the
        segment-sum's reads its plan's sizes on the host)."""
        return np.array(AcceleratedGradientDescent(max_iter=n_chk, **solver_kw)._maximize_eager(
            objective, torch.zeros(m, device=dev)).dual_objective_log)

    profiled = {}  # path -> profile_run's numbers

    def profile_run(path, fn, iters):
        """``fn`` (``iters`` iterations) under torch.profiler, with the counts
        set to 0 just before: prints the device's busy share of the wall and
        the kernels' time by name, and returns its numbers (``launches``: the
        port's kernels that ran on the card, ``by_name``: every kernel's
        records); None if the profiler recorded no device time.  A window
        whose profiler lost records of its launches (``lost_records``) runs
        again."""
        from torch.profiler import ProfilerActivity, profile

        for attempt in range(1, PROFILER_ATTEMPTS + 1):
            torch.cuda.synchronize()
            reset_counts()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                since = profiler_lead(attempt)
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            lost = lost_records(prof, since, path, attempt)
            if not lost:
                break
        check(not lost, f"profile {path}: the profiler lost records of the card in {PROFILER_ATTEMPTS} attempts")
        spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start
                       and not is_lead(e.name))
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
        kinds = {k: sum(c for nm, (c, _) in by_name.items() if nm.startswith(k.capitalize())) / iters
                 for k in ("memcpy", "memset")}
        kinds["kernel"] = len(spans) / iters - sum(kinds.values())
        r = profiled[path] = {"busy_share": busy / wall_us, "activities": len(spans) / iters, "kinds": kinds,
                              "launches": device_launches(prof, counts()),
                              "by_name": {nm: c for nm, (c, _) in by_name.items()}}
        say("profile", path=path, iterations=iters, window_wall_ms=f"{wall_us / 1e3:.4f}",
            device_span_ms=f"{span / 1e3:.4f}", device_busy_ms=f"{busy / 1e3:.4f}",
            busy_share_of_wall=f"{busy / wall_us:.4f}", busy_share_of_span=f"{busy / span:.4f}",
            device_activities_per_iteration=len(spans) / iters, index_select_kernels_per_iteration=n_select / iters)
        for nm, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:14]:
            say("profile", path=path, kernel=repr(nm[:80]), per_iteration=c / iters,
                ms_per_iteration=f"{t / iters / 1e3:.4f}")
        return r

    def profile_window(path, objective, dual, iters=10, kw=None):
        """A torch.profiler window over ``iters`` iterations of ``path``: the
        solve's second ``maximize`` on one solver, all replays of the graph
        its first captured.  Returns the kernels' records per name (None if
        nothing was recorded)."""
        agd = AcceleratedGradientDescent(max_iter=iters, **(kw or solver_kw))
        agd.maximize(objective, dual)
        r = profile_run(path, lambda: agd.maximize(objective, dual), iters)
        return None if r is None else r["by_name"]

    def replay_ms(objective, x0, kw=None, iters=GRAPH_TIMING_ITERS, agd=None):
        """ms an iteration on the graph: a CUDA event pair around a second
        ``maximize`` on one solver (``agd``, or a new one whose first
        ``maximize`` captures), which only replays the graph cached in its
        ``_jit_cache``, over its iterations.  The window also holds loading
        the start into the graph's buffers and fetching the metrics."""
        if agd is None:
            agd = AcceleratedGradientDescent(max_iter=iters, **(kw or solver_kw))
            agd.maximize(objective, x0)
        return event_ms(lambda: agd.maximize(objective, x0)) / agd.max_iter

    def check_simplex(what, bcsc, n_launch, calls, torch_rows, iters):
        """A graph-replayed registry csc solve of ``iters`` evaluations (no
        save_primal): the simplex kernel ran once a tile an evaluation on the
        card, its wrapper was called in iteration 1 and the capture, and no
        row it could take was left to torch's ops."""
        tiles, wide_rows = simplex_counts(bcsc)
        say("slice", option=repr(what), simplex_tiles=tiles, simplex_launches=n_launch["simplex"],
            simplex_wrapper_calls=calls["simplex"], torch_rows=torch_rows, expected_torch_rows=graph_calls(wide_rows))
        check(tiles > 0 and n_launch["simplex"] == tiles * iters and calls["simplex"] == graph_calls(tiles),
              f"{what}: simplex launches {n_launch['simplex']}, calls {calls['simplex']} for {tiles} tiles")
        check(torch_rows == graph_calls(wide_rows), f"{what}: {torch_rows} rows left to torch's ops")

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

    graph_rows = {}  # phase graph: path -> its numbers

    def graph_check(path, obj, x0, kw=None, iters=None, always=False):
        """Phase graph on one path (phase dist's mesh paths call it with
        ``always``): the same objective and start through the
        eager loop (``_maximize_eager``) and through ``maximize`` (iteration 1
        eager, then replays of a CUDA graph of one iteration), each on a
        solver of its own, three times: the first run (counts set to 0 just
        before, peak device bytes), the second timed by one CUDA event pair
        (on the graph all replays, from ``_jit_cache``), the third under the
        profiler.  Held: the logs and final duals bit for bit, both ways and
        across the repeats; one capture; the graph's first run calls each
        wrapper twice as often as one eager iteration (iteration 1 and the
        capture); and the port's kernels that the profiler saw run in the
        graph's replays equal the eager loop's wrapper counts and its own
        profiled launches.  On a mesh also: the first runs' ``all_reduce``
        calls (one an eager iteration; iteration 1 and the capture on the
        graph) and NCCL's kernels a replay equal to those of an eager
        iteration.  The graph's nodes by kind are the profiler's records of
        one replay (kernels, copies, memsets).  Returns its row of numbers
        (None when phase graph is not run)."""
        if "graph" not in phases and not always:
            return None
        kw, iters = kw or solver_kw, iters or n_chk
        mesh = getattr(obj, "mesh", None)
        cls = type(obj) if isinstance(obj, Timed) else type("Timed" + type(obj).__name__, (Timed, type(obj)), {})
        tobj = variant(obj, cls)
        out = {}
        for mode in ("eager", "graph"):
            agd = AcceleratedGradientDescent(max_iter=iters, **kw)
            run = agd._maximize_eager if mode == "eager" else agd.maximize
            with capture_spy() as cap, reduce_spy() as red:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                reset_counts()
                res = run(tobj, x0)
                torch.cuda.synchronize()
                o = out[mode] = {"res": res, "calls": counts(), "peak": torch.cuda.max_memory_allocated() - base,
                                 "reduces": red.call_count}
                again = []
                o["ms"] = event_ms(lambda: again.append(run(tobj, x0))) / iters
                prof = profile_run(f"{path} {mode}", lambda: again.append(run(tobj, x0)), iters)
                o["captures"] = cap.call_count
            o["repeats_equal"] = all(list(r.dual_objective_log) == list(res.dual_objective_log)
                                     and torch.equal(r.dual_val, res.dual_val) for r in again)
            check(prof is not None, f"graph {path} {mode}: the profiler recorded no device time")
            o.update(busy=prof["busy_share"], activities=prof["activities"], launches=prof["launches"],
                     kinds=prof["kinds"], nccl=nccl_records(prof["by_name"]) / iters)
            del agd, run, again
        e, g = out["eager"], out["graph"]
        same_log = list(e["res"].dual_objective_log) == list(g["res"].dual_objective_log)
        same_dual = torch.equal(e["res"].dual_val, g["res"].dual_val)
        # the kernels of an iteration (K5w/K7w build an index once, which a first run may do)
        names = [k for k in _counted() if k not in ("K5w", "K7w")]
        replayed_as_eager = all(g["launches"][k] == e["calls"][k] for k in names)
        eager_as_counted = all(e["launches"][k] == e["calls"][k] for k in names)
        segsum_whole = e["launches"]["segsum_window"] == e["launches"]["segsum"] and \
            g["launches"]["segsum_window"] == g["launches"]["segsum"]
        calls_graph_run = all(g["calls"][k] * iters == 2 * e["calls"][k] for k in names)
        nonzero = lambda d: {k: v for k, v in d.items() if v}  # noqa: E731
        row = {"iterations": iters, "eager_ms_per_iteration": f"{e['ms']:.4f}",
               "graph_ms_per_iteration": f"{g['ms']:.4f}",
               "eager_over_graph": f"{e['ms'] / g['ms']:.3f}", "eager_busy_share": e["busy"],
               "graph_busy_share": g["busy"], "eager_activities_per_iteration": e["activities"],
               "graph_activities_per_iteration": g["activities"], "graph_nodes_per_replay": g["kinds"],
               "port_kernels_per_replay": {k: v / iters for k, v in nonzero(g["launches"]).items()},
               "eager_wrapper_calls": nonzero(e["calls"]), "graph_run_wrapper_calls": nonzero(g["calls"]),
               "eager_peak_bytes": e["peak"], "graph_peak_bytes": g["peak"]}
        if mesh is not None:
            row.update(all_reduce_calls_eager_run=e["reduces"], all_reduce_calls_graph_run=g["reduces"],
                       nccl_kernels_per_eager_iteration=e["nccl"], nccl_kernels_per_replay=g["nccl"])
        graph_rows[path] = row
        say("graph", path=repr(path), logs="bit-identical" if same_log else "DIFFER",
            final_dual="bit-identical" if same_dual else "DIFFERS",
            repeats_equal=e["repeats_equal"] and g["repeats_equal"],
            replays_launch_the_eager_kernels=replayed_as_eager, eager_profile_matches_counts=eager_as_counted,
            captures=g["captures"], **row, card=card)
        check(same_log, f"graph {path}: the graph's log differs from the eager loop's by "
                        f"{rel_dev(g['res'].dual_objective_log, e['res'].dual_objective_log).max()}")
        check(same_dual, f"graph {path}: the graph's final dual differs from the eager loop's")
        check(e["repeats_equal"] and g["repeats_equal"], f"graph {path}: a repeated maximize differs from the first")
        check(e["captures"] == 0 and g["captures"] == 1, f"graph {path}: {g['captures']} captures, expected 1")
        check(calls_graph_run, f"graph {path}: wrapper calls {g['calls']} on the graph's run, eager {e['calls']} "
                               f"over {iters} iterations (expected iteration 1 and the capture)")
        check(eager_as_counted, f"graph {path}: the profiler saw {e['launches']} eager, the wrappers counted "
                                f"{e['calls']}")
        check(replayed_as_eager, f"graph {path}: the replays launched {g['launches']}, the eager loop "
                                 f"{e['calls']}")
        check(segsum_whole, f"graph {path}: the segment-sum's two kernels ran apart: {e['launches']}, {g['launches']}")
        if mesh is not None:
            check(e["reduces"] == iters and g["reduces"] == 2,
                  f"graph {path}: all_reduce calls {e['reduces']} eager, {g['reduces']} on the graph's first run")
            check(g["nccl"] == e["nccl"], f"graph {path}: NCCL kernels {g['nccl']} a replay, {e['nccl']} an eager "
                                          f"iteration")
        del out, e, g
        torch.cuda.empty_cache()
        return row

    certs, cert_dual = {}, None

    def certify(what, objective, dual):
        """The exact certificate at ``dual``: its numbers, its time, and the
        simplex kernel's calls and the rows left to torch's ops in it."""
        torch.cuda.synchronize()
        before = profiling.counter(_counted()["simplex"]), profiling.counter(TORCH_ROWS)
        t0 = time.perf_counter()
        c = objective.exact_certificate(dual)
        ms = (time.perf_counter() - t0) * 1e3
        say("cert", layout=what, primal_ub=c["primal_ub"], dual_lb=c["dual_lb"], gap_rel=c["gap_rel"],
            max_row_violation=c["max_row_violation"], ms=f"{ms:.1f}",
            simplex_calls=profiling.counter(_counted()["simplex"]) - before[0],
            torch_rows=profiling.counter(TORCH_ROWS) - before[1], card=card)
        check(c["dual_lb"] <= c["primal_ub"], f"cert {what}: dual_lb {c['dual_lb']} > primal_ub {c['primal_ub']}")
        check(all(np.isfinite(v) for v in c.values()), f"cert {what}: not finite: {c}")
        return c

    csc_log = None
    dist_refs = {}  # the one-device logs phase dist holds its meshes to
    # ------------------------------------------------------------------ 8. csc slice
    if "slice" in phases:
        res, n_launch, solve_s = solve(inp, args.iters, True, use_pallas=True)
        csc_calls = captured["calls"]
        peak = torch.cuda.max_memory_allocated()
        obj = captured["obj"]
        ev = obj.events
        zeros_m = torch.zeros(obj.bcsc.m, device=dev)
        specs, tiles = obj.bcsc.specs, obj.bcsc.tiles
        n_tiles = len(tiles)
        slots = sum(s.L * s.K for s in specs)
        cols = sum(s.K for s in specs)
        nnz = obj.bcsc.nnz
        first_iter_ms = ev[0][0].elapsed_time(ev[0][1])
        ms_per_iter = replay_ms(obj, zeros_m, iters=args.iters)
        log = csc_log = res.dual_objective_log
        dist_refs.update(csc=list(log), csc_ms=f"{ms_per_iter:.4f}")
        say("slice", nnz=nnz, tiles=n_tiles, tile_shapes=[(s.L, s.K) for s in specs],
            max_bucket_L=max(s.L for s in specs), slots=slots, pad_ratio=f"{slots / nnz:.4f}")
        say("slice", generate_s=f"{gen_s:.2f}", objective_build_s=f"{captured['build_s']:.2f}",
            time_to_first_iteration_s=f"{captured['build_s'] + first_iter_ms / 1e3:.3f}",
            first_iteration_ms=f"{first_iter_ms:.3f}", run_solver_s=f"{solve_s:.2f}")
        say("slice", iterations=len(log), ms_per_iteration=f"{ms_per_iter:.4f}",
            iterations_per_s=f"{1e3 / ms_per_iter:.2f}",
            window="a second maximize of as many iterations on one solver: replays of its cached graph",
            final_dual_objective=res.dual_objective, peak_device_bytes=peak)
        want = {"K1g": n_tiles * args.iters, "K2g": n_tiles, "segsum": args.iters + 1}
        want_calls = {"K1g": graph_calls(n_tiles), "K2g": n_tiles, "segsum": graph_calls(1, 1)}
        say("slice", launches=n_launch, expected=want, wrapper_calls=csc_calls, expected_calls=want_calls,
            note="launches: the profiler's records on the card; K1g/K2g: the tile kernel; "
                 "segsum: one call (two CUDA launches) per evaluation, all tiles at once; "
                 "wrapper calls: iteration 1 and the graph's capture, then save_primal's evaluation")
        check_solution(res, obj, inp, args.iters, "csc slice")
        for k, v in want.items():
            check(n_launch[k] == v, f"csc slice: {k} launches {n_launch[k]} != {v}")
            check(csc_calls[k] == want_calls[k], f"csc slice: {k} wrapper calls {csc_calls[k]} != {want_calls[k]}")
        csc_launches = n_launch

        # The solve again, whole: the fixed-order segment-sum makes it repeat itself.
        res2, _, _ = solve(inp, args.iters, False, objective_type="matching_smoke_prebuilt", profiled=False,
                           objective=obj)
        repeat_dev = rel_dev(res2.dual_objective_log, log)
        say("slice", repeat_of_the_solve="bit-identical" if repeat_dev.max() == 0 else "DIFFERS",
            max_rel_dev_fused_repeat=float(repeat_dev.max()), final_dual_objective_again=res2.dual_objective)
        check(repeat_dev.max() == 0.0 and res2.dual_objective == res.dual_objective,
              f"two csc solves differ by {repeat_dev.max()} relative")
        graph_check("csc use_pallas", obj, zeros_m)
        if "graph" in phases:
            # the JAX package's benchmark protocol: chunks of launch_chunk replays, each ended by a fetch
            agd = AcceleratedGradientDescent(max_iter=args.iters, launch_chunk=50, **solver_kw)
            agd.collect_chunk_walls = True
            r_c = agd.maximize(obj, zeros_m)
            sizes = [size for size, _ in agd.chunk_walls]
            want_sizes = [min(50, args.iters - p) for p in range(0, args.iters, 50)]
            later = agd.chunk_walls[1:]
            later_ms = sum(w for _, w in later) * 1e3 / max(1, sum(n for n, _ in later))
            same = list(r_c.dual_objective_log) == list(log)
            say("graph", path="'csc use_pallas'", launch_chunk=50, iterations=args.iters, chunk_sizes=sizes,
                chunk_walls_s=[f"{w:.4f}" for _, w in agd.chunk_walls],
                ms_per_iteration_later_chunks=f"{later_ms:.4f}",
                log_vs_run_solver="bit-identical" if same else "DIFFERS", card=card)
            check(sizes == want_sizes, f"graph: chunk_walls sizes {sizes}, expected {want_sizes}")
            check(same, "graph: the launch_chunk=50 solve's log differs")
            del agd, r_c
            # a cached graph reads the params of the call that runs it: b rebound between two maximize calls
            agd = AcceleratedGradientDescent(max_iter=n_chk, **solver_kw)
            b_old = obj.b_vec
            with capture_spy() as cap:
                r_old = agd.maximize(obj, zeros_m)
                obj.b_vec = 0.5 * b_old
                r_new = agd.maximize(obj, zeros_m)
                r_again = agd.maximize(obj, zeros_m)
            want = AcceleratedGradientDescent(max_iter=n_chk, **solver_kw)._maximize_eager(obj, zeros_m)
            obj.b_vec = b_old
            same = list(r_new.dual_objective_log) == list(want.dual_objective_log) and \
                torch.equal(r_new.dual_val, want.dual_val)
            again = list(r_again.dual_objective_log) == list(r_new.dual_objective_log)
            say("graph", path="'csc use_pallas'", rebound="b_vec to b_vec / 2 between two maximize calls",
                iterations=n_chk, captures=cap.call_count, final_old_b=r_old.dual_objective,
                final_new_b=r_new.dual_objective, log_vs_eager_loop_new_b="bit-identical" if same else "DIFFERS",
                third_call_replays_the_new_graph=again, card=card)
            check(cap.call_count == 2, f"graph: {cap.call_count} captures for b, b / 2, b / 2 (expected 2)")
            check(same and again, "graph: the solve after rebinding b_vec differs from the eager loop's on the new b")
            check(r_new.dual_objective != r_old.dual_objective, "graph: rebinding b_vec changed nothing")
            del agd, r_old, r_new, r_again, want

        # The first iterations again, with K1's plain version on the card (same
        # tiles, the same segment-sum kernel on both sides).
        plain = variant(obj, plain_csc_class())
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

        def run_gather(want_x, fn=None):
            fn = fn or fused_tile_gather_eval_T
            kw = {} if fn is fused_tile_gather_eval_T_reference else {"block_k": 1024}
            return [fn(scaled, t.rows, t.a, t.c, t.length, nig, s.proj_type, s.proj_params, want_x=want_x,
                       out=views[i] if fn is fused_tile_gather_eval_T else None, **kw)
                    for i, (t, s) in enumerate(zip(tiles, specs))]

        real_pad = [column_slots(s.L, t.length) for t, s in zip(tiles, specs)]

        def bound(want_x):
            # a real column's slot: rows, a, c read, a*x (and x) written; a padding column's: a*x (and x)
            x_bytes = 4 if want_x else 0
            nbytes = sum(r * (16 + x_bytes) + p_ * (4 + x_bytes) for r, p_ in real_pad) + cols * 4 + obj.bcsc.m * 4
            nops = sum(r * ops_per_slot(s.proj_type) for (r, _), s in zip(real_pad, specs))
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_FLOP_PER_S * 1e3
            return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, nops

        biggest = specs[max(range(n_tiles), key=lambda i: specs[i].L * specs[i].K)]
        for name, want_x, replaces in (
            ("K1 fused_tile_gather_eval_T", False,
             "dualip_tpu/ops/pallas_matching.py:141, with the lambda gather XLA ran before it"),
            ("K2 fused_tile_gather_eval_T want_x", True, "dualip_tpu/ops/pallas_matching.py:159"),
        ):
            got = [tuple(v.clone() for v in g) for g in run_gather(want_x)]
            ref = run_gather(want_x, fn=fused_tile_gather_eval_T_reference)
            torch.cuda.synchronize()
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
            t_k = cuda_ms(lambda: run_gather(want_x), reps=20, graph=True)
            t_plain = cuda_ms(lambda: run_gather(want_x, fn=fused_tile_gather_eval_T_reference), reps=3, warmup=1)
            b_ms, b_by, nbytes, nops = bound(want_x)
            say("timing", kernel=repr(name), per_iteration_ms=f"{t_k.ms:.4f}", plain_ms=f"{t_plain.ms:.3f}",
                bound_ms=f"{b_ms:.4f}", share_of_bound=f"{b_ms / t_k.ms:.3f}", bytes=nbytes, ops=nops,
                largest_tile=(biggest.L, biggest.K), **timing_kv(t_k))
            kernels.append({
                "name": name, "route": "cuda", "source": "dualip_tpu_torch/csrc/fused_matching.cu",
                "replaces": replaces, "launches": csc_launches["K2g" if want_x else "K1g"],
                "wrapper_calls": csc_calls["K2g" if want_x else "K1g"], "max_abs_err": err,
                "ms": t_k.ms, "plain_ms": t_plain.ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None,  # no single PyTorch call computes the projection
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
        k1_ms = kernels[-2]["ms"]
        say("timing", segment_sum_kernel_ms=f"{seg_t.ms:.4f}", segment_sum_bound_ms=f"{seg_bound:.4f}",
            share_of_bound=f"{seg_bound / seg_t.ms:.3f}", plain_ms=f"{seg_plain.ms:.3f}",
            one_window_ms=f"{one_t.ms:.4f}", window_bytes=WINDOW_BYTES,
            index_add_atomic_ms=f"{atomic_t.ms:.4f}", K1_ms=f"{k1_ms:.4f}", iteration_ms=f"{ms_per_iter:.4f}",
            rest_ms=f"{ms_per_iter - seg_t.ms - k1_ms:.4f}", **timing_kv(seg_t))
        kernels.append({
            "name": "segment_sum_rows", "route": "cuda", "source": "dualip_tpu_torch/csrc/segment_sum.cu",
            "replaces": "none: XLA's segment_sum at dualip_tpu/objectives/matching.py:182, outside any TPU kernel",
            "launches": csc_launches["segsum"], "wrapper_calls": csc_calls["segsum"], "max_abs_err": seg_err,
            "ms": seg_t.ms, "plain_ms": seg_plain.ms,
            "bound_ms": seg_bound, "bound_by": "bytes", "library_ms": atomic_t.ms,
        })
        del ax_all, views, rows_all, plain, r_f, r_p, res2
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
        calls16, rows16 = captured["calls"], profiling.counter(TORCH_ROWS)
        check(obj16.bcsc.tiles[0].a.dtype == torch.bfloat16, "csc bf16 tiles: the tiles are not bf16")
        log16 = np.asarray(r16.dual_objective_log)

        class PlainSegsum(MatchingSolverDualObjectiveFunction):
            def _local(self, *a, **kw):
                with rebound(matching_mod, segment_sum_rows=segment_sum_rows_reference):
                    return super()._local(*a, **kw)

        plain16 = rel_dev(first_iterations(variant(obj16, PlainSegsum), obj16.bcsc.m), log16)
        vs32 = rel_dev(log16, csc_log[:n_chk])
        say("slice", option="'dtype=bfloat16 (tiles), use_pallas=False'", iterations=n_chk,
            ms_per_iteration=f"{replay_ms(obj16, torch.zeros(obj16.bcsc.m, device=dev)):.4f}",
            fp32_tiles_use_pallas_ms_per_iteration=f"{ms_per_iter:.4f}",
            objective_build_s=f"{captured['build_s']:.2f}", max_rel_dev_vs_plain=float(plain16.max()),
            max_rel_dev_vs_fp32_tiles=float(vs32.max()), launches=n_launch, card=card)
        check(plain16.max() == 0.0, f"csc bf16 tiles: kernel vs plain versions differ by {plain16.max()} relative")
        check(vs32.max() <= 4e-2, f"csc bf16 tiles drift {vs32.max()} relative from the fp32 tiles")
        check(n_launch["segsum"] == n_chk and n_launch["K1g"] == 0, f"csc bf16 tiles: launches {n_launch}")
        check_simplex("csc bf16 tiles", obj16.bcsc, n_launch, calls16, rows16, n_chk)
        graph_check("csc bf16 tiles", obj16, torch.zeros(obj16.bcsc.m, device=dev))
        del obj16, r16, captured["obj"]
        torch.cuda.empty_cache()
        if "graph" in phases:  # the plain csc path on fp32 tiles (registry projections, the segment-sum kernel)
            r_p, n_launch, _ = solve(inp, n_chk, False)
            obj_p = captured["obj"]
            calls_p = captured["calls"]
            check_simplex("csc plain", obj_p.bcsc, n_launch, calls_p, profiling.counter(TORCH_ROWS), n_chk)
            if simplex_row is not None:  # the kernel table's counts: the main path's own solve
                simplex_row.update(launches=n_launch["simplex"], wrapper_calls=calls_p["simplex"])
            say("slice", option="'use_pallas=False (fp32 tiles)'", iterations=n_chk,
                ms_per_iteration=f"{replay_ms(obj_p, torch.zeros(obj_p.bcsc.m, device=dev)):.4f}",
                max_rel_dev_vs_fused=float(rel_dev(r_p.dual_objective_log, csc_log[:n_chk]).max()), launches=n_launch)
            check(n_launch["segsum"] == n_chk and n_launch["K1g"] == 0, f"csc plain: launches {n_launch}")
            graph_check("csc plain", obj_p, torch.zeros(obj_p.bcsc.m, device=dev))
            del obj_p, r_p, captured["obj"]
            torch.cuda.empty_cache()
        say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

    # ------------------------------------------------------------------ 9. butterfly slice
    if "butterfly" in phases:
        PlainButterfly = plain_butterfly_class()

        def butterfly_solve(data, sources, what, expect_coarse, index_launches):
            """The solve, its counts, the plain-version and repeat checks."""
            res, n_launch, solve_s = solve(data, args.iters, True, layout="butterfly")
            calls = captured["calls"]
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
                index_bytes=bf.index_bytes(plan), index_build_s=f"{span_s('dualip.build.index'):.3f}")
            say(what, objective_build_s=f"{captured['build_s']:.2f}", layout_build_s=f"{span_s('dualip.build.rows'):.2f}",
                routing_s=f"{span_s('dualip.build.route'):.2f}", router=profiling.last("dualip.build.route").attrs["router"],
                run_solver_s=f"{solve_s:.2f}", peak_device_bytes=peak)
            ms_it = replay_ms(obj, torch.zeros(obj.bcsc.m, device=dev), iters=args.iters)
            say(what, iterations=len(res.dual_objective_log), ms_per_iteration=f"{ms_it:.4f}",
                iterations_per_s=f"{1e3 / ms_it:.2f}", final_dual_objective=res.dual_objective)
            # K3/K4: one launch per evaluation, all tiles; K3t/K4t: the per-tile form, off the main path;
            # K5w/K7w: the window kernels building the index once, at pack time
            want = {"K3": args.iters, "K4": 1, "K3t": 0, "K4t": 0, "K5": 2 * evals, expect_coarse: 4 * evals,
                    "K5w": 2, "K7w": index_launches}
            want_calls = {"K3": graph_calls(1), "K4": 1, "K3t": 0, "K4t": 0, "K5": graph_calls(2, 1),
                          expect_coarse: graph_calls(4, 1), "K5w": 2, "K7w": index_launches}
            say(what, launches=n_launch, expected=want, wrapper_calls=calls, expected_calls=want_calls,
                note="launches: the profiler's records on the card; wrapper calls: iteration 1 and the graph's "
                     "capture, then save_primal's evaluation")
            check_solution(res, obj, data, args.iters, what)
            for k, v in want.items():
                check(n_launch[k] == v, f"{what}: {k} launches {n_launch[k]} != {v}")
                check(calls[k] == want_calls[k], f"{what}: {k} wrapper calls {calls[k]} != {want_calls[k]}")
            check(n_launch["K1g"] == n_launch["K2g"] == n_launch["segsum"] == 0, f"{what}: the csc kernels ran: {n_launch}")
            log = np.asarray(res.dual_objective_log)
            plain_dev = rel_dev(first_iterations(variant(obj, PlainButterfly), obj.bcsc.m), log[:n_chk])
            say(what, plain_check_iterations=n_chk, max_rel_dev_vs_plain=float(plain_dev.max()), tolerance=1e-5)
            check(plain_dev.max() <= 1e-5, f"{what}: kernels vs plain versions differ by {plain_dev.max()} relative")
            res2, _, _ = solve(data, args.iters, False, objective_type="matching_smoke_prebuilt", profiled=False,
                               objective=obj)
            rep = rel_dev(res2.dual_objective_log, log)
            say(what, repeat_of_the_solve="bit-identical" if rep.max() == 0 else "DIFFERS", max_rel_dev=float(rep.max()))
            check(rep.max() == 0.0, f"{what}: two butterfly solves differ by {rep.max()} relative")
            return res, obj, n_launch, ms_it, calls

        res, obj, bfly_launches, bfly_ms, bfly_calls = butterfly_solve(inp, args.sources, "butterfly", "K7", 4)
        log = np.asarray(res.dual_objective_log)
        zeros_m = torch.zeros(obj.bcsc.m, device=dev)
        graph_check("butterfly", obj, zeros_m)
        dist_refs["butterfly"] = list(res.dual_objective_log)
        if csc_log is not None:
            vs_csc = rel_dev(log[:n_chk], csc_log[:n_chk])
            say("butterfly", max_rel_dev_vs_csc_first_iterations=float(vs_csc.max()), tolerance=1e-4,
                final_dual_csc=csc_log[-1], final_dual_butterfly=float(log[-1]))
            check(vs_csc.max() <= 1e-4, f"butterfly vs csc logs differ by {vs_csc.max()} relative")

        # Options on the same layout, 20 iterations each, timed.
        def timed_variant(name, objective):
            r, n_launch, _ = solve(inp, n_chk, False, objective_type="matching_smoke_prebuilt", objective=objective)
            ms_it = replay_ms(objective, zeros_m)
            dev_log = rel_dev(r.dual_objective_log, log[:n_chk])
            say("butterfly", option=repr(name), iterations=n_chk, ms_per_iteration=f"{ms_it:.4f}",
                max_rel_dev_vs_fp32_butterfly=float(dev_log.max()), launches=n_launch)
            return dev_log.max(), n_launch

        d, _ = timed_variant("carry_dtype=bfloat16", variant(obj, carry_dtype=torch.bfloat16))
        check(d <= 4e-2, f"bf16 carry drifts {d} relative from the fp32 carry")
        graph_check("butterfly carry_dtype=bfloat16", variant(obj, carry_dtype=torch.bfloat16), zeros_m)
        rl_gather = copy.copy(obj.row_layout)
        t0 = time.perf_counter()
        rl_gather.srow_colidx = route_row_ids(obj.row_layout, obj.bcsc.m)
        torch.cuda.synchronize()
        say("butterfly", srow_colidx_setup_s=f"{time.perf_counter() - t0:.3f}")
        d, n_launch = timed_variant("srow_gather=True", variant(obj, row_layout=rl_gather, srow_gather=True))
        check(d == 0.0, f"srow_gather is not bit-identical to the routed srow: {d}")
        check(n_launch["K5"] == n_chk, f"srow_gather: K5 launches {n_launch['K5']} != {n_chk} (reverse carry only)")
        graph_check("butterfly srow_gather", variant(obj, row_layout=rl_gather, srow_gather=True), zeros_m)
        del rl_gather

        # ---- each kernel timed at the slice's shapes
        rl, plan = obj.row_layout, obj.row_layout.plan
        N = plan.N
        nig = torch.full((), -1.0 / 1e-3, dtype=torch.float32, device=dev)
        buf = torch.from_numpy(np.random.default_rng(5).normal(size=N).astype(np.float32)).to(dev)
        ids = torch.arange(N, dtype=torch.int32, device=dev)

        def time_benes(name, replaces, fn, ref_fn, side_bytes, n_launches, n_calls, window_fn=None,
                       window_masks=None, variants=()):
            """ms of one launch group, the plain version's, the bound (8 B of
            payload and ``side_bytes`` of index or mask planes per slot), the
            payload-only floor, the library call (index_select by the group's
            own permutation) and, for a gather, its window form (the stage
            windows that build the index, reading ``window_masks``) and that
            form's bound in the same call; ``variants`` are (label, module
            attributes) timed beside it."""
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
                mask_bytes = window_masks.numel() * window_masks.element_size()
                say("timing", kernel=repr(name + " window form"), ms=f"{extra['window_ms']:.4f}",
                    bound_ms=f"{(N * 8 + mask_bytes) / PEAK_BYTES_PER_S * 1e3:.4f}", bound_by="bytes",
                    mask_bytes_per_slot=f"{mask_bytes / N:.3f}", slots=N)
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
                "launches": n_launches, "wrapper_calls": n_calls, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": "bytes", "library_ms": lib_ms, "payload_floor_ms": floor, **extra,
            })
            return ms

        k5_ms = time_benes(
            "K5 benes_fine", "dualip_tpu/ops/butterfly.py:520",
            lambda v: bf.benes_fine(v, plan.fine_masks, plan.fine_dists, src=plan.fine_src_fwd),
            lambda v: bf.benes_fine_reference(v, plan.fine_masks, plan.fine_dists),
            2, bfly_launches["K5"], bfly_calls["K5"],
            window_fn=lambda v: bf.benes_fine_window(v, plan.fine_masks, plan.fine_dists), window_masks=plan.fine_masks)
        (steps7, E7, R7), m7 = plan.pre_groups[0], plan.pre_masks[0]
        check(isinstance(E7, tuple), "the slice's coarse side is not a two-axis group")
        src7 = bf._direction(plan.pre_src[0], False)
        check(len(src7) == 1, "the slice's coarse side is not one gather launch")
        k7_ms = time_benes(
            "K7 benes_coarse2", "dualip_tpu/ops/butterfly.py:606",
            lambda v: bf.benes_coarse2(v, m7, steps7, *E7, R7, src7),
            lambda v: bf.benes_coarse2_reference(v, m7, steps7, *E7, R7),
            2, bfly_launches["K7"], bfly_calls["K7"],
            window_fn=lambda v: bf.benes_coarse2_window(v, m7, steps7, *E7, R7), window_masks=m7,
            variants=(("rows_32B", {"GATHER_ROW_BYTES": 32}),))  # 8 fp32 lanes, a 96 KB strip
        carry_src = bf.apply_butterfly_cuda(plan, ids.clone(), truncate=False)
        carry_ms = cuda_ms(lambda: bf.apply_butterfly_cuda(plan, buf, truncate=False), reps=10, graph=True).ms
        carry_lib_ms = cuda_ms(lambda: buf.index_select(0, carry_src), reps=5, graph=True).ms
        say("timing", whole_carry_ms=f"{carry_ms:.4f}", K5_plus_two_K7_ms=f"{k5_ms + 2 * k7_ms:.4f}",
            library_one_index_select_ms=f"{carry_lib_ms:.4f}", slots=N)
        del carry_src, ids

        time_panel("butterfly", obj, dev, kernels, panel_err, bfly_launches, bfly_calls)
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
        calls16 = captured["calls"]
        obj16 = captured["obj"]
        check(obj16.panel_table.tile_dtype == torch.bfloat16, "butterfly bf16 tiles: the panel table is not bf16")
        log16 = np.asarray(r16.dual_objective_log)
        plain16 = rel_dev(first_iterations(variant(obj16, PlainButterfly), obj16.bcsc.m), log16)
        vs32 = rel_dev(log16, log[:n_chk])
        say("butterfly", option="'dtype=bfloat16 (tiles)'", iterations=n_chk,
            ms_per_iteration=f"{replay_ms(obj16, torch.zeros(obj16.bcsc.m, device=dev)):.4f}",
            fp32_tiles_ms_per_iteration=f"{bfly_ms:.4f}",
            objective_build_s=f"{captured['build_s']:.2f}", max_rel_dev_vs_plain=float(plain16.max()),
            max_rel_dev_vs_fp32_tiles=float(vs32.max()), launches=n16, card=card)
        check(plain16.max() <= 1e-5, f"butterfly bf16 tiles: kernels vs plain versions differ by {plain16.max()}")
        check(vs32.max() <= 4e-2, f"butterfly bf16 tiles drift {vs32.max()} relative from the fp32 tiles")
        check(n16["K3"] == n_chk and n16["K4"] == 1, f"butterfly bf16 tiles: launches {n16}")
        graph_check("butterfly bf16 tiles", obj16, torch.zeros(obj16.bcsc.m, device=dev))
        time_panel("butterfly, bf16 tiles", obj16, dev, kernels, panel_err, n16, calls16)
        del obj16, r16, captured["obj"]
        torch.cuda.empty_cache()
        say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

        # ---- compact packing on the same data, 20 iterations
        r_c, n_launch, _ = solve(inp, n_chk, False, layout="butterfly", compact=True, keep_col_tiles=False,
                                 keep_flat_idx=False)
        obj_c = captured["obj"]
        rl_c = obj_c.row_layout
        d = rel_dev(r_c.dual_objective_log, log[:n_chk]).max()
        say("butterfly", option="'compact=True'", iterations=n_chk,
            ms_per_iteration=f"{replay_ms(obj_c, torch.zeros(obj_c.bcsc.m, device=dev)):.4f}",
            carry_slots=rl_c.plan.N, tiles=len(rl_c.col_tiles_T), row_tiles=len(rl_c.row_tiles),
            packs_L_L2_q=rl_c.col_pack, objective_build_s=f"{captured['build_s']:.2f}",
            routing_s=f"{span_s('dualip.build.route'):.2f}", max_rel_dev_vs_plain_panels=float(d), launches=n_launch)
        check(d <= 1e-4, f"compact packing drifts {d} relative from the plain panels")
        check(n_launch["K3"] == n_chk and n_launch["K3t"] == 0, f"compact: K3 launches {n_launch}, expected {n_chk}")
        graph_check("butterfly compact", obj_c, torch.zeros(obj_c.bcsc.m, device=dev))
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
        res_s, obj_s, small_launches, _, small_calls = butterfly_solve(small, SMALL_SOURCES, "butterfly-small", "K6", 0)
        plan = obj_s.row_layout.plan
        N = plan.N
        buf = torch.from_numpy(np.random.default_rng(6).normal(size=N).astype(np.float32)).to(dev)
        ids = torch.arange(N, dtype=torch.int32, device=dev)
        (steps6, E6, I6), m6 = plan.pre_groups[0], plan.pre_masks[0]
        time_benes(
            "K6 benes_coarse", "dualip_tpu/ops/butterfly.py:568",
            lambda v: bf.benes_coarse(v, m6, steps6, E6, I6),
            lambda v: bf.benes_coarse_reference(v, m6, steps6, E6, I6),
            m6.shape[0], small_launches["K6"], small_calls["K6"])
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
        phase_lp(dt, inp, card, captured, counts, reset_counts, profile_window, replay_ms, Timed, graph_check,
                 dist_refs)
        say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

    # ------------------------------------------------------------------ 12. examples
    if "examples" in phases:
        captured.pop("obj", None)
        torch.cuda.empty_cache()
        phase_examples(dev, card, counts, reset_counts, variant, Timed, n_chk, graph_check, replay_ms)
        say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

    # ------------------------------------------------------------------ 13. graph
    if "graph" in phases:
        # the golden solves ran through run_solver on the card: each on its own graph
        if golden is not None:
            say("graph", golden_solves_through_run_solver=golden[0], captured_graphs=golden[1],
                note="phase golden held each trace (1e-5; the bf16 carry at its own tolerance)")
            check(golden[0] == golden[1], f"graph: {golden[0]} golden solves captured {golden[1]} graphs")
        missing = [p for p in GRAPH_PATHS if p not in graph_rows]
        say("graph", paths_checked=list(graph_rows), paths_not_run=missing, card=card)
        check(not (full and missing), f"graph: paths not held to the eager loop: {missing}")
        say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

    # ------------------------------------------------------------------ 14. io
    if "io" in phases:
        phase_io(dt, args, card, gen_s, inp, captured, counts, solve, replay_ms, n_chk)
        say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

    # ------------------------------------------------------------------ 15. obs
    if "obs" in phases:
        phase_obs(dt, inp, card, captured, reset_counts, counts, n_chk, solver_kw)
        say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

    # ------------------------------------------------------------------ 16. dist
    if "dist" in phases:
        # the one-device logs, where phases slice and butterfly did not give them
        if "csc" not in dist_refs:
            dist_refs["csc"] = list(solve(inp, args.iters, False, profiled=False,
                                          use_pallas=True)[0].dual_objective_log)
        if "butterfly" not in dist_refs:
            dist_refs["butterfly"] = list(solve(inp, DIST_BUTTERFLY_ITERS, False, profiled=False, layout="butterfly")[0]
                                          .dual_objective_log)
        captured.pop("obj", None)
        torch.cuda.empty_cache()
        phase_dist(dt, args, inp, card, dev, dist_refs, solve, captured, replay_ms, graph_check)
        say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

    # ------------------------------------------------------------------ canonical (opt-in)
    if "canonical" in phases:
        phase_canonical(args, card, captured, solve, replay_ms, solver_kw)
        say("time", seconds_so_far=f"{time.perf_counter() - t_run:.1f}")

    say("profile", **PROFILER_TALLY, note="windows that lost records of their launches ran again")
    if not full:
        say("done", phases=phases, note="a partial run prints no result lines")
        return 0
    kernels.append(simplex_row)
    order = {n: i for i, n in enumerate(("K1", "K2", "K3", "K4", "K5", "K6", "K7", "segment_sum_rows",
                                         "simplex_project"))}
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
