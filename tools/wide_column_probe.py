#!/usr/bin/env python3
"""Where the time of the fused kernels' wide columns goes, on one GPU.

    PYTHONPATH=<checkout> python3 tools/wide_column_probe.py --label NAME [--out FILE]

Times the port's K1 (``fused_tile_gather_eval_T``) and K3 (``fused_panel_project``,
one tile) at the MovieLens proxy's wide tile shapes (L = 64, 128, 255, 394 with
the proxy's column counts), with no real column (every column padding, length 0),
with the proxy's number of real columns first and padding after, and with every
column real: the first is the launch and the padding's writes, the step to the
second a few columns' latency, the step to the third the projection's
throughput.  Then K3 over a table of the 2.5M-source slice's five narrow tiles
(L = 2, 4, 8, 16, 29, all through the kernel's ring) with a float32 and a
bfloat16 carry, the path the wide columns must not slow.  The package is whichever ``dualip_tpu_torch`` comes
first on the path (``PYTHONPATH``), so one card can time two checkouts in
turns.  Each time is one CUDA graph of 20 calls replayed 20 times, per call,
so the host's launch gaps stay out of it.  One JSON line per case on standard
output (and in ``--out``), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.append(str(Path(__file__).resolve().parents[1]))  # after PYTHONPATH: the checkout named there wins

CALLS, REPLAYS = 20, 20
M = 26_744  # the proxy's destinations (rows): scaled's length
# (L, columns, real columns, previous bucket's L): the proxy's wide csc tiles and panel tiles
K1_TILES = [(128, 3072, 2076, 64), (255, 1024, 274, 128), (394, 1024, 19, 255)]
K3_TILES = [(64, 10240, 9343, 32), (128, 3072, 2076, 64), (255, 1024, 274, 128), (394, 1024, 19, 255)]
# the slice's panel tiles (L, buffer rows): 14,336, 270,336, 6,094,848, 25,575,424, 1,959,936 slots
SLICE_TILES = [(2, 56), (4, 528), (8, 5952), (16, 12488), (29, 528)]


def graph_ms(fn) -> float:
    """Device ms of one call of ``fn``: a CUDA graph of CALLS calls, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(CALLS):
            fn()
    g.replay()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(REPLAYS):
        g.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / (CALLS * REPLAYS)


def lengths(rng, n, real, lo, hi):
    """Column lengths: the first ``real`` in (lo, hi], the rest 0."""
    out = np.zeros(n, dtype=np.int32)
    out[:real] = rng.integers(lo + 1, hi + 1, size=real)
    return out


def k1_case(rng, dev, L, K, real, lo):
    from dualip_tpu_torch.ops.fused_matching import fused_tile_gather_eval_T

    length = lengths(rng, K, real, lo, L)
    mask = np.arange(L)[:, None] < length[None, :]
    a = np.where(mask, np.abs(rng.normal(size=(L, K))), 0).astype(np.float32)
    c = np.where(mask, -np.abs(rng.normal(size=(L, K))), 0).astype(np.float32)
    rows = torch.from_numpy(rng.integers(0, M, size=(L, K)).astype(np.int32)).to(dev)
    scaled = torch.from_numpy((-10.0 * np.abs(rng.normal(size=M))).astype(np.float32)).to(dev)
    t = [torch.from_numpy(v).to(dev) for v in (a, c, length)]
    nig = torch.full((), -10.0, device=dev)
    out = torch.empty((L, K), device=dev)
    return graph_ms(lambda: fused_tile_gather_eval_T(scaled, rows, *t, nig, "simplex", (("z", 1.0),),
                                                     block_k=min(K, 1024), out=out))


def panel_tile(rng, dev, L, cols, real, lo):
    from dualip_tpu_torch.sparse.rowmajor import PanelTile

    KP = -(-cols // 128)
    length = lengths(rng, KP * 128, real, lo, L).reshape(KP, 1, 128)
    mask = np.arange(L)[None, :, None] < length
    a = np.where(mask, np.abs(rng.normal(size=(KP, L, 128))), 0).astype(np.float32)
    c = np.where(mask, -np.abs(rng.normal(size=(KP, L, 128))), 0).astype(np.float32)
    return PanelTile(*(torch.from_numpy(v).to(dev) for v in (a, c, length)))


def k3_case(rng, dev, L, cols, real, lo):
    from dualip_tpu_torch.ops.fused_matching import fused_panel_project

    t = panel_tile(rng, dev, L, cols, real, lo)
    L2 = 1 << (L - 1).bit_length()
    buf = torch.randn(t.a.shape[0] * L2 * 128, device=dev) * 0.01
    nig = torch.full((), -10.0, device=dev)
    return graph_ms(lambda: fused_panel_project(buf, t.a, t.c, t.length, 0, "simplex", (("z", 1.0),),
                                                neg_inv_gamma=nig))


def slice_table_case(rng, dev, carry):
    from dualip_tpu_torch.ops.fused_matching import build_panel_table, fused_panel_project_tiles

    tiles, offsets, off = [], [], 0
    for L, KP in sorted(SLICE_TILES, key=lambda s: -s[0]):
        tiles.append(panel_tile(rng, dev, L, KP * 128, KP * 128 * 9 // 10, 0))
        offsets.append(off)
        off += KP * (1 << max(L - 1, 0).bit_length()) * 128
    table = build_panel_table(tiles, offsets, [None] * len(tiles), [("simplex", (("z", 1.0),))] * len(tiles))
    buf = (torch.randn(off, device=dev) * 0.01).to(carry)
    nig = torch.full((), -1000.0, device=dev)
    return graph_ms(lambda: fused_panel_project_tiles(buf, table, nig))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wide_column_probe: no CUDA device", file=sys.stderr)
        return 2
    import dualip_tpu_torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    rows = []

    def emit(**kv):
        kv.update(label=args.label, package=str(Path(dualip_tpu_torch.__file__).parent), card=card)
        rows.append(kv)
        print(json.dumps(kv), flush=True)

    for L, cols, proxy_real, lo in K1_TILES:
        for real in (0, proxy_real, cols):
            emit(kernel="K1", L=L, columns=cols, real=real, ms=k1_case(rng, dev, L, cols, real, lo))
    for L, cols, proxy_real, lo in K3_TILES:
        for real in (0, proxy_real, cols):
            emit(kernel="K3", L=L, columns=cols, real=real, ms=k3_case(rng, dev, L, cols, real, lo))
    for carry in (torch.float32, torch.bfloat16):
        emit(kernel="K3 slice table", carry=str(carry)[6:], tiles=SLICE_TILES, ms=slice_table_case(rng, dev, carry))
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
