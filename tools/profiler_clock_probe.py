#!/usr/bin/env python3
"""How far ``torch.profiler``'s records of the card can be counted on one GPU.

    python3 tools/profiler_clock_probe.py [--seconds 240] [--out FILE]

Repeats short profiler windows for ``--seconds``: 50 eager launches of one
elementwise kernel, and 50 replays of a CUDA graph of 7 such kernels, each
under a profiler of the card alone and of the host and the card; 2 s of
matmuls between rounds keep the card busy.  For each window it compares the
host's launch events (``cudaLaunchKernel``, ``cudaGraphLaunch``) with the
card's records under the same correlation id: the records lost (a launch
with fewer records than it ran), and the lead of a record over its own launch
on the host's clock (a kernel cannot start before it is launched, so a lead
is an error of the profiler's clock conversion).  Each window is one JSON
line in ``--out``; the summary goes to standard output.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

EAGER, REPLAYS, GRAPH_KERNELS = 50, 50, 7


def window(kind: str, activities, x: torch.Tensor, graph: torch.cuda.CUDAGraph, t0: float) -> dict:
    torch.cuda.synchronize()
    prof = profile(activities=activities)
    prof.start()
    for _ in range(EAGER if kind == "eager" else REPLAYS):
        if kind == "eager":
            x.mul_(1.0000001)
        else:
            graph.replay()
    torch.cuda.synchronize()
    prof.stop()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    records: dict[int, list[int]] = {}
    for e in events:
        if e.device_type() == cuda:
            records.setdefault(e.correlation_id(), []).append(e.start_ns())
    launches = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() != cuda and ("LaunchKernel" in e.name() or "GraphLaunch" in e.name())}
    per_launch = 1 if kind == "eager" else GRAPH_KERNELS
    lost = sum(per_launch - len(records.get(c, ())) for c in launches)
    leads = [launches[c] - s for c, starts in records.items() if c in launches for s in starts]
    return {"t_s": round(time.perf_counter() - t0, 1), "kind": kind, "host_activity": len(activities) == 2,
            "launches": len(launches), "records": sum(map(len, records.values())), "records_lost": lost,
            "largest_lead_us": max(leads, default=0) / 1e3}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--out", default="profiler_clock_probe.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_clock_probe: no CUDA device")
        return 2
    dev = torch.device("cuda")
    x = torch.randn(1 << 20, device=dev)
    a = torch.randn(4096, 4096, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x * 2
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_KERNELS):
            y = x * 3  # noqa: F841
    rows, t0 = [], time.perf_counter()
    with open(args.out, "w") as out:
        while time.perf_counter() - t0 < args.seconds:
            for kind in ("eager", "graph"):
                for activities in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                    rows.append(window(kind, activities, x, graph, t0))
                    out.write(json.dumps(rows[-1]) + "\n")
            t = time.perf_counter()
            while time.perf_counter() - t < 2.0:
                for _ in range(20):
                    a @ a
                torch.cuda.synchronize()
    lost = [r for r in rows if r["records_lost"]]
    led = [r for r in rows if r["largest_lead_us"] > 0]
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "torch": torch.__version__, "seconds": args.seconds,
        "windows": len(rows), "windows_with_lost_records": len(lost),
        "records_lost": sum(r["records_lost"] for r in lost),
        "windows_that_lost_every_record": sum(r["records"] == 0 for r in rows),
        "windows_with_a_record_before_its_launch": len(led),
        "largest_lead_us": max((r["largest_lead_us"] for r in rows), default=0.0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
