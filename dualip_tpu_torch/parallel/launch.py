"""Spawned ranks on one host: the port's own launcher beside ``torchrun``.

``run_ranks(fn, world_size, ...)`` starts one process per rank
(``torch.multiprocessing``, spawn), initialises the default process group in
each over a free localhost port, calls ``fn(mesh, *args)`` with the rank's
``EntityMesh`` and returns each rank's result, in rank order.  A rank that
raises fails the whole run at once: the launcher stops the other ranks
instead of leaving them blocked in a collective, and raises with the failed
rank's traceback.  The group's ``timeout_s`` bounds each collective and
``join_timeout_s`` the whole run, so a hung rank fails too.

``fn`` must be importable by name (a module-level function): spawned
processes import it afresh.
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, port, fn, args, device, backend, timeout_s, threads, results):
    import torch.distributed as dist

    from dualip_tpu_torch.parallel.mesh import default_mesh, initialize_multihost

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size))
    if threads:
        torch.set_num_threads(threads)
    ok = False
    try:
        initialize_multihost(f"tcp://localhost:{port}", world_size, rank, device=device or "cuda",
                             backend=backend, timeout_s=timeout_s)
        mesh = default_mesh(world_size, device=device)
        out = fn(mesh, *args)
        results.put((rank, True, out))
        ok = True
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if ok and dist.is_initialized():
            dist.destroy_process_group()
    if not ok:
        results.close()
        results.join_thread()  # the traceback reaches the parent before the exit
        os._exit(1)  # no clean-up that could wait on a peer


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def run_ranks(
    fn: Callable,
    world_size: int,
    args: Sequence = (),
    device: Optional[str] = None,
    backend: Optional[str] = None,
    timeout_s: float = 60.0,
    join_timeout_s: float = 120.0,
    threads: Optional[int] = None,
) -> list:
    """``[fn(mesh_0, *args), ..., fn(mesh_{w-1}, *args)]`` from ``world_size``
    spawned ranks.  ``device``: every rank's device (``"cpu"``, or one card
    several gloo ranks share); ``None`` is ``cuda:<rank>``.  ``backend``
    defaults to NCCL on cuda and gloo on the CPU.  ``threads`` sets each
    rank's torch threads."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [
        ctx.Process(target=_rank_main, daemon=True,
                    args=(r, world_size, port, fn, tuple(args), device, backend, timeout_s, threads, results))
        for r in range(world_size)
    ]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + join_timeout_s
    try:
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(got))} did not finish "
                                   f"within {join_timeout_s} s")
            try:
                rank, ok, out = results.get(timeout=min(1.0, left))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                                       "and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        _stop(procs)
        results.close()
    return [got[r] for r in range(world_size)]
