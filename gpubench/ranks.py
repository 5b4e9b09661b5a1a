"""Ranks: one process a card, for a cell whose ``chips`` is above 1.

``launch(target, spec, world, device, timeout_s)`` starts ``world``
processes of this file.  Each gets ``RANK``, ``LOCAL_RANK`` and
``WORLD_SIZE``, its card (``cuda:<rank>``, or the CPU), a default process
group (NCCL on cards, gloo on the CPU) for the program, a gloo group of the
harness's own, and calls ``target(Rank, spec)`` (``target`` names a
module-level function, ``"module:function"``).  The launch returns rank 0's
return value.

All ranks share one anonymous memory file (``memfd``) that the launch makes
and hands down: ``Rank.shared(nbytes)`` sizes and maps it, so what the ranks
write there (the generated problem) is held once on the host and read by
every rank without a copy of its own; it goes when the last rank ends.

A rank that raises, or is still running ``timeout_s`` after its start (it
then dumps its threads' stacks), ends the launch: the other ranks are
stopped, and ``RankFailed`` carries the failed rank's traceback.  A rank
dies with the launching process.
"""

from __future__ import annotations

import datetime
import json
import mmap
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
STOP_GRACE_S = 5.0  # from SIGTERM to SIGKILL when the launch stops its ranks
DUMP_GRACE_S = 30.0  # the launch's own deadline beyond the ranks' bound


class RankFailed(RuntimeError):
    """A rank raised, died, or outlived its bound; the message ends with its traceback."""


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + STOP_GRACE_S
    for p in procs:
        try:
            p.wait(max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(target: str, spec: dict, world: int, device: str, timeout_s: float):
    """Rank 0's ``target(rank, spec)`` after all ``world`` ranks returned;
    raises ``RankFailed`` when one fails or one outlives ``timeout_s``."""
    inputs_fd = os.memfd_create("gpubench-inputs")
    port = _free_port()
    procs, pipes, got, ended = [], [], {}, {}
    try:
        for r in range(world):
            read_fd, write_fd = os.pipe()
            pipes.append(read_fd)
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world))
            args = {"target": target, "spec": spec, "rank": r, "world": world, "device": device, "port": port,
                    "timeout_s": timeout_s, "result_fd": write_fd, "inputs_fd": inputs_fd, "parent": os.getpid()}
            procs.append(subprocess.Popen([sys.executable, str(HERE / "ranks.py"), json.dumps(args)],
                                          pass_fds=(inputs_fd, write_fd), env=env))
            os.close(write_fd)
    except BaseException:
        _stop(procs)
        raise
    finally:
        os.close(inputs_fd)  # the ranks hold it now

    def drain(r):
        chunks = []
        while True:
            chunk = os.read(pipes[r], 1 << 20)
            if not chunk:
                break
            chunks.append(chunk)
        got[r], ended[r] = b"".join(chunks), time.monotonic()  # a rank's pipe closes as it exits

    readers = [threading.Thread(target=drain, args=(r,), daemon=True) for r in range(world)]
    for t in readers:
        t.start()
    deadline = time.monotonic() + timeout_s + DUMP_GRACE_S
    first, late = None, False
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:  # the rank that ended first; the others failed on it
                time.sleep(0.05)
                first = min(bad, key=lambda r: ended.get(r, float("inf")))
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                first, late = codes.index(None), True
                break
            time.sleep(0.05)
    finally:
        _stop(procs)
        for t in readers:
            t.join(STOP_GRACE_S)
        for fd in pipes:
            os.close(fd)
    if first is not None:
        why = (f"still running {timeout_s + DUMP_GRACE_S:.0f} s after the start" if late
               else f"exit code {procs[first].returncode}, the first seen")
        def text(r, keep):
            return got.get(r, b"").decode(errors="replace").strip()[-keep:] or "(no traceback: see standard error)"

        texts = [f"--- rank {r} (exit code {p.returncode}):\n{text(r, 4000)}"
                 for r, p in enumerate(procs) if r != first and p.returncode not in (0, -signal.SIGTERM)]
        texts.append(f"--- rank {first}:\n{text(first, 8000)}")
        raise RankFailed(f"rank {first} of {world} failed ({why})\n" + "\n".join(texts))
    return pickle.loads(got[0])  # written by rank 0 of this launch, which exited 0


class Rank:
    """One rank's view: its number, the world, its device, and the harness's
    own gloo group (barriers, objects, and float64 sums on the host)."""

    def __init__(self, rank: int, world: int, device, group, inputs_fd: int):
        self.rank, self.world, self.device, self.group = rank, world, device, group
        self._inputs_fd = inputs_fd

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.group)

    def broadcast(self, obj):
        """Rank 0's ``obj`` on every rank."""
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def sum_(self, t):
        """``t`` (a CPU tensor) summed over the ranks, in place."""
        import torch.distributed as dist

        dist.all_reduce(t, group=self.group)
        return t

    def sum_float64(self, buf):
        """``buf`` summed over the ranks in float64 on the host, back in its
        dtype on its device: the reference's reduce hook."""
        import torch

        host = buf.to("cpu", torch.float64, copy=True)
        return self.sum_(host).to(buf.device, buf.dtype)

    def shared(self, nbytes: int) -> mmap.mmap:
        """The shared memory file, sized to ``nbytes`` by rank 0 and mapped
        by every rank, writable."""
        if self.rank == 0:
            os.ftruncate(self._inputs_fd, nbytes)
        self.barrier()
        return mmap.mmap(self._inputs_fd, nbytes)


def _die_with_parent(parent: int) -> None:
    """SIGKILL this process when its parent ends (Linux); end now if it has."""
    try:
        import ctypes

        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def _main(args: dict) -> int:
    import faulthandler
    import importlib

    _die_with_parent(args["parent"])
    rank, world, timeout_s = args["rank"], args["world"], float(args["timeout_s"])
    out = os.fdopen(args["result_fd"], "wb")
    faulthandler.dump_traceback_later(timeout_s, exit=True, file=out)
    try:
        import torch
        import torch.distributed as dist

        cuda = args["device"] == "cuda"
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the host's cores shared, not oversubscribed
        if cuda:
            torch.cuda.set_device(rank)
        # a collective waits past the bound, so a hung rank's own dump ends the launch, not its peers' timeouts
        timeout = datetime.timedelta(seconds=timeout_s + DUMP_GRACE_S)
        dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://localhost:{args['port']}",
                                world_size=world, rank=rank, timeout=timeout)
        group = dist.new_group(backend="gloo", timeout=timeout)
        module, name = args["target"].split(":")
        fn = getattr(importlib.import_module(module), name)
        ctx = Rank(rank, world, torch.device("cuda", rank) if cuda else torch.device("cpu"), group,
                   args["inputs_fd"])
        value = fn(ctx, args["spec"])
        dist.barrier(group=group)  # no rank tears down while another still reads
        dist.destroy_process_group()
    except BaseException:
        faulthandler.cancel_dump_traceback_later()
        text = traceback.format_exc()
        print(f"[gpubench rank {rank}] {text}", file=sys.stderr, flush=True)
        out.write(text.encode())
        out.flush()
        os._exit(1)  # no clean-up that could wait on a peer
    faulthandler.cancel_dump_traceback_later()
    out.write(pickle.dumps(value if rank == 0 else None))
    out.flush()
    sys.stderr.flush()
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(HERE.parent))  # the checkout: the port and ``gpubench``
    sys.exit(_main(json.loads(sys.argv[1])))
