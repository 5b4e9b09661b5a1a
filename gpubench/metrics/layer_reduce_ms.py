"""layer_reduce_ms: device ms of one AGD iteration's exchange between the ranks
of a sharded solve (the entity mesh's ``all_reduce`` of the gradient and two
scalars, and any wait there for the other ranks), between the program's device
marks ``rows`` and ``reduced``, on average over the iterations of the traced
calls on rank 0. It reads the program's store (``gpubench/program_store.py``),
which the profiler's window switches on; None where the program has no such
mark (one card, or a program without it)."""

from gpubench.program_store import mean_ms


def read(ctx):
    return mean_ms("dualip.iter.reduce")
