"""layer_step_ms: device ms of the rest of one AGD iteration (the objective's
finalize, the step-size rule, the momentum, the cone projection, the metrics
row and the graph's buffer copies), between the program's device marks ``rows``
and ``end``, on average over the iterations of the traced calls. It reads the
program's store (``gpubench/program_store.py``), which the profiler's window
switches on; None where the program has none."""

from gpubench.program_store import mean_ms


def read(ctx):
    return mean_ms("dualip.iter.step")
