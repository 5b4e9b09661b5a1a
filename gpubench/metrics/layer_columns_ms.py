"""layer_columns_ms: device ms of one AGD iteration's column layer (the dual's
scaling and gather or carry-in, the projection, a*x), between the program's
device marks ``start`` and ``columns`` (its stamp kernels, ``csrc/marks.cu``),
on average over the iterations of the traced calls. It reads the program's
store (``gpubench/program_store.py``), which the profiler's window switches on;
None where the program has none."""

from gpubench.program_store import mean_ms


def read(ctx):
    return mean_ms("dualip.iter.columns")
