"""layer_rows_ms: device ms of one AGD iteration's row layer (the segment-sum, or
the carry back and dense row sums), between the program's device marks
``columns`` and ``rows``, on average over the iterations of the traced calls.
It reads the program's store (``gpubench/program_store.py``), which the
profiler's window switches on; None where the program has none."""

from gpubench.program_store import mean_ms


def read(ctx):
    return mean_ms("dualip.iter.rows")
