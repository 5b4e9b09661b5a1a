"""build_rows_s: host seconds of the objective's row side, the program's span
``dualip.build.rows`` (the segment-sum's row plan on csc; the row layout with
its Benes routing and source index on butterfly), inside ``build_s``. It reads
the program's store (``gpubench/program_store.py``), which records the build's
spans in every run; None where the program has none."""

from gpubench.program_store import total_s


def read(ctx):
    return total_s("dualip.build.rows")
