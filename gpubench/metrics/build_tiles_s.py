"""build_tiles_s: host seconds of the objective's tile build, the program's span
``dualip.build.tiles`` (the pow2 tiles and, on the csc paths of the fused
kernel, their transpose), inside ``build_s``. It reads the program's store
(``gpubench/program_store.py``), which records the build's spans in every run;
None where the program has none."""

from gpubench.program_store import total_s


def read(ctx):
    return total_s("dualip.build.tiles")
