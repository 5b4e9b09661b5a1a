"""call_host_ms: the host's own ms in one ``maximize`` call of the traced window:
the call's span ``dualip.agd.maximize`` less its children ``dualip.agd.replay``
(the chunks' graph launches) and ``dualip.agd.drain`` (the wait for the card,
with the fetch of the metrics and of the marks' table), on average: input
conversion, carry and graph lookup, result assembly. It reads the program's
store (``gpubench/program_store.py``), which the profiler's window switches on;
None where the program has none."""

from gpubench.program_store import call_host_ms


def read(ctx):
    return call_host_ms()
