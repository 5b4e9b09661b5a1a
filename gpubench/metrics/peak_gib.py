"""peak_gib: ``torch.cuda.max_memory_allocated()`` after the window, the
count reset once the generated inputs were on the host, so it covers the
program's objective build, the warm-up and the window, in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
