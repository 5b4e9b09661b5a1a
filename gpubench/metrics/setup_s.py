"""setup_s: seconds from the process's start to the window's start: imports,
the kernels' build (a compile on a checkout's first run), the inputs' generation,
the objective's build and the warm-up call."""


def read(ctx):
    return ctx.setup_s
