"""iter_ms: the window's seconds (host clock, from the first call's start to
a synchronise after the last) over all the AGD iterations in it, in ms."""


def read(ctx):
    return ctx.window_s * 1e3 / ctx.iterations if ctx.iterations else None
