"""build_s: the benchmark's host clock around ``build_objective`` (host tile
build, row plan or Benes routing, upload), ended by a synchronise."""


def read(ctx):
    return ctx.build_s
