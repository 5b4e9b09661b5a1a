"""DuaLip's synthetic matching generator for a deployment too large for one
rank's host to build whole: the law, the streams and the parts of
``upstream_synthetic`` unchanged, behind one admission check.

Such a deployment (matching-canonical-250m: about 2.5e9 edges, 3.4e9 tile
slots) fits the host only where each rank builds the tiles of its own
columns (``build_blockcsc(..., shard=(rank, world))``).  A program without
that build makes every rank build the whole problem's tiles before slicing
out its own, about 68 GB a rank plus a transpose here, and four such ranks
exhaust the host's memory minutes into the run.  So ``generate`` and
``generate_part`` first ask the program for the rank-local build and raise
``RuntimeError`` where it has none: every rank ends at once, before it
draws, shares or builds anything.
"""

from __future__ import annotations

import inspect

from gpubench.generators.upstream_synthetic import budget, part_bounds  # noqa: F401  (the parts' law)
from gpubench.generators import upstream_synthetic


def require_local_build() -> None:
    """Raises unless the program's tile build takes ``shard``, a rank's columns."""
    from dualip_tpu_torch.sparse.bcsc import build_blockcsc

    if "shard" not in inspect.signature(build_blockcsc).parameters:
        raise RuntimeError("this deployment needs the program's rank-local tile build "
                           "(build_blockcsc(..., shard=(rank, world))); this program builds the whole "
                           "problem's tiles on every rank, more than the host holds")


def generate(params: dict, seed: int, device) -> dict:
    """``upstream_synthetic.generate``, after ``require_local_build``."""
    require_local_build()
    return upstream_synthetic.generate(params, seed, device)


def generate_part(params: dict, seed: int, device, part: int, parts: int) -> dict:
    """``upstream_synthetic.generate_part``, after ``require_local_build``."""
    require_local_build()
    return upstream_synthetic.generate_part(params, seed, device, part, parts)
