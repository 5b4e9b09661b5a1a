"""The benchmark of ``dualip_tpu_torch``: one run of one cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  Prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and
``breakdown`` with ``--trace 1``), and last ``compared``: each number the
correctness check compared, beside its limit; those also end standard error.
Exits non-zero, printing no result, without a CUDA device (or with fewer than
the cell asks for), when a rank of a multi-card cell fails or hangs (its
traceback ends standard error), or when a module of JAX or of the JAX package
is loaded (in any rank).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

_HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0] or ".").resolve() == _HERE:
    sys.path.pop(0)  # the folder's own modules are imported as the package ``gpubench``
sys.path.insert(0, str(_HERE.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    try:
        import dualip_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"refused: the program is not importable: {e}", file=sys.stderr)
        return 2
    from gpubench import core, ranks

    try:
        result = core.run(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda",
                          from_process_start=True)
    except core.Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    except ranks.RankFailed as e:
        print(f"failed: {e}", file=sys.stderr)
        return 1
    loaded = core.forbidden_modules()
    if loaded:
        print(f"refused: modules of JAX or the JAX package are loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    d = result["device"]
    print(f"device: {d['kind']} x{d['count']}, power limit {d.get('power_limit', 'not read')}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared: {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
