"""The readings that a cell's limits are set from, on the card.

    python3 gpubench/control.py --workload <cell> --seeds 11,12,13 --calls 3

For each seed, in one process: the program's readings (the compared numbers of
a short window of ``--calls`` calls after the warm-up, as a benchmark run
takes them), then each control's, put in the program's place with the same
inputs and the same window: the traffic's ``controls``, each either the
program on its own lower-precision path or the plain reference computed in
bfloat16.  ``--sides`` also takes ``fault:<name>`` (the program with a fault
of ``faults.py`` planted) and ``reference:<dtype>`` (the plain reference in
that dtype in the program's place, a second witness beside the program), and
``--iterations`` sets the calls' length in place of the cell's.  Prints one
JSON line per seed and side.  A multi-card cell runs each side on its ranks,
the fault planted and the control built in every rank.  The benchmark's own
runs never run any of this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

_HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0] or ".").resolve() == _HERE:
    sys.path.pop(0)
sys.path.insert(0, str(_HERE.parent))

import torch  # noqa: E402

from gpubench import core, faults  # noqa: E402


def controls(cell) -> list:
    """The traffic's controls, each a dict with ``name``, ``kind`` and its
    arguments."""
    return list(cell.traffic["controls"])


def sides(cell, names: str) -> list:
    """(label, control spec or None, fault or None) for each of ``names``."""
    out = []
    for side in names.split(","):
        if side == "program":
            out.append(("program", None, None))
        elif side == "control":
            out += [(spec["name"], spec, None) for spec in controls(cell)]
        elif side.startswith("fault:"):
            fault = side.split(":", 1)[1]
            if fault not in faults.ALL:
                raise ValueError(f"no fault {fault!r} (has {sorted(faults.ALL)})")
            out.append((side, None, fault))
        elif side.startswith("reference:"):
            out.append((side, {"kind": "reference", "dtype": side.split(":", 1)[1]}, None))
        else:
            raise ValueError(f"unknown side {side!r}")
    return out


def readings(name: str, seed: int, calls: int, label: str, control=None, fault=None, iterations=None,
             device="cuda", root=core.ROOT) -> dict:
    res = core.run(name, seed, 0.0, False, device=device, root=root, control=control, fault=fault, calls=calls,
                   iterations=iterations)
    return {"workload": name, "seed": seed, "side": label, "iterations_per_call": iterations,
            "correct": res["correct"], "calls": res["attempted"],
            "compared": {k: v["value"] for k, v in res["compared"].items()},
            "iter_ms": res["metrics"].get("iter_ms", {}).get("value"),
            "device": res["device"]["kind"], "power_limit": res["device"].get("power_limit")}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--sides", default="program,control")
    p.add_argument("--iterations", type=int, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("refused: no CUDA device", file=sys.stderr)
        return 2
    plan = sides(core.Cell(args.workload), args.sides)
    for seed in (int(s) for s in args.seeds.split(",")):
        for label, control, fault in plan:
            print(json.dumps(readings(args.workload, seed, args.calls, label, control, fault, args.iterations)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
