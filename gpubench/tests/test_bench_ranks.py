"""A multi-card cell on the CPU: two gloo ranks run the path that N cards
run with NCCL (``gpubench/ranks.py``, ``core.rank_run``): the inputs made in
parts and joined in shared memory, the program's sharded objective, the
window's calls on every rank, the reference sharded the same way.  Each test
adds its cells as files and entries of the tiny checkout's BENCHMARK.json."""

import json
import os
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from gpubench import core, faults, ranks

SEED = 2**31 + 4242
WHOLE = "from gpubench.generators.upstream_synthetic import generate  # noqa: F401  (no generate_part)\n"


def add_cell(root: Path, name: str, like: str, chips: int, config=None) -> None:
    """Cell ``name``: ``like``'s traffic and limits on ``chips`` ranks, of
    ``config`` (default ``like``'s)."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    base = next(w for w in spec["workloads"] if w["name"] == like)
    spec["workloads"].append(dict(base, name=name, chips=chips, config=config or base["config"]))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copy(root / "gpubench" / "cells" / f"{like}.json", root / "gpubench" / "cells" / f"{name}.json")


def add_config(root: Path, name: str, like: str, generator: str, source: str) -> None:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    base = next(c for c in spec["configs"] if c["name"] == like)
    cfg = json.loads((root / base["file"]).read_text())
    cfg["name"], cfg["generator"] = name, generator
    (root / "gpubench" / "generators" / f"{generator}.py").write_text(source)
    (root / "gpubench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    spec["configs"].append(dict(base, name=name, file=f"gpubench/configs/{name}.json"))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.mark.parametrize("like", ["canon25m-csc-fused", "canon25m-csc-default", "ml20m-butterfly"])
def test_world2_matches_world1(tiny_root, like):
    """The same problem (the whole generator on rank 0, shared) at world 2
    and world 1: both correct, and the warm-up call, which both start from
    zero, returns the same dual to float32's rounding of sums in another
    order.  Later calls start from each side's own last dual, which the
    step rule's 1/L steps move apart by far more than rounding: each is
    held to the float64 reference from its own start (``correct``)."""
    config = "canonical-whole"
    if like.startswith("canon"):
        add_config(tiny_root, config, "matching-canonical-25m", "upstream_whole", WHOLE)
    else:
        config = None
    add_cell(tiny_root, "one", like, 1, config)
    add_cell(tiny_root, "two", like, 2, config)
    one, two = (core.run(n, SEED, 0.0, False, device="cpu", root=tiny_root, calls=3, keep_checked=True)
                for n in ("one", "two"))
    assert one["correct"] and two["correct"], (one["compared"], two["compared"])
    assert two["device"]["count"] == 2 and two["attempted"] == one["attempted"] == 3
    assert list(two) == ["correct", "attempted", "failed", "metrics", "device", "checked", "compared"]
    assert set(two["checked"]) == set(one["checked"]) == {"warm-up", "drawn", "last"}
    y1, y2 = one["checked"]["warm-up"], two["checked"]["warm-up"]
    assert np.linalg.norm(y2 - y1) <= 1e-5 * np.linalg.norm(y1)


def test_parts_joined_once(tiny_root):
    """Inputs made in parts: the joined CSC is well formed, each part's
    columns in their range, and b the budget of the summed loads."""
    add_cell(tiny_root, "two", "canon25m-csc-fused", 2)
    res = core.run("two", SEED, 0.0, False, device="cpu", root=tiny_root, calls=1)
    assert res["correct"] and res["attempted"] == 1


@pytest.mark.parametrize("fault", sorted(faults.ALL))
def test_faults_fail_at_world2(tiny_root, fault):
    add_cell(tiny_root, "two", "canon25m-csc-fused", 2)
    res = core.run("two", SEED, 0.0, False, device="cpu", root=tiny_root, calls=2, fault=fault)
    assert not res["correct"], res["compared"]


def test_control_fails_at_world2(tiny_root):
    add_cell(tiny_root, "two", "canon25m-csc-fused", 2)
    for spec in core.Cell("two", tiny_root).traffic["controls"]:
        res = core.run("two", SEED, 0.0, False, device="cpu", root=tiny_root, calls=2, control=spec)
        assert not res["correct"] and res["failed"] >= 1, spec["name"]


def test_lost_rank_part_needs_ranks():
    assert "lost_rank_part" in faults.RANK_FAULTS and "lost_rank_part" not in faults.FAULTS


def rank_children():
    """Live processes started from this one that run a rank."""
    out = []
    for task in Path(f"/proc/{os.getpid()}/task").iterdir():
        for pid in (task / "children").read_text().split():
            try:
                cmd = Path(f"/proc/{pid}/cmdline").read_bytes()
            except OSError:
                continue
            if b"ranks.py" in cmd:
                out.append(int(pid))
    return out


BROKEN = '''
import time
from gpubench.generators.upstream_synthetic import budget  # noqa: F401
from gpubench.generators import upstream_synthetic


def generate_part(params, seed, device, part, parts):
    if part == 1 and params["fail"] == "raise":
        raise RuntimeError("part 1 cannot be made")
    if part == 1:
        time.sleep(3600)
    return upstream_synthetic.generate_part(params, seed, device, part, parts)
'''


@pytest.mark.parametrize("how", ["raise", "hang"])
def test_failing_rank_ends_the_run(tiny_root, how):
    """A rank that raises, or hangs past its bound, ends the run with its
    traceback, within the bound, and leaves no rank running."""
    add_config(tiny_root, "broken", "matching-canonical-25m", "broken", BROKEN)
    cfg_path = tiny_root / "gpubench" / "configs" / "broken.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["data"]["fail"] = how
    cfg_path.write_text(json.dumps(cfg))
    add_cell(tiny_root, "two", "canon25m-csc-fused", 2, "broken")
    bound = 20.0
    t0 = time.monotonic()
    with pytest.raises(ranks.RankFailed) as err:
        core.run("two", SEED, 0.0, False, device="cpu", root=tiny_root, calls=1, rank_timeout_s=bound)
    assert time.monotonic() - t0 < bound + ranks.DUMP_GRACE_S
    text = str(err.value)
    assert "rank 1 of 2 failed" in text
    assert ("part 1 cannot be made" in text) if how == "raise" else ("time.sleep" in text or "generate_part" in text)
    assert rank_children() == []
