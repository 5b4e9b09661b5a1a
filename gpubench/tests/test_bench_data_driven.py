"""A configuration, a cell and a metric added as files and entries of
BENCHMARK.json only, with no edit to a file that is there, are run."""

import json

from gpubench import core


def test_added_as_files(tiny_root):
    bench = tiny_root / "gpubench"
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}

    cfg = json.loads((tiny_root / spec["configs"][0]["file"]).read_text())
    cfg["name"], cfg["data"]["num_sources"] = "extra-config", 2000
    (bench / "configs" / "extra-config.json").write_text(json.dumps(cfg))
    (bench / "cells" / "extra-cell.json").write_text(json.dumps(
        {"iterations_per_call": 8, "trace_calls": 1, "limits": {"obj_gap": 1e-4, "dual_gap": 0.1, "grad_gap": 1e-3}}))
    (bench / "metrics" / "calls_made.py").write_text("def read(ctx):\n    return ctx.calls\n")
    spec["configs"].append({"name": "extra-config", "source": "a test", "file": "gpubench/configs/extra-config.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "extra-cell", "config": "extra-config", "traffic": "csc-default", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "calls_made", "unit": "calls", "better": "higher", "bound": 0.25,
                               "source": "host_clock", "workloads": ["extra-cell"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    res = core.run("extra-cell", 5, 0.1, False, device="cpu", root=tiny_root)
    assert res["correct"]
    assert res["metrics"]["calls_made"] == {"value": float(res["attempted"]), "unit": "calls"}
    assert set(res["metrics"]) == {"iter_ms", "setup_s", "calls_made"}  # peak_gib reads nothing off the card
    assert all(p.read_bytes() == b for p, b in before.items())
    other = core.run("canon25m-csc-default", 5, 0.1, False, device="cpu", root=tiny_root)
    assert "calls_made" not in other["metrics"]
