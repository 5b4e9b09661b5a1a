"""The result line: its keys, the traced run's breakdown, the checks last;
the command refuses without a card or without the program."""

import json
import shutil
import subprocess
import sys

from gpubench import core, tracing
from gpubench.tests.conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_untraced_line(tiny_root):
    res = core.run("ml20m-csc-fused", 2**31 + 7, 0.1, False, device="cpu", root=tiny_root)
    assert list(res) == KEYS + ["compared"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in res["compared"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(res))


def test_traced_line(tiny_root, monkeypatch):
    """The traced window's profiler needs the card; here it is replaced by one
    that runs the calls with the program's store on, as a running profiler
    switches it on, and returns made-up records.  The CPU has no device
    marks, so the three ``layer_*_ms`` read nothing here."""
    from dualip_tpu_torch.utils import profiling

    def fake(run, device, again=None):
        monkeypatch.setattr(profiling.STORE, "on", True)
        out = run()
        monkeypatch.setattr(profiling.STORE, "on", False)
        records = [("void column_kernel<true, false>(float*)", 0.0, 40.0), ("void add_rows(float*)", 40.0, 60.0),
                   ("elementwise_kernel", 70.0, 90.0)]
        return out, tracing.reduce(records, [("cudaGraphLaunch", 60.0, 70.0)], (0.0, 100.0))

    monkeypatch.setattr(tracing, "traced_window", fake)
    (tiny_root / "gpubench" / "peaks.json").write_text(json.dumps({"cpu": {"hbm_bytes_per_s": 1e12}}))
    res = core.run("canon25m-csc-fused", 3, 0.1, True, device="cpu", root=tiny_root)
    assert list(res) == KEYS + ["breakdown", "compared"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["per_layer"] if "canon25m-csc-fused" in m["workloads"]}
    assert set(res["metrics"]) == want - {"layer_columns_ms", "layer_rows_ms", "layer_step_ms"}
    assert res["metrics"]["call_host_ms"]["value"] > 0
    assert res["metrics"]["idle_pct"]["value"] == 100.0 * (1 - 80 / 100)


def command(cwd, *args):
    return subprocess.run([sys.executable, "gpubench/run.py", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_refuses_without_a_card():
    done = command(ROOT, "--workload", "canon25m-csc-fused", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert done.returncode != 0 and done.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    done = command(tmp_path, "--workload", "canon25m-csc-fused", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert done.returncode != 0 and done.stdout.strip() == ""
    assert "dualip_tpu_torch" in done.stderr


def test_window_keeps_the_drawn_and_last_calls():
    from types import SimpleNamespace

    def runner(start):
        return SimpleNamespace(start=start, dual=start + 1)

    drawn = []
    for seed in range(400):
        w = core.run_calls(runner, 0, seed, calls=5, device="cpu")
        assert (w.count, w.last.start) == (5, 4)
        drawn.append(w.picked.start)
    assert set(drawn) == {0, 1, 2, 3} and min(drawn.count(i) for i in range(4)) > 60
    assert core.run_calls(runner, 0, 1, calls=1, device="cpu").picked is None
