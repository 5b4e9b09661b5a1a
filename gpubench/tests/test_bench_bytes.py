"""The rooflines count the work of the problem: bytes from nnz, columns and
rows, never from the program's padded layout."""

import numpy as np
import pytest
from types import SimpleNamespace

from gpubench.core import load_module, BENCH
from gpubench import tracing

# a tiny CSC: 3 rows, 4 columns, columns of 2, 0, 3 and 1 nonzeros
INDPTR = np.array([0, 2, 2, 5, 6])
M, N, NNZ = 3, 4, 6


def metric(name):
    return load_module(BENCH / "metrics" / f"{name}.py", f"test_metric_{name}")


def test_hand_counts():
    counts = {"m": M, "n": N, "nnz": NNZ}
    # a, c, the dual value each nonzero sees and its a*x: 4 B each; a length per column
    assert metric("colproj_roofline_pct").bytes_per_iteration(**counts) == NNZ * (4 + 4 + 4 + 4) + N * 4 == 112
    # a*x and its index per nonzero, one sum per row
    assert metric("rowsum_roofline_pct").bytes_per_iteration(**counts) == NNZ * 8 + M * 4 == 60
    # two carries, each reading and writing one value a nonzero
    assert metric("carry_roofline_pct").bytes_per_iteration(**counts) == 2 * NNZ * 8 == 96


@pytest.mark.parametrize("name", ["colproj_roofline_pct", "rowsum_roofline_pct", "carry_roofline_pct"])
def test_padding_counts_nothing(name):
    """The port's csc tiles pad columns to pallas_block_k; doubling it doubles
    the slots but leaves the count and the share unchanged."""
    from dualip_tpu_torch.sparse import build_blockcsc, csc_from_arrays
    from dualip_tpu_torch.projections import create_projection_map

    rows = np.array([0, 2, 0, 1, 2, 1], np.int32)
    A = csc_from_arrays(INDPTR, rows, np.ones(NNZ, np.float32), (M, N))
    pm = create_projection_map("simplex", {"z": 1.0}, N)
    slots = [sum(t.rows.size for t in build_blockcsc(A, A, pm, pad_cols_to=p).tiles) for p in (8, 16)]
    assert slots[1] == 2 * slots[0]
    counts = {"m": A.shape[0], "n": A.shape[1], "nnz": A.nnz}
    mod = metric(name)
    record = [(pat.strip(r"\b").replace("(?i)", ""), 0.0, 2.0) for pat in mod.KERNELS[:1]]
    ctx = SimpleNamespace(problem=counts, iterations=1, device_kind="card", peaks={"card": {"hbm_bytes_per_s": 1e6}},
                          trace=SimpleNamespace(records=record))
    share = mod.read(ctx)
    assert share == pytest.approx(100.0 * mod.bytes_per_iteration(**counts) / 1e6 / 2e-6)
    assert mod.bytes_per_iteration(**counts) == metric(name).bytes_per_iteration(m=M, n=N, nnz=NNZ)


def test_no_record_no_reading():
    ctx = SimpleNamespace(problem={"m": M, "n": N, "nnz": NNZ}, iterations=1, device_kind="card",
                          peaks={"card": {"hbm_bytes_per_s": 1e6}}, trace=SimpleNamespace(records=[("other", 0, 1)]))
    for name in ("colproj_roofline_pct", "rowsum_roofline_pct", "carry_roofline_pct", "proj_sortscan_ms"):
        assert metric(name).read(ctx) is None
    assert metric("colproj_roofline_pct").read(SimpleNamespace(**{**vars(ctx), "device_kind": "unknown"})) is None


def test_trace_reduction():
    device = [("k1", 10.0, 20.0), ("k2", 15.0, 30.0), ("k1", 50.0, 60.0), ("lead", 0.0, 5.0)]
    host = [("gpubench.window", 8.0, 70.0), ("cudaGraphLaunch", 30.0, 45.0), ("aten::copy_", 60.0, 70.0)]
    t = tracing.reduce(device[:3], host, (8.0, 70.0))
    assert t.busy_s == pytest.approx(30e-6) and t.window_s == pytest.approx(62e-6)
    assert t.breakdown["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    names = dict(t.breakdown["idle_gaps"])
    assert names["cudaGraphLaunch"] == pytest.approx(20e-6) and names["aten::copy_"] == pytest.approx(10e-6)
