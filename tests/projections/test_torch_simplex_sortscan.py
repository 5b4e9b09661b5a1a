"""The sort-and-scan simplex kernel of the port (``dualip_tpu_torch/ops/
simplex_project.py``, ``csrc/simplex_project.cu``): its plain version against
``duchi_project``'s torch ops on the CPU, the rule that sends rows to it and
its counters; on the card (marked ``card``) the kernel against its plain
version bit for bit, against the torch ops, and the default csc solve's graph
against its eager loop."""

import numpy as np
import pytest
import torch

from dualip_tpu_torch import ComputeArgs, ObjectiveArgs, SolverArgs, build_objective
from dualip_tpu_torch.objectives.matching import MatchingInputArgs
from dualip_tpu_torch.ops import simplex_project as sp
from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent
from dualip_tpu_torch.projections import create_projection_map, duchi_project
from dualip_tpu_torch.projections import simplex as simplex_mod
from dualip_tpu_torch.projections.simplex import SimplexEq, SimplexIneq
from dualip_tpu_torch.sparse import csc_from_dense
from dualip_tpu_torch.utils import profiling

TORCH_ROWS = "dualip.projections.duchi.torch_rows"
ENQUEUED = "dualip.ops.simplex_project.enqueued"
RADII = (1.0, 0.37, 3.0)
TOL = {torch.float64: 1e-12, torch.float32: 2e-6}  # fp32: a few ulps of the row's sum, other order of additions


@pytest.fixture
def store(monkeypatch):
    """A fresh store, tracing off, for the test's length."""
    fresh = profiling.Store()
    fresh.on = False
    monkeypatch.setattr(profiling, "STORE", fresh)
    return fresh


def _rows(L: int, rng, n: int = 96) -> np.ndarray:
    """Random rows of L lanes, and the edge cases: ties, all non-positive,
    all zero, trailing padding zeros, one dominant lane."""
    x = rng.normal(size=(n, L)) * rng.uniform(0.05, 4.0, size=(n, 1))
    x[0] = 0.0
    x[1] = -np.abs(x[1])
    x[2] = np.round(x[2] * 2) / 2  # ties
    x[3] = 0.25  # every lane tied
    x[4, L // 2:] = 0.0  # a column shorter than its tile
    x[5, L // 2:] = 0.0
    x[5, 0] = 9.0  # the vertex
    return x


def _both(x, z, inequality):
    return sp.simplex_project_reference(x, z, inequality), duchi_project(x, z, inequality)


@pytest.mark.parametrize("L", range(1, 65))
def test_plain_version_matches_duchi_project(L):
    rng = np.random.default_rng(L)
    rows = _rows(L, rng)
    for dtype, tol in TOL.items():
        x = torch.from_numpy(rows).to(dtype)
        scale = 1.0 + float(torch.clamp_min(x, 0).sum(-1).max())
        for z in RADII:
            for inequality in (False, True):
                got, want = _both(x, z, inequality)
                assert got.dtype == dtype
                err = float((got - want).abs().max())
                assert err <= tol * scale, (dtype, z, inequality, err)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("z", RADII)
def test_shortcut_either_side_of_one(dtype, z):
    """u_0/z - u_1/z just above 1 gives the vertex, just below (and at 1)
    Duchi's rule; both ways as duchi_project."""
    eps = torch.finfo(dtype).eps
    zt = torch.tensor(z, dtype=dtype)
    v1 = torch.tensor(0.3, dtype=dtype) * zt
    for gap in (1 + 8 * eps, 1.0, 1 - 8 * eps):
        v0 = (v1 / zt + torch.tensor(gap, dtype=dtype)) * zt
        x = torch.stack([v1, v0, v1 * 0.5, torch.zeros((), dtype=dtype)])[None, :]
        above = bool((x[0, 1] / zt - x[0, 0] / zt) > 1.0)
        vertex = torch.tensor([[0.0, z, 0.0, 0.0]], dtype=dtype)
        for inequality in (False, True):
            got, want = _both(x, z, inequality)
            assert torch.equal(got, want)
            if gap != 1.0:  # at 1 Duchi's rule itself gives the vertex, or rounds near it
                assert above == (gap > 1.0) and torch.equal(got, vertex) == above


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("z", RADII)
def test_inequality_pass_through_either_side_of_z_plus_tol(dtype, z):
    """A row whose clamped sum is z + tol passes through; one a step above is
    projected onto sum w = z."""
    bound = torch.tensor(z, dtype=dtype) + torch.tensor(1e-6, dtype=dtype)
    above = torch.nextafter(bound, torch.tensor(np.inf, dtype=dtype))
    for s, passes in ((bound, True), (above, False), (bound * 0.5, True), (bound * 2, False)):
        x = torch.stack([s * 0.5, s * 0.5, -s, torch.zeros((), dtype=dtype)])[None, :]
        got, want = _both(x, z, True)
        assert torch.equal(got, want)
        clamped = torch.clamp_min(x, 0)
        assert torch.equal(got, clamped) == passes
        if not passes:
            assert abs(float(got.sum()) - z) <= 4 * float(torch.finfo(dtype).eps) * z


def _special_rows(L: int, dtype) -> torch.Tensor:
    """Rows with a NaN (at the first, the middle and the last lane), with
    +inf once and twice, with -inf, and one finite row beside them."""
    rows = torch.full((7, L), 0.25, dtype=dtype)
    rows[0, 0] = rows[1, L // 2] = rows[2, L - 1] = float("nan")
    rows[3, L - 1] = float("inf")
    rows[4, 0] = rows[4, L - 1] = float("inf")
    rows[5, 0] = -float("inf")
    return rows


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L", [1, 2, 3, 5, 16, 33, 64])
def test_nan_and_inf_rows_as_duchi_project(dtype, L):
    """A row with a NaN comes out all NaN; infinities give the torch ops'
    NaNs and zeros, lane for lane."""
    x = _special_rows(L, dtype)
    for z in RADII:
        for inequality in (False, True):
            got, want = _both(x, z, inequality)
            torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
            assert bool(torch.isnan(got[:3]).all())
            assert not bool(torch.isnan(got[5:]).any())


@pytest.mark.parametrize("L", [1, 2, 3, 4, 7, 8, 16, 17, 31, 32, 33, 64])
def test_plain_version_matches_the_jax_package(L):
    """The plain version against the JAX package's ``duchi_project`` in
    float32, on the same rows: the edge cases of ``_rows``, rows either side
    of the vertex shortcut and of the inequality's pass-through, three radii."""
    import jax.numpy as jnp

    from dualip_tpu.projections.simplex import duchi_project as jax_duchi

    rng = np.random.default_rng(100 + L)
    base = _rows(L, rng).astype(np.float32)
    for z in RADII:
        extra = np.zeros((4, L), dtype=np.float32)
        extra[0, 0], extra[1, 0] = 1.25 * z, 0.75 * z  # one lane: the pass-through's two sides
        if L > 1:
            extra[2, :2] = (1.5 * z, 0.3 * z)  # the shortcut taken
            extra[3, :2] = (1.2 * z, 0.3 * z)  # and not
        x = np.concatenate([base, extra])
        scale = 1.0 + float(np.clip(x, 0, None).sum(-1).max())
        for inequality in (False, True):
            got = sp.simplex_project_reference(torch.from_numpy(x), z, inequality).numpy()
            want = np.asarray(jax_duchi(jnp.asarray(x), z, inequality))
            err = float(np.abs(got - want).max())
            assert err <= TOL[torch.float32] * scale, (z, inequality, err)


def test_takes_kernel():
    """The rule: CUDA, float32, 1 to 64 lanes; nothing else."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for L in (1, 2, 3, 16, 17, 33, 64):
        assert sp.takes_kernel(cuda, torch.float32, L)
        assert sp.takes_kernel("cuda:1", torch.float32, L)
        assert not sp.takes_kernel(cpu, torch.float32, L)
        assert not sp.takes_kernel(torch.device("meta"), torch.float32, L)
    for dtype in (torch.float64, torch.bfloat16, torch.float16):
        assert not sp.takes_kernel(cuda, dtype, 16)
    for L in (0, 65, 128, 394):
        assert not sp.takes_kernel(cuda, torch.float32, L)


def test_duchi_project_sends_what_the_rule_takes_to_the_wrapper(store, monkeypatch):
    calls = []

    def wrapper(x, z, inequality, tol):
        calls.append((tuple(x.shape), z, inequality, tol))
        return sp.simplex_project_reference(x, z, inequality, tol)

    monkeypatch.setattr(sp, "takes_kernel", lambda device, dtype, width: True)
    monkeypatch.setattr(sp, "simplex_project", wrapper)
    x = torch.from_numpy(_rows(16, np.random.default_rng(0))).float()
    got = SimplexIneq(z=2.0)(x)
    assert calls == [((96, 16), 2.0, True, 1e-6)]
    assert torch.equal(got, sp.simplex_project_reference(x, 2.0, True))
    assert profiling.counter(TORCH_ROWS) == 0


def test_torch_rows_counts_the_rows_the_kernel_does_not_take(store):
    """Off the CPU (here the meta device) rows the rule refuses run torch's
    ops and count; on the CPU nothing counts."""
    duchi_project(torch.empty(5, 80, device="meta"))
    assert profiling.counter(TORCH_ROWS) == 5
    duchi_project(torch.empty(3, 4, 16, dtype=torch.float64, device="meta"), inequality=True)
    assert profiling.counter(TORCH_ROWS) == 17
    duchi_project(torch.zeros(7, 16))
    SimplexEq()(torch.zeros(7, 90))
    assert profiling.counter(TORCH_ROWS) == 17
    assert profiling.counter(ENQUEUED) == 0


def test_bisection_never_takes_the_kernel(store, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("bisection_search reached the kernel")

    monkeypatch.setattr(sp, "takes_kernel", lambda device, dtype, width: True)
    monkeypatch.setattr(sp, "simplex_project", refuse)
    x = torch.from_numpy(_rows(8, np.random.default_rng(1))).float()
    w = SimplexEq(method="bisection_search")(x)
    assert torch.allclose(w.sum(-1), torch.ones(96), atol=1e-5)


def test_wrapper_runs_the_plain_version_on_the_cpu(store):
    x = torch.from_numpy(_rows(29, np.random.default_rng(2))).float()
    assert torch.equal(sp.simplex_project(x, 0.37, True), sp.simplex_project_reference(x, 0.37, True))
    assert profiling.counter(ENQUEUED) == 0


# ---------------------------------------------------------------------------
# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tiles(L, rng, dev):
    """(K, L) tiles: the edge-case rows, then random ones, a ragged count."""
    x = np.concatenate([_rows(L, rng), rng.normal(size=(4099, L)) * rng.uniform(0.05, 4.0, size=(4099, 1))])
    return torch.from_numpy(x.astype(np.float32)).to(dev)


@pytest.mark.card
def test_kernel_equals_its_plain_version_bit_for_bit(store):
    dev = _card()
    rng = np.random.default_rng(3)
    n = 0
    for L in range(1, 65):
        x = _tiles(L, rng, dev)
        views = [x, x.T.contiguous().T, x.reshape(-1)[1:1 + (x.numel() - L) // L * L].view(-1, L)]  # strided, unaligned
        for v in views:
            for z in RADII:
                for inequality in (False, True):
                    got = sp.simplex_project(v, z, inequality)
                    want = sp.simplex_project_reference(v, z, inequality)
                    assert torch.equal(got, want), (L, z, inequality, float((got - want).abs().max()))
                    n += 1
    assert profiling.counter(ENQUEUED) == n


@pytest.mark.card
def test_kernel_nan_and_inf_rows_as_its_plain_version(store):
    """NaN and infinite entries: the kernel's NaNs and numbers lane for lane
    those of its plain version and of the torch ops, at every L."""
    dev = _card()
    for L in range(1, 65):
        x = _special_rows(L, torch.float32).to(dev)
        for z in RADII:
            for inequality in (False, True):
                got = sp.simplex_project(x, z, inequality)
                for want in (sp.simplex_project_reference(x, z, inequality),
                             simplex_mod._duchi_torch(x, z, inequality, 1e-6)):
                    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
                assert bool(torch.isnan(got[:3]).all())


@pytest.mark.card
def test_kernel_within_fp32_of_the_torch_ops(store):
    dev = _card()
    rng = np.random.default_rng(4)
    for L in range(1, 65):
        x = _tiles(L, rng, dev)
        scale = 1.0 + float(torch.clamp_min(x, 0).sum(-1).max())
        for z in RADII:
            for inequality in (False, True):
                got = duchi_project(x, z, inequality)
                want = simplex_mod._duchi_torch(x, z, inequality, 1e-6)
                err = float((got - want).abs().max())
                assert err <= TOL[torch.float32] * scale, (L, z, inequality, err)
    assert profiling.counter(TORCH_ROWS) == 0
    duchi_project(torch.zeros(3, 65, device=dev))
    assert profiling.counter(TORCH_ROWS) == 3


@pytest.mark.card
def test_default_csc_graph_replays_the_eager_loop_bit_for_bit(store):
    """``run_solver``'s defaults (csc, no fused kernel) through the kernel:
    three graph-replayed calls, each the eager loop's bits."""
    dev = _card()
    rng = np.random.default_rng(5)
    m, n = 6, 300
    a = ((rng.random((m, n)) < 0.3) * rng.random((m, n))).astype(np.float32)
    problem = MatchingInputArgs(A=csc_from_dense(a), c=csc_from_dense(-a),
                                projection_map=create_projection_map("simplex", {"z": 1}, n),
                                b_vec=np.full(m, 3.0, np.float32))
    obj = build_objective(problem, SolverArgs(max_iter=5, gamma=1e-3), ComputeArgs(host_device="cuda"),
                          ObjectiveArgs(objective_type="matching", objective_kwargs={"layout": "csc"}))
    x0 = torch.zeros(m, device=dev)
    solver = AcceleratedGradientDescent(max_iter=12, gamma=1e-3, initial_step_size=1e-3, max_step_size=1e-1)
    eager = solver._maximize_eager(obj, x0)
    assert profiling.counter(ENQUEUED) > 0
    graph = [solver.maximize(obj, x0) for _ in range(3)]
    assert profiling.counter("dualip.agd.captures") == 1 and profiling.counter("dualip.agd.graph_reuse") == 2
    for g in graph:
        assert g.dual_objective_log == eager.dual_objective_log
        assert torch.equal(g.dual_val, eager.dual_val)
    assert profiling.counter(TORCH_ROWS) == 0
