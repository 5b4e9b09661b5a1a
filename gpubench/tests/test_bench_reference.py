"""The plain reference: DuaLip's 5x5 golden trace, and a float64 hand solve
of the same matching written with loops."""

import math

import numpy as np
import pytest
import torch

from gpubench.reference.matching import MatchingReference, project_simplex_ineq

# DuaLip's 5x5 matching test (users are columns: A = a.T, c = -a.T, b = 0.7)
A5 = np.array([
    [0.307766110869125, 0.483770735096186, 0.624996477039531, 0.669021712383255, 0.535811153938994],
    [0.257672501029447, 0.812402617651969, 0.882165518123657, 0.204612161964178, 0.710803845431656],
    [0.552322433330119, 0.370320537127554, 0.28035383997485, 0.357524853432551, 0.538348698290065],
    [0.0563831503968686, 0.546558595029637, 0.398487901547924, 0.359475114848465, 0.74897222686559],
    [0.468549283919856, 0.170262051047757, 0.76255108229816, 0.690290528349578, 0.420101450523362],
], dtype=np.float32)
GOLDEN = [(2, -3.6010155991401818), (16, -3.60842718733725), (23, -3.5080258013053136), (29, -3.4868496294227143)]
GAMMA, STEP0, MAX_STEP = 1e-3, 1e-5, 0.1


def csc_5x5():
    dense = A5.T  # (rows, columns)
    indptr = np.arange(0, 26, 5, dtype=np.int64)
    rows = np.tile(np.arange(5, dtype=np.int32), 5)
    a = dense.T.reshape(-1).astype(np.float32)  # column-major walk
    return indptr, rows, a, -a, np.full(5, 0.7, np.float32)


def reference(dtype=torch.float64):
    return MatchingReference(*csc_5x5(), gamma=GAMMA, radius=1.0, tol=1e-6, dtype=dtype, device="cpu")


def test_golden_trace():
    res = reference().agd_call(np.full(5, 0.1), 30, STEP0, MAX_STEP)
    for it, want in GOLDEN:
        assert abs(res.objectives[it - 1] - want) < 1e-5, (it, res.objectives[it - 1], want)


def hand_project(v, radius=1.0, tol=1e-6):
    v = np.maximum(v, 0.0)
    if v.sum() <= radius + tol:
        return v
    u = sorted(v, reverse=True)
    run, theta = 0.0, 0.0
    for k, uk in enumerate(u, 1):
        run += uk
        if uk - (run - radius) / k > 0:
            theta = (run - radius) / k
    return np.maximum(v - theta, 0.0)


def hand_solve(lam0, iterations):
    indptr, rows, a, c, b = csc_5x5()
    a, c, b = a.astype(np.float64), c.astype(np.float64), b.astype(np.float64)

    def evaluate(lam):
        ax, obj = np.zeros(5), 0.0
        for j in range(5):
            sl = slice(indptr[j], indptr[j + 1])
            x = hand_project(-(a[sl] * lam[rows[sl]] + c[sl]) / GAMMA)
            for r, v, cv, xv in zip(rows[sl], a[sl], c[sl], x):
                ax[r] += v * xv
                obj += cv * xv + GAMMA / 2 * xv * xv
        grad = ax - b
        return obj + lam @ grad, grad

    t = [0.0]
    for _ in range(iterations + 1):
        t.append((1 + math.sqrt(1 + 4 * t[-1] ** 2)) / 2)
    x = y = np.asarray(lam0, np.float64)
    hist, objs = [], []
    for i in range(iterations):
        obj, g = evaluate(x)
        objs.append(obj)
        hist = (hist + [(g, y)])[-15:]
        step = STEP0
        if len(hist) == 15:
            lips = [np.linalg.norm(hist[k + 1][0] - hist[k][0]) / np.linalg.norm(hist[k + 1][1] - hist[k][1])
                    for k in range(14)]
            if all(np.isfinite(lips)):
                step = min(1 / max(lips), MAX_STEP) if max(lips) > 0 else MAX_STEP
        y_new = np.maximum(x + step * g, 0)
        beta = (1 - t[i + 1]) / t[i + 2]
        x, y = y_new * (1 - beta) + y * beta, y_new
    return objs, y, g


def test_hand_solve():
    lam0 = np.array([0.1, 0.3, 0.0, 0.2, 0.05])
    objs, y, g = hand_solve(lam0, 40)
    res = reference().agd_call(lam0, 40, STEP0, MAX_STEP)
    assert np.allclose(res.objectives, objs, rtol=1e-12, atol=1e-12)
    assert np.allclose(res.dual.numpy(), y, rtol=1e-10, atol=1e-12)
    assert np.allclose(res.gradient.numpy(), g, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("width", [1, 3, 8, 64])
def test_projection(width):
    gen = np.random.default_rng(width)
    z = gen.normal(0.3, 1.0, size=(50, width))
    got = project_simplex_ineq(torch.as_tensor(z), 1.0, 1e-6).numpy()
    want = np.stack([hand_project(row) for row in z])
    assert np.allclose(got, want, atol=1e-12)


def test_bfloat16_control_departs():
    lam0 = np.full(5, 0.1)
    exact = reference().agd_call(lam0, 30, STEP0, MAX_STEP)
    low = reference(torch.bfloat16).agd_call(lam0, 30, STEP0, MAX_STEP)
    gap = max(abs(a - b) / abs(b) for a, b in zip(low.objectives, exact.objectives))
    assert gap > 1e-4


def test_sharded_equals_whole():
    """Shards of the columns, each summing ``(A x, c.x, x.x)`` over the
    shards once an evaluation, follow the whole problem's AGD to 1e-12."""
    import threading

    from gpubench.generators import upstream_synthetic

    params = {"num_sources": 4000, "num_destinations": 30, "target_sparsity": 0.1, "destination_seed": 42}
    d = {k: v.numpy() for k, v in upstream_synthetic.generate(params, 2**31 + 3, "cpu").items()}
    n, shards = d["indptr"].shape[0] - 1, 3
    lam0 = np.linspace(0.0, 0.2, 30)
    kw = dict(gamma=1e-3, radius=1.0, tol=1e-6, dtype=torch.float64, device="cpu")
    whole = MatchingReference(d["indptr"], d["rows"], d["a"], d["c"], d["b"], **kw).agd_call(lam0, 20, 1e-3, 0.1)

    meet, slots = threading.Barrier(shards), [None] * shards

    def reduce_of(r):
        def reduce(buf):  # every shard sums all shards' buffers in shard order: the same bits
            slots[r] = buf
            meet.wait()
            out = sum(slots[1:], slots[0].clone())
            meet.wait()
            return out

        return reduce

    got = [None] * shards

    def shard(r):
        lo, hi = r * n // shards, (r + 1) * n // shards
        s, e = int(d["indptr"][lo]), int(d["indptr"][hi])
        ref = MatchingReference(d["indptr"][lo:hi + 1] - s, d["rows"][s:e], d["a"][s:e], d["c"][s:e], d["b"],
                                reduce=reduce_of(r), **kw)
        got[r] = ref.agd_call(lam0, 20, 1e-3, 0.1)

    threads = [threading.Thread(target=shard, args=(r,)) for r in range(shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    for res in got:
        assert np.allclose(res.objectives, whole.objectives, rtol=1e-12, atol=0)
        assert torch.allclose(res.dual, whole.dual, rtol=1e-12, atol=1e-15)
        assert torch.allclose(res.gradient, whole.gradient, rtol=1e-12, atol=1e-15)
