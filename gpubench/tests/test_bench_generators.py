"""The generators: the same seed gives the same inputs, and each hits its
configuration's counts (at a tiny size, on the CPU)."""

import numpy as np
import pytest
import torch

from gpubench.generators import movielens_proxy, upstream_synthetic

CANON = {"num_sources": 3000, "num_destinations": 40, "target_sparsity": 0.1, "destination_seed": 42}
ML = {"num_users": 300, "num_movies": 400, "num_ratings": 9000, "min_ratings": 20, "activity_sigma": 1.0,
      "zipf_exponent": 0.85, "rating_grid": [0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5, 5.0],
      "rating_pmf": [0.011, 0.036, 0.013, 0.066, 0.044, 0.212, 0.092, 0.266, 0.077, 0.183], "capacity": 30.0}
BIG_SEED = 2**31 + 12345


def host(arrays):
    return {k: v.numpy() for k, v in arrays.items()}


def check_csc(d, m, n):
    indptr, rows = d["indptr"], d["rows"]
    assert indptr.shape == (n + 1,) and indptr[0] == 0 and indptr[-1] == rows.shape[0]
    assert np.all(np.diff(indptr) >= 0)
    assert rows.dtype == np.int32 and rows.min() >= 0 and rows.max() < m
    col = np.repeat(np.arange(n), np.diff(indptr))
    key = col.astype(np.int64) * m + rows
    assert np.all(np.diff(key) > 0), "rows ascending and unique within each column"
    assert d["a"].shape == d["c"].shape == rows.shape and d["b"].shape == (m,)


@pytest.mark.parametrize("gen,params", [(upstream_synthetic, CANON), (movielens_proxy, ML)])
def test_same_seed_same_inputs(gen, params):
    one, two, other = (host(gen.generate(params, s, "cpu")) for s in (BIG_SEED, BIG_SEED, BIG_SEED + 1))
    for k in one:
        assert np.array_equal(one[k], two[k]), k
    assert not all(np.array_equal(one[k], other[k]) for k in one)


def test_canonical_counts():
    d = host(upstream_synthetic.generate(CANON, BIG_SEED, "cpu"))
    m, n = CANON["num_destinations"], CANON["num_sources"]
    check_csc(d, m, n)
    nnz = d["rows"].shape[0]
    assert abs(nnz - CANON["target_sparsity"] * m * n) < 0.1 * CANON["target_sparsity"] * m * n
    assert np.all(d["a"] > 0) and np.all(d["c"] < 0) and np.all(d["c"] >= -0.5) and np.all(d["b"] > 0)
    # the destination side comes from destination_seed: each row's edge draws are the same on every seed
    other = host(upstream_synthetic.generate(CANON, BIG_SEED + 7, "cpu"))
    per_row = [np.bincount(x["rows"], minlength=m) for x in (d, other)]
    assert np.abs(per_row[0] - per_row[1]).max() <= 0.05 * per_row[0].max()


def test_movielens_counts():
    d = host(movielens_proxy.generate(ML, BIG_SEED, "cpu"))
    m, n = ML["num_movies"], ML["num_users"]
    check_csc(d, m, n)
    deg = np.diff(d["indptr"])
    assert d["rows"].shape[0] == ML["num_ratings"] and deg.min() >= ML["min_ratings"]
    assert np.all(d["a"] == 1) and np.all(d["b"] == ML["capacity"])
    assert set(np.unique(-d["c"])) <= set(ML["rating_grid"])
    other = host(movielens_proxy.generate(ML, BIG_SEED + 1, "cpu"))
    assert np.array_equal(np.sort(deg), np.sort(np.diff(other["indptr"]))), "the same degrees on every seed"


def test_movielens_degrees_at_full_size():
    deg = movielens_proxy.user_degrees(138_493, 20_000_263, 20, 1.0)
    assert int(deg.sum()) == 20_000_263 and int(deg.min()) >= 20 and int(deg.max()) < 26_744
    assert torch.all(deg[1:] >= deg[:-1])
