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


@pytest.mark.parametrize("parts", [2, 3])
def test_parts_keep_the_law(parts):
    """``generate_part``: the parts split each destination's ``K_j`` of
    ``generate`` exactly, each part's columns are a CSC in its range with at
    most its share of each destination's edges (duplicates merged within the
    part), and ``b`` is the budget of the summed fixed-point loads."""
    gen = upstream_synthetic
    m, n = CANON["num_destinations"], CANON["num_sources"]
    _, _, counts, _, _ = gen.destination_side(CANON, "cpu")
    split = gen.part_counts(CANON, "cpu", parts)
    assert split.shape == (parts, m) and torch.equal(split.sum(0), counts) and bool((split >= 0).all())
    made = [gen.generate_part(CANON, BIG_SEED, "cpu", p, parts) for p in range(parts)]
    again = gen.generate_part(CANON, BIG_SEED, "cpu", parts - 1, parts)
    assert all(torch.equal(again[k], made[-1][k]) for k in again)
    for p, part in enumerate(made):
        lo, hi = gen.part_bounds(n, p, parts)
        d = host({k: v for k, v in part.items() if k != "load"} | {"b": torch.zeros(m)})
        check_csc(d, m, hi - lo)
        assert np.all(np.bincount(d["rows"], minlength=m) <= split[p].numpy())
        assert part["load"].dtype == torch.int64 and part["load"].shape == (m,)
    load = sum(part["load"] for part in made)
    _, _, _, rho, _ = gen.destination_side(CANON, "cpu")
    want = (rho * (load.to(torch.float64) / 2**32 + 1e-8)).to(torch.float32)
    assert torch.equal(gen.budget(CANON, load, "cpu"), want)
    other = gen.generate_part(CANON, BIG_SEED + 1, "cpu", 0, parts)
    assert not torch.equal(other["rows"], made[0]["rows"]) or not torch.equal(other["a"], made[0]["a"])


def test_whole_counts_are_the_split_total():
    """``generate`` draws the ``K_j`` that the parts split: its merged edges
    per destination are at most ``K_j``."""
    _, _, counts, _, _ = upstream_synthetic.destination_side(CANON, "cpu")
    d = host(upstream_synthetic.generate(CANON, BIG_SEED, "cpu"))
    assert np.all(np.bincount(d["rows"], minlength=CANON["num_destinations"]) <= counts.numpy())
