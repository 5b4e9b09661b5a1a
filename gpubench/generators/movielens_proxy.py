"""A MovieLens-shaped ratings matrix at a stated size, in torch on the device.

The shape of the proxy that DuaLip's MovieLens example was validated on
(``examples/movielens_matching/proxy_validation.py``): movie popularity
Zipf-like with exponent ``zipf_exponent`` by rank, user activity lognormal
with ``sigma = activity_sigma``, ratings on the half-star grid with ml-20m's
marginal.  Here the size is the data set's own, so the pairs are unique and
every user has at least ``min_ratings``:

* user degrees: ``min_ratings`` plus the ``n_ratings - n_users * min_ratings``
  others shared in proportion to the lognormal's quantiles at ``(k + 0.5) /
  n_users`` (largest remainders to the largest fractions, so they sum to
  ``n_ratings``), dealt to the users in a seeded random order: every seed has
  the same degrees, so the same column shapes;
* each user's movies: ``degree`` distinct movies drawn with weights
  ``rank^-zipf_exponent`` without replacement (the smallest ``Exp(1) /
  weight`` keys), the ranks dealt to movie ids in a seeded random order;
* each rating: the half-star grid's inverse CDF at a uniform draw.

The LP is the example's: users are columns on a simplex, movies are rows with
``b = capacity``, ``a = 1`` and the cost ``c = -rating``.
"""

from __future__ import annotations

import math

import torch

USER_BLOCK = 2048  # users whose keys are sorted at once


def user_degrees(n_users: int, n_ratings: int, min_ratings: int, sigma: float) -> torch.Tensor:
    """The degrees in ascending order, (n_users,) int64, summing to ``n_ratings``."""
    q = (torch.arange(n_users, dtype=torch.float64) + 0.5) / n_users
    w = torch.exp(sigma * math.sqrt(2.0) * torch.erfinv(2 * q - 1))
    extra = n_ratings - n_users * min_ratings
    if extra < 0:
        raise ValueError(f"{n_ratings} ratings cannot give {n_users} users {min_ratings} each")
    share = extra * w / w.sum()
    base = torch.floor(share).to(torch.int64)
    rest = extra - int(base.sum())
    order = torch.argsort(share - base, descending=True, stable=True)
    base[order[:rest]] += 1
    return min_ratings + base


def generate(params: dict, seed: int, device) -> dict:
    """The CSC arrays on ``device``: ``indptr`` (n+1,) int64, ``rows`` (nnz,)
    int32, ``a`` and ``c`` (nnz,) float32, ``b`` (m,) float32."""
    dev = torch.device(device)
    n_users, n_movies = int(params["num_users"]), int(params["num_movies"])
    g = torch.Generator(device=dev).manual_seed(int(seed))

    deg_sorted = user_degrees(n_users, int(params["num_ratings"]), int(params["min_ratings"]),
                              float(params["activity_sigma"])).to(dev)
    if int(deg_sorted[-1]) > n_movies:
        raise ValueError(f"a user would rate {int(deg_sorted[-1])} of {n_movies} movies")
    deg = torch.empty_like(deg_sorted)
    deg[torch.randperm(n_users, generator=g, device=dev)] = deg_sorted
    weight = torch.empty(n_movies, dtype=torch.float32, device=dev)
    ranks = torch.arange(1, n_movies + 1, dtype=torch.float64, device=dev)
    weight[torch.randperm(n_movies, generator=g, device=dev)] = ranks.pow(-float(params["zipf_exponent"])).float()

    movies = []
    for u0 in range(0, n_users, USER_BLOCK):
        d = deg[u0:u0 + USER_BLOCK]
        keys = torch.empty(d.numel(), n_movies, device=dev).exponential_(generator=g) / weight
        picked = torch.sort(keys, dim=1).indices[:, :int(d.max())]
        movies.append(picked[torch.arange(picked.shape[1], device=dev)[None, :] < d[:, None]])
        del keys, picked
    users = torch.repeat_interleave(torch.arange(n_users, device=dev), deg)
    rows = torch.sort(users * n_movies + torch.cat(movies)).values % n_movies
    del users, movies

    grid = torch.tensor(params["rating_grid"], dtype=torch.float64, device=dev)
    pmf = torch.tensor(params["rating_pmf"], dtype=torch.float64, device=dev)
    cdf = torch.cumsum(pmf / pmf.sum(), 0)
    u = torch.rand(rows.numel(), dtype=torch.float64, device=dev, generator=g)
    rating = grid[torch.clamp_max(torch.searchsorted(cdf, u, right=True), grid.numel() - 1)]

    indptr = torch.zeros(n_users + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(deg, 0)
    return {"indptr": indptr, "rows": rows.to(torch.int32), "a": torch.ones(rows.numel(), device=dev),
            "c": (-rating).to(torch.float32),
            "b": torch.full((n_movies,), float(params["capacity"]), device=dev)}
