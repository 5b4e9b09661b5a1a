"""Synthetic matching-LP generator, numpy only
(``benchmark/generate_synthetic_data.py::_generate_matching_numpy``).

Lognormal destination breadth/scale/value and source affinity, Poisson
per-destination degree, ``c = min(v_j u_i eps, 0.5)``, ``a = s_j c``, and
budgets ``b = U(0.5, 1) x`` the greedy per-source best-edge load.  The same
seed gives the same arrays as the benchmark generator's numpy backend.  Its
disk cache and native backends belong to the I/O slice of the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from dualip_tpu_torch.objectives.matching import MatchingInputArgs
from dualip_tpu_torch.projections import create_projection_map
from dualip_tpu_torch.sparse import csc_from_arrays


def _generate_matching_numpy(
    num_sources: int,
    num_destinations: int,
    target_sparsity: float,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Return (ccol_indices, row_indices, a_values, c_values, b_vec)."""
    if rng is None:
        rng = np.random.default_rng()

    n_src, n_dst = num_sources, num_destinations

    mu_p, sigma_p = 0.0, 1.0
    mu_s, sigma_s = 0.0, 1.0
    mu_v, sigma_v = -4.0, 0.75
    mu_u, sigma_u = 0.0, 0.5
    sigma_eps = 0.5
    c_max = 0.5

    avg_degree_per_source = target_sparsity * n_dst

    Z = rng.lognormal(mean=mu_p, sigma=sigma_p, size=n_dst)
    z_sum = Z.sum()
    if z_sum == 0:
        Z[:] = 1.0
        z_sum = float(n_dst)
    p = Z / z_sum * avg_degree_per_source

    s = rng.lognormal(mean=mu_s, sigma=sigma_s, size=n_dst)
    v = rng.lognormal(mean=mu_v, sigma=sigma_v, size=n_dst)
    u = rng.lognormal(mean=mu_u, sigma=sigma_u, size=n_src)

    K = np.minimum(rng.poisson(p * n_src), n_src)
    total = int(K.sum())
    if total == 0:
        raise ValueError("No edges generated; increase target_sparsity.")

    dest_ids = np.repeat(np.arange(n_dst, dtype=np.int64), K)
    source_ids = rng.integers(0, n_src, size=total, dtype=np.int64)

    # dedupe (dest, source) pairs
    key = np.unique(dest_ids * np.int64(n_src) + source_ids)
    dest_ids = (key // n_src).astype(np.int64)
    source_ids = (key % n_src).astype(np.int64)
    total = key.shape[0]
    del key

    eps_ij = rng.lognormal(mean=0.0, sigma=sigma_eps, size=total)
    c_values = np.minimum(v[dest_ids] * u[source_ids] * eps_ij, c_max)
    a_values = s[dest_ids] * c_values
    del eps_ij

    # CSC layout: sort by source (column), stable so rows stay sorted per column
    order = np.lexsort((dest_ids, source_ids))
    source_sorted = source_ids[order]
    row_indices = dest_ids[order]
    a_sorted = a_values[order]
    c_sorted = c_values[order]
    del order, dest_ids, source_ids, a_values, c_values

    counts = np.bincount(source_sorted, minlength=n_src)
    ccol_indices = np.zeros(n_src + 1, dtype=np.int64)
    np.cumsum(counts, out=ccol_indices[1:])

    # greedy per-source best-edge load (segmented argmax over columns)
    greedy_loads = np.zeros(n_dst, dtype=np.float64)
    nonempty = counts > 0
    if nonempty.any():
        seg_max = np.maximum.reduceat(a_sorted, ccol_indices[:-1][nonempty])
        col_of = np.repeat(np.arange(n_src), counts)
        is_max = a_sorted == seg_max[np.searchsorted(np.flatnonzero(nonempty), col_of)]
        cand = np.flatnonzero(is_max)
        _, first_idx = np.unique(col_of[cand], return_index=True)
        best_pos = cand[first_idx]
        np.add.at(greedy_loads, row_indices[best_pos], a_sorted[best_pos])

    rho = rng.uniform(0.5, 1.0, size=n_dst)
    b_vec = rho * (greedy_loads + 1e-8)

    return ccol_indices, row_indices, a_sorted, c_sorted, b_vec


def generate_synthetic_matching_input_args(
    num_sources: int,
    num_destinations: int,
    target_sparsity: float,
    dtype=np.float32,
    seed: Optional[int] = None,
) -> MatchingInputArgs:
    """MatchingInputArgs with ``c`` negated for minimization and one simplex
    ``z = 1`` projection entry over all sources (columns)."""
    rng = np.random.default_rng(seed)
    ccol, rows, a, c, b = _generate_matching_numpy(num_sources, num_destinations, target_sparsity, rng)
    shape = (num_destinations, num_sources)
    A = csc_from_arrays(ccol, rows, a.astype(dtype), shape)
    C = csc_from_arrays(ccol, rows, (-c).astype(dtype), shape)
    projection_map = create_projection_map("simplex", {"z": 1.0}, num_sources)
    return MatchingInputArgs(
        A=A, c=C, projection_map=projection_map, b_vec=b.astype(dtype), equality_mask=None
    )
