"""MovieLens ratings -> matching LP, solved by the PyTorch/CUDA port
(``examples/movielens_matching/movies_lens_matching.py`` of the JAX package).

The same LP:

* users are columns i, movies are rows j; ``A[j,i] = 1`` for every observed
  (user, movie) pair; ``c[j,i] = -(scale*rating + shift)``; a duplicate
  (user, movie) pair keeps its best reward;
* per-movie capacity ``b_j = per_movie_capacity``; a ``simplex z=1``
  projection per user;
* snapshots as ``.npz`` + JSON files, the JAX package's own, so either
  package reads the other's; optional min-interaction filters;
* optional **fairness rows**: two extra constraints bounding the difference
  of two movie groups' mean exposure, solved by ``FairnessMatchingObjective``
  through ``run_solver(objective_type="movielens_fairness")``.

Run it as ``python -m dualip_tpu_torch.examples.movielens_matching.movies_lens_matching
--ratings_csv_path ratings.csv --run_solver`` (on ``cuda``; ``--device cpu``
runs on the CPU).
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dualip_tpu_torch.objectives.matching import (
    MatchingInputArgs,
    MatchingSolverDualObjectiveFunction,
    _finalize,
    _neg_inv_gamma,
    _scalar,
)
from dualip_tpu_torch.ops.segment_sum import segment_sum_rows
from dualip_tpu_torch.projections import create_projection_map
from dualip_tpu_torch.sparse.bcsc import flat_to_tiles_values, tile_valid_mask
from dualip_tpu_torch.sparse.csc import CSCMatrix, csc_from_arrays


@dataclass
class MovielensMatchingConfig:
    ratings_csv_path: str
    per_movie_capacity: float = 1.0
    rating_scale: float = 1.0
    rating_shift: float = 0.0
    min_user_interactions: int = 1
    min_movie_interactions: int = 1
    device: str = "cuda"  # where a solve of the prepared LP runs


def load_ratings_csv(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(userId, movieId, rating) arrays from a MovieLens ratings.csv."""
    data = np.genfromtxt(path, delimiter=",", skip_header=1, usecols=(0, 1, 2), dtype=np.float64)
    if data.ndim == 1:
        data = data[None, :]
    return data[:, 0].astype(np.int64), data[:, 1].astype(np.int64), data[:, 2]


def prepare_movielens_matching(
    config: MovielensMatchingConfig,
    ratings: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
) -> Tuple[MatchingInputArgs, Dict[int, int], Dict[int, int]]:
    """``(input_args, user_id_to_col, row_to_movie_id)`` from the ratings
    (read from ``config.ratings_csv_path`` when ``ratings`` is None)."""
    if ratings is None:
        ratings = load_ratings_csv(config.ratings_csv_path)
    users, movies, rating_vals = ratings

    if config.min_user_interactions > 1:
        uniq, counts = np.unique(users, return_counts=True)
        keep = np.isin(users, uniq[counts >= config.min_user_interactions])
        users, movies, rating_vals = users[keep], movies[keep], rating_vals[keep]
    if config.min_movie_interactions > 1:
        uniq, counts = np.unique(movies, return_counts=True)
        keep = np.isin(movies, uniq[counts >= config.min_movie_interactions])
        users, movies, rating_vals = users[keep], movies[keep], rating_vals[keep]

    unique_users = np.unique(users)
    unique_movies = np.unique(movies)
    cols = np.searchsorted(unique_users, users)
    rows = np.searchsorted(unique_movies, movies)
    n_cols, n_rows = len(unique_users), len(unique_movies)

    c_vals = -(config.rating_scale * rating_vals + config.rating_shift)

    # one entry per (user, movie): sorted by (key, c), the first of each key
    # is the best reward, and key order is CSC order
    key = cols * np.int64(n_rows) + rows
    order = np.lexsort((c_vals, key))
    key_sorted = key[order]
    first = np.ones(len(key_sorted), dtype=bool)
    first[1:] = key_sorted[1:] != key_sorted[:-1]
    sel = order[first]
    cols_f = cols[sel]
    rows_f = rows[sel]
    c_f = c_vals[sel].astype(np.float32)

    indptr = np.zeros(n_cols + 1, dtype=np.int64)
    np.cumsum(np.bincount(cols_f, minlength=n_cols), out=indptr[1:])

    A = csc_from_arrays(indptr, rows_f, np.ones(len(rows_f), np.float32), (n_rows, n_cols))
    C = csc_from_arrays(indptr, rows_f, c_f, (n_rows, n_cols))
    b_vec = np.full(n_rows, np.float32(config.per_movie_capacity))

    projection_map = create_projection_map("simplex", {"z": 1}, num_indices=n_cols)
    input_args = MatchingInputArgs(A=A, c=C, projection_map=projection_map, b_vec=b_vec, equality_mask=None)
    user_id_to_col = {int(u): i for i, u in enumerate(unique_users)}
    row_to_movie_id = {i: int(m) for i, m in enumerate(unique_movies)}
    return input_args, user_id_to_col, row_to_movie_id


def build_fairness_values(A: CSCMatrix, group_a_rows: Sequence[int], group_b_rows: Sequence[int]) -> np.ndarray:
    """Per-nonzero fairness coefficients f in A's pattern: ``+a/|A|`` on
    group A's rows, ``-a/|B|`` on group B's, 0 elsewhere, so the two fairness
    rows bound the difference of the groups' mean a-weighted exposure with no
    new primal variables."""
    in_a = np.isin(A.row_indices, np.asarray(group_a_rows, dtype=A.row_indices.dtype))
    in_b = np.isin(A.row_indices, np.asarray(group_b_rows, dtype=A.row_indices.dtype))
    sign = np.where(in_a, 1.0 / len(group_a_rows), np.where(in_b, -1.0 / len(group_b_rows), 0.0))
    return (sign * A.data).astype(np.float32)


@dataclass
class FairnessMatchingInputArgs(MatchingInputArgs):
    """``MatchingInputArgs`` plus the fairness groups; ``b_vec`` is extended
    to length m + 2, ``(b, delta, delta)``, so the dual (and ``run_solver``'s
    zero start) covers the two fairness rows."""

    group_a_rows: Tuple[int, ...] = ()
    group_b_rows: Tuple[int, ...] = ()


class FairnessMatchingObjective(MatchingSolverDualObjectiveFunction):
    """The matching objective with two group-fairness constraints:

        mean_{j in A} (Ax)_j - mean_{j in B} (Ax)_j <= delta     (dual lambda_m)
        mean_{j in B} (Ax)_j - mean_{j in A} (Ax)_j <= delta     (dual lambda_{m+1})

    The coefficients f share A's pattern: per nonzero, z gains
    ``f * (-1/gamma)(lambda_m - lambda_{m+1})``, and the two extra gradient
    entries are ``+-sum(f*x)``.  Per tile, on the plain csc path:
    ``z = a*scaled[rows] + f*smu + nig*c`` (three roundings, the JAX
    package's order), the registry projection masked to the valid lanes, and
    ``sum(f*x)``, ``sum(c*x)``, ``(gamma/2) sum(x^2)``; every tile's ``a*x``
    then goes through one fixed-order ``segment_sum_rows`` (the kernel on
    the card), so a solve repeats itself bit for bit.  csc layout only, as
    in the JAX package.
    """

    def __init__(self, input_args: FairnessMatchingInputArgs, gamma: float, **kw):
        if kw.get("layout", "csc") != "csc" or kw.get("use_pallas") or kw.get("mesh"):
            raise NotImplementedError("the fairness objective extends the plain csc layout")
        kw.pop("layout", None)
        b_ext = np.asarray(input_args.b_vec, dtype=np.float32)
        base_args = MatchingInputArgs(
            A=input_args.A, c=input_args.c, projection_map=input_args.projection_map,
            b_vec=b_ext[:-2], equality_mask=None,
        )
        super().__init__(base_args, gamma=gamma, **kw)
        f_flat = build_fairness_values(input_args.A, list(input_args.group_a_rows), list(input_args.group_b_rows))
        self.f_tiles = [torch.as_tensor(f, device=self.device) for f in flat_to_tiles_values(self.bcsc, f_flat)]
        self.b_ext = torch.as_tensor(b_ext, device=self.device)

    @property
    def params(self):
        return (self.bcsc, self.b_ext, self.f_tiles)

    def calculate_traceable(self, params, dual_val: torch.Tensor, gamma):
        bcsc, b_ext, f_tiles = params
        g = self.gamma if gamma is None else gamma
        dtype, dev = dual_val.dtype, dual_val.device
        nig = _neg_inv_gamma(g, dtype, dev)
        half_gamma = _scalar(g, dtype, dev) / 2
        scaled = nig * dual_val[:-2]
        smu = nig * (dual_val[-2] - dual_val[-1])
        zero = torch.zeros((), dtype=dtype, device=dev)

        gf = torch.zeros((), dtype=dtype, device=dev)
        dual_obj = torch.zeros((), dtype=dtype, device=dev)
        reg = torch.zeros((), dtype=dtype, device=dev)
        ax_parts = []
        for tile, spec, f in zip(bcsc.tiles, bcsc.specs, f_tiles):
            a, c = tile.a.to(dtype), tile.c.to(dtype)
            z = a * scaled.index_select(0, tile.rows.reshape(-1)).view(a.shape)
            z = z + f * smu
            z = z + nig * c
            x = spec.projection()(z)
            x = torch.where(tile_valid_mask(tile, spec.L), x, zero)
            ax_parts.append((a * x).reshape(-1))
            gf = gf + torch.sum(f * x)
            reg = reg + half_gamma * torch.sum(x * x)
            dual_obj = dual_obj + torch.sum(c * x)
        grad_rows = segment_sum_rows(torch.zeros(bcsc.m, dtype=dtype, device=dev), torch.cat(ax_parts), bcsc.row_sum)
        grad = torch.cat([grad_rows, gf.reshape(1), -gf.reshape(1)])
        return _finalize(grad, dual_obj, reg, dual_val, b_ext)

    def calculate(self, dual_val, gamma=None, save_primal=False, rank: int = 0, **kwargs):
        if save_primal:
            raise NotImplementedError("save_primal is not wired into the fairness objective")
        return super().calculate(dual_val, gamma=gamma, save_primal=False, rank=rank, **kwargs)


def make_fairness_input_args(
    input_args: MatchingInputArgs,
    group_a_rows: Sequence[int],
    group_b_rows: Sequence[int],
    tolerance: float = 0.0,
) -> FairnessMatchingInputArgs:
    """A matching problem extended by the two fairness rows (b' = (b, delta, delta))."""
    b_ext = np.concatenate([np.asarray(input_args.b_vec), np.float32([tolerance, tolerance])]).astype(np.float32)
    return FairnessMatchingInputArgs(
        A=input_args.A, c=input_args.c, projection_map=input_args.projection_map, b_vec=b_ext,
        equality_mask=None,
        group_a_rows=tuple(int(r) for r in group_a_rows),
        group_b_rows=tuple(int(r) for r in group_b_rows),
    )


def _register_fairness_objective():
    """``FairnessMatchingObjective`` in ``run_solver``'s registry under
    ``objective_type="movielens_fairness"``, on ``compute_args.host_device``."""
    from dualip_tpu_torch import register_objective
    from dualip_tpu_torch.run_solver import _OBJECTIVE_REGISTRY

    if "movielens_fairness" in _OBJECTIVE_REGISTRY:
        return

    @register_objective("movielens_fairness")
    def _factory(input_args, solver_args=None, compute_args=None, mesh=None, **kw):
        if mesh is not None:
            raise NotImplementedError("the fairness objective runs on one device")
        if compute_args is not None:
            kw.setdefault("device", compute_args.host_device)
        return FairnessMatchingObjective(input_args, gamma=solver_args.gamma, **kw)


def save_snapshot(input_args, out_prefix, user_id_to_col, row_to_movie_id) -> None:
    """``{out_prefix}.npz`` (A, c, b) and the two id maps as JSON."""
    A, C = input_args.A, input_args.c
    np.savez(
        f"{out_prefix}.npz",
        indptr=A.indptr,
        row_indices=A.row_indices,
        a_data=A.data,
        c_data=C.data,
        b_vec=np.asarray(input_args.b_vec),
        shape=np.asarray(A.shape),
    )
    Path(f"{out_prefix}_user_map.json").write_text(json.dumps(user_id_to_col))
    Path(f"{out_prefix}_row_to_movie.json").write_text(json.dumps(row_to_movie_id))


def load_snapshot(in_prefix):
    """``(input_args, user_id_to_col, row_to_movie_id)`` from ``save_snapshot``'s files."""
    with np.load(f"{in_prefix}.npz") as d:
        shape = tuple(d["shape"])
        A = csc_from_arrays(d["indptr"], d["row_indices"], d["a_data"], shape)
        C = csc_from_arrays(d["indptr"], d["row_indices"], d["c_data"], shape)
        b_vec = d["b_vec"]
    projection_map = create_projection_map("simplex", {"z": 1}, num_indices=shape[1])
    input_args = MatchingInputArgs(A=A, c=C, projection_map=projection_map, b_vec=b_vec, equality_mask=None)

    def ints(name):
        return {int(k): int(v) for k, v in json.loads(Path(f"{in_prefix}_{name}.json").read_text()).items()}

    return input_args, ints("user_map"), ints("row_to_movie")


def main(argv=None):
    parser = argparse.ArgumentParser(description="MovieLens ratings -> matching LP (PyTorch/CUDA solver).")
    parser.add_argument("--ratings_csv_path", type=str, default=None)
    parser.add_argument("--per_movie_capacity", type=float, default=30.0)
    parser.add_argument("--rating_scale", type=float, default=1.0)
    parser.add_argument("--rating_shift", type=float, default=0.0)
    parser.add_argument("--min_user_interactions", type=int, default=1)
    parser.add_argument("--min_movie_interactions", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda", help="cuda | cpu")
    parser.add_argument("--run_solver", action="store_true")
    parser.add_argument("--gamma", type=float, default=0.1)
    parser.add_argument("--max_iter", type=int, default=10000)
    parser.add_argument("--initial_step_size", type=float, default=1e-8)
    parser.add_argument("--max_step_size", type=float, default=1e-6)
    parser.add_argument("--out_prefix", type=str, default=None)
    parser.add_argument("--in_prefix", type=str, default=None)
    parser.add_argument("--fairness_group_a", type=str, default=None, help="comma-separated movie row ids")
    parser.add_argument("--fairness_group_b", type=str, default=None)
    parser.add_argument("--fairness_tolerance", type=float, default=0.0)
    args = parser.parse_args(argv)

    if args.in_prefix:
        input_args, user_map, row_to_movie = load_snapshot(args.in_prefix)
    else:
        if not args.ratings_csv_path:
            parser.error("--ratings_csv_path or --in_prefix is required")
        t0 = time.perf_counter()
        input_args, user_map, row_to_movie = prepare_movielens_matching(
            MovielensMatchingConfig(
                ratings_csv_path=args.ratings_csv_path,
                per_movie_capacity=args.per_movie_capacity,
                rating_scale=args.rating_scale,
                rating_shift=args.rating_shift,
                min_user_interactions=args.min_user_interactions,
                min_movie_interactions=args.min_movie_interactions,
                device=args.device,
            )
        )
        print(f"prepared in {time.perf_counter() - t0:.1f}s")

    objective_type = "matching"
    if args.fairness_group_a and args.fairness_group_b:
        ga = [int(x) for x in args.fairness_group_a.split(",")]
        gb = [int(x) for x in args.fairness_group_b.split(",")]
        input_args = make_fairness_input_args(input_args, ga, gb, args.fairness_tolerance)
        _register_fairness_objective()
        objective_type = "movielens_fairness"
        print(f"added 2 fairness rows (|A|={len(ga)}, |B|={len(gb)})")

    print(f"A shape: {input_args.A.shape}, nnz: {input_args.A.nnz}, b shape: {np.asarray(input_args.b_vec).shape}")

    if args.out_prefix:
        save_snapshot(input_args, args.out_prefix, user_map, row_to_movie)
        print(f"snapshot saved to {args.out_prefix}*")

    result = None
    if args.run_solver:
        from dualip_tpu_torch import ComputeArgs, ObjectiveArgs, SolverArgs, run_solver

        result = run_solver(
            input_args=input_args,
            solver_args=SolverArgs(
                gamma=args.gamma,
                max_iter=args.max_iter,
                initial_step_size=args.initial_step_size,
                max_step_size=args.max_step_size,
            ),
            compute_args=ComputeArgs(host_device=args.device),
            objective_args=ObjectiveArgs(objective_type=objective_type),
        )
        print("Dual objective:", result.dual_objective)
    return result


if __name__ == "__main__":
    main()
