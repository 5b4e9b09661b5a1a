"""LP input validation (``dualip_tpu/preprocessing/input_validation.py``),
numpy only.

Checks run on host-side inputs (dense numpy arrays or ``CSCMatrix``) before
any device transfer; the caller opts in (``run_solver`` does not run them).
"""

from __future__ import annotations

from typing import Union

import numpy as np

from dualip_tpu_torch.sparse.csc import CSCMatrix


class InputValidationError(ValueError):
    """Raised when any check fails (reference ``input_validation.py:4-5``)."""


def check_no_zero_row_or_col(input_tensor: Union[np.ndarray, CSCMatrix]) -> None:
    """Dense: no all-zero row or column.  CSC: every row has a stored value
    (reference ``input_validation.py:8-31``)."""
    if isinstance(input_tensor, CSCMatrix):
        row_counts = np.bincount(input_tensor.row_indices, minlength=input_tensor.shape[0])
        if (row_counts == 0).any():
            raise InputValidationError("There is an all-zero row in the input tensor")
    else:
        arr = np.asarray(input_tensor)
        if (np.linalg.norm(np.abs(arr), axis=0) == 0).any():
            raise InputValidationError("There is an all-zero column in the input tensor")
        if (np.linalg.norm(np.abs(arr), axis=1) == 0).any():
            raise InputValidationError("There is an all-zero row in the input tensor")


def check_nan_or_inf(input_tensor: Union[np.ndarray, CSCMatrix]) -> None:
    """Reference ``input_validation.py:34-47``."""
    vals = input_tensor.data if isinstance(input_tensor, CSCMatrix) else np.asarray(input_tensor)
    if (~np.isfinite(vals)).any():
        raise InputValidationError("The input tensor has nan or infinite values")


def check_correct_csc_construction(input_tensor: CSCMatrix) -> None:
    """Column pointers monotone; rows strictly increasing per column; no
    explicit zeros (reference ``input_validation.py:50-77``; vectorized)."""
    assert isinstance(input_tensor, CSCMatrix)
    ptr = np.asarray(input_tensor.indptr)
    rows = np.asarray(input_tensor.row_indices)

    if (ptr[:-1] > ptr[1:]).any():
        raise InputValidationError("ccol_indices must be non-decreasing")

    # rows strictly increasing within each column: any adjacent non-increase
    # whose pair lies inside one column is an error.
    if rows.size > 1:
        non_increasing = rows[:-1] >= rows[1:]
        # positions where a new column starts (pair straddles a boundary)
        boundary = np.zeros(rows.size - 1, dtype=bool)
        starts = ptr[1:-1]  # nnz offsets where columns begin (excluding 0 and nnz)
        boundary[starts[(starts > 0) & (starts < rows.size)] - 1] = True
        offenders = non_increasing & ~boundary
        if offenders.any():
            bad_pos = int(np.nonzero(offenders)[0][0]) + 1
            col = int(np.searchsorted(ptr, bad_pos, side="right")) - 1
            raise InputValidationError(f"row indices in column {col} are not strictly increasing")

    if (input_tensor.data == 0).any():
        raise InputValidationError("No zeroes are allowed in CSC values component")


def check_projection_map(projection_map, num_cols=None) -> None:
    """Validate a projection map (implements what the reference left as
    ``NotImplementedError``, ``input_validation.py:80-83``).

    Checks: every value is a ``ProjectionEntry`` with a registered
    ``proj_type``; indices are non-negative ints, unique within and across
    entries (a column owned by two entries would make the solve
    order-dependent), and within ``[0, num_cols)`` when ``num_cols`` is given;
    per-type parameter sanity (box/cone bound ordering, simplex ``z > 0``,
    known ``method``).
    """
    from dualip_tpu_torch.projections.base import ProjectionEntry, registered_projections

    if not isinstance(projection_map, dict) or not projection_map:
        raise InputValidationError("projection_map must be a non-empty dict")

    known = set(registered_projections())
    seen = {}
    for key, entry in projection_map.items():
        if not isinstance(entry, ProjectionEntry):
            raise InputValidationError(f"projection_map[{key!r}] is not a ProjectionEntry")
        if entry.proj_type not in known:
            raise InputValidationError(
                f"projection_map[{key!r}]: unknown proj_type {entry.proj_type!r} "
                f"(registered: {sorted(known)})"
            )
        params = dict(entry.proj_params or {})
        method = params.get("method")
        if method is not None and method not in ("duchi", "bisection_search"):
            raise InputValidationError(f"projection_map[{key!r}]: unknown method {method!r}")
        lo = params.get("lower", params.get("l"))
        hi = params.get("upper", params.get("u"))
        # NaN-coded bounds mean "absent" (schema defect §2.6.4 unification).
        lo = None if lo is not None and np.isnan(lo) else lo
        hi = None if hi is not None and np.isnan(hi) else hi
        if entry.proj_type == "box" and lo is not None and hi is not None and lo > hi:
            raise InputValidationError(f"projection_map[{key!r}]: box lower {lo} > upper {hi}")
        if entry.proj_type == "cone" and lo is not None and hi is not None:
            raise InputValidationError(f"projection_map[{key!r}]: cone takes only one bound")
        if entry.proj_type in ("simplex", "simplex_eq"):
            z = params.get("z", 1.0)
            if not np.isfinite(z) or z <= 0:
                raise InputValidationError(f"projection_map[{key!r}]: simplex z must be > 0, got {z}")
        if entry.proj_type in ("box_cut", "box_cut_eq"):
            if lo is None or hi is None:
                raise InputValidationError(
                    f"projection_map[{key!r}]: box_cut needs finite lower and upper bounds"
                )
            if lo > hi:
                raise InputValidationError(
                    f"projection_map[{key!r}]: box_cut lower {lo} > upper {hi}"
                )
            if method == "duchi":
                raise InputValidationError(
                    f"projection_map[{key!r}]: box_cut supports only bisection_search"
                )
            z = params.get("z", 1.0)
            if not np.isfinite(z):
                raise InputValidationError(f"projection_map[{key!r}]: box_cut z must be finite, got {z}")

        idx = np.asarray(entry.indices, dtype=np.int64).reshape(-1)
        if idx.size == 0:
            raise InputValidationError(f"projection_map[{key!r}] has no indices")
        if (idx < 0).any():
            raise InputValidationError(f"projection_map[{key!r}] has negative indices")
        if num_cols is not None and (idx >= num_cols).any():
            raise InputValidationError(
                f"projection_map[{key!r}] has indices >= num_cols ({num_cols})"
            )
        uniq, counts = np.unique(idx, return_counts=True)
        if (counts > 1).any():
            raise InputValidationError(f"projection_map[{key!r}] has duplicate indices")
        for prev_key, prev_idx in seen.items():
            if np.intersect1d(uniq, prev_idx, assume_unique=True).size:
                raise InputValidationError(
                    f"projection_map entries {prev_key!r} and {key!r} share column indices"
                )
        seen[key] = uniq


def run_all_checks(input_tensor: Union[np.ndarray, CSCMatrix]) -> None:
    """Aggregate check (reference ``input_validation.py:86-98``)."""
    if isinstance(input_tensor, CSCMatrix):
        check_correct_csc_construction(input_tensor)
    check_no_zero_row_or_col(input_tensor)
    check_nan_or_inf(input_tensor)
