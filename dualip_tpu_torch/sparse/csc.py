"""Host-side CSC container (``dualip_tpu/sparse/csc.py``), pure numpy.

Flat CSC lives only at the ingestion boundary; the device works on the
BlockCSC tiles of ``dualip_tpu_torch.sparse.bcsc``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class CSCMatrix(NamedTuple):
    """``indptr[(n+1)]``, ``row_indices[nnz]`` (sorted, unique per column),
    ``data[nnz]``, ``shape=(m, n)``."""

    indptr: np.ndarray
    row_indices: np.ndarray
    data: np.ndarray
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def col_lengths(self) -> np.ndarray:
        return self.indptr[1:] - self.indptr[:-1]


def csc_from_dense(dense: np.ndarray, dtype=np.float32) -> CSCMatrix:
    """CSC from a dense array, dropping exact zeros."""
    dense = np.asarray(dense)
    m, n = dense.shape
    nz_c, nz_r = np.nonzero(dense.T)  # column-major walk: (column, row) pairs
    counts = np.bincount(nz_c, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSCMatrix(
        indptr=indptr,
        row_indices=nz_r.astype(np.int32),
        data=dense.T[nz_c, nz_r].astype(dtype),
        shape=(m, n),
    )


def csc_from_arrays(indptr, row_indices, data, shape) -> CSCMatrix:
    return CSCMatrix(
        indptr=np.asarray(indptr, dtype=np.int64),
        row_indices=np.asarray(row_indices, dtype=np.int32),
        data=np.asarray(data),
        shape=(int(shape[0]), int(shape[1])),
    )


def csc_col_ids(M: CSCMatrix) -> np.ndarray:
    """Column index of every stored nonzero."""
    return np.repeat(np.arange(M.shape[1]), M.col_lengths)


def same_pattern(A: CSCMatrix, B: CSCMatrix) -> bool:
    return (
        A.shape == B.shape
        and np.array_equal(A.indptr, B.indptr)
        and np.array_equal(A.row_indices, B.row_indices)
    )
