"""Host-side CSC container (``dualip_tpu/sparse/csc.py``), pure numpy.

Flat CSC lives only at the ingestion boundary; the device works on the
BlockCSC tiles of ``dualip_tpu_torch.sparse.bcsc``.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence, Tuple

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


def csc_to_dense(M: CSCMatrix) -> np.ndarray:
    m, n = M.shape
    out = np.zeros((m, n), dtype=M.data.dtype)
    out[M.row_indices, csc_col_ids(M)] = M.data
    return out


def csc_from_arrays(indptr, row_indices, data, shape) -> CSCMatrix:
    return CSCMatrix(
        indptr=np.asarray(indptr, dtype=np.int64),
        row_indices=np.asarray(row_indices, dtype=np.int32),
        data=np.asarray(data),
        shape=(int(shape[0]), int(shape[1])),
    )


def csc_from_scipy(S) -> CSCMatrix:
    """From any scipy sparse matrix (row indices sorted per column)."""
    S = S.tocsc()
    S.sort_indices()
    return csc_from_arrays(S.indptr, S.indices, S.data, S.shape)


def csc_col_ids(M: CSCMatrix) -> np.ndarray:
    """Column index of every stored nonzero."""
    return np.repeat(np.arange(M.shape[1]), M.col_lengths)


def same_pattern(A: CSCMatrix, B: CSCMatrix) -> bool:
    return (
        A.shape == B.shape
        and np.array_equal(A.indptr, B.indptr)
        and np.array_equal(A.row_indices, B.row_indices)
    )


def dot_product_csc(A: CSCMatrix, B: CSCMatrix) -> float:
    """``sum_ij A_ij * B_ij`` of two same-pattern matrices."""
    assert A.shape == B.shape, f"Expected equal shapes, got {A.shape} and {B.shape}"
    return float(np.dot(A.data, B.data))


def elementwise_csc(A: CSCMatrix, B: CSCMatrix, op: Callable) -> CSCMatrix:
    """``op`` elementwise over the shared sparsity pattern."""
    if not same_pattern(A, B):
        raise ValueError("A and B must share the same sparsity pattern")
    return A._replace(data=op(A.data, B.data))


def left_multiply_sparse(v: np.ndarray, M: CSCMatrix) -> CSCMatrix:
    """``diag(v) @ M``, the pattern kept."""
    return M._replace(data=M.data * np.asarray(v)[M.row_indices])


def right_multiply_sparse(M: CSCMatrix, v: np.ndarray) -> CSCMatrix:
    """``M @ diag(v)``, the pattern kept."""
    return M._replace(data=M.data * np.asarray(v)[csc_col_ids(M)])


def row_sums_csc(A: CSCMatrix) -> np.ndarray:
    """(m,) row sums."""
    return np.bincount(A.row_indices, weights=A.data, minlength=A.shape[0]).astype(A.data.dtype)


def row_norms_csc(A: CSCMatrix) -> np.ndarray:
    """(m,) row L2 norms, summed in float64."""
    sq = np.bincount(A.row_indices, weights=A.data.astype(np.float64) ** 2, minlength=A.shape[0])
    return np.sqrt(sq).astype(A.data.dtype)


def split_csc_by_cols(M: CSCMatrix, split_sizes: Sequence[int]) -> List[CSCMatrix]:
    """Contiguous column blocks of the given widths."""
    m, n = M.shape
    if sum(split_sizes) != n:
        raise ValueError(f"split_sizes must sum to {n}")
    blocks, col0 = [], 0
    for width in split_sizes:
        col1 = col0 + width
        s, e = int(M.indptr[col0]), int(M.indptr[col1])
        blocks.append(
            CSCMatrix(
                indptr=(M.indptr[col0 : col1 + 1] - M.indptr[col0]).copy(),
                row_indices=M.row_indices[s:e].copy(),
                data=M.data[s:e].copy(),
                shape=(m, width),
            )
        )
        col0 = col1
    return blocks


def hstack_csc(tensors: Sequence[CSCMatrix]) -> CSCMatrix:
    """Column-wise concatenation."""
    m = tensors[0].shape[0]
    for i, t in enumerate(tensors):
        if t.shape[0] != m:
            raise ValueError(f"matrix {i} has {t.shape[0]} rows, expected {m}")
    nnz_offsets = np.cumsum([0] + [t.nnz for t in tensors])
    indptr = np.concatenate(
        [tensors[0].indptr] + [t.indptr[1:] + off for t, off in zip(tensors[1:], nnz_offsets[1:])]
    )
    return CSCMatrix(
        indptr=indptr,
        row_indices=np.concatenate([t.row_indices for t in tensors]),
        data=np.concatenate([t.data for t in tensors]),
        shape=(m, sum(t.shape[1] for t in tensors)),
    )


def vstack_csc(tensors: Sequence[CSCMatrix]) -> CSCMatrix:
    """Row-wise stacking (one lexsort merge by column, then row)."""
    n = tensors[0].shape[1]
    for i, t in enumerate(tensors):
        if t.shape[1] != n:
            raise ValueError(f"matrix {i} has {t.shape[1]} columns, expected {n}")
    row_offsets = np.cumsum([0] + [t.shape[0] for t in tensors])
    all_cols = np.concatenate([csc_col_ids(t) for t in tensors])
    all_rows = np.concatenate([t.row_indices + off for t, off in zip(tensors, row_offsets)])
    all_data = np.concatenate([t.data for t in tensors])
    order = np.lexsort((all_rows, all_cols))
    counts = np.bincount(all_cols, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSCMatrix(
        indptr=indptr,
        row_indices=all_rows[order].astype(np.int32),
        data=all_data[order],
        shape=(int(row_offsets[-1]), n),
    )


def csc_matvec(A: CSCMatrix, x: np.ndarray) -> np.ndarray:
    """Dense ``A @ x`` on the host."""
    contrib = A.data * np.asarray(x)[csc_col_ids(A)]
    return np.bincount(A.row_indices, weights=contrib, minlength=A.shape[0]).astype(A.data.dtype)


def csc_rmatvec(A: CSCMatrix, y: np.ndarray) -> np.ndarray:
    """Dense ``A.T @ y`` on the host."""
    contrib = A.data * np.asarray(y)[A.row_indices]
    return np.bincount(csc_col_ids(A), weights=contrib, minlength=A.shape[1]).astype(A.data.dtype)
