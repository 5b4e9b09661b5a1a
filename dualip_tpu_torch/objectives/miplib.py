"""General-LP (MIPLIB-2017) dual objective and its PDLP convergence certificate
(``dualip_tpu/objectives/miplib.py``).

Per evaluation at the dual ``lambda``:

    z = (-1/gamma) (A^T lambda + c)  ->  x = indexed projections of z
    grad = A x - b;  obj = c.x + (gamma/2)|x|^2 + lambda.grad

A is dense (``torch.matmul``, as the JAX package leaves it to XLA) or sparse.
Sparse A runs on one of two layouts:

* ``layout="coo"``: the nonzeros as (row, column, value) triplets.  Both
  products gather and then sum by key with the port's fixed-order segment-sum
  (``ops/segment_sum.py``, a hand-written kernel on the card): ``A x`` keyed by
  row, ``A^T lambda`` keyed by column, each with a ``RowSumPlan`` built once on
  the host that takes the triplets as one tile of L = 1.  The JAX package's
  ``segment_sum`` repeats itself; float ``index_add_`` on the card would not.
* ``layout="butterfly"``: the matching objective's companion layout
  (``sparse/rowmajor.py``): column tiles and row tiles of the nonzeros joined by
  one Benes plan, carried by the Benes kernels (K5-K7, ``ops/butterfly.py``) on
  the card.  ``A^T lambda`` broadcasts lambda along each row, carries it to the
  column tiles and sums each column's lanes; ``A x`` spreads x over each
  column's lanes, carries ``a*x`` back and sums each row's lanes.

Optional Jacobi row scaling works on either, and ``invert_jacobi_precondition``
maps the solved dual back.  Bounds read either spelling (``l``/``u`` or
``lower``/``upper``).

With ``mesh`` (``parallel/mesh.py::EntityMesh``) A is split by variable
columns (``_ColShardedOps``, dense or sparse): each rank keeps its columns'
``A^T lambda``, z, projections and x to itself, and one ``all_reduce`` of
``(A x, c.x, |x|^2)`` per evaluation is all the ranks exchange, O(m) whatever
n is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from dualip_tpu_torch.objectives.base import BaseInputArgs, BaseObjective
from dualip_tpu_torch.projections.base import ProjectionEntry, project
from dualip_tpu_torch.sparse.bcsc import (
    build_row_sum_plan,
    host_tensor,
    is_bfloat16,
    put_row_sum_plan,
    round_bfloat16,
)
from dualip_tpu_torch.sparse.csc import CSCMatrix, csc_col_ids, row_norms_csc
from dualip_tpu_torch.types import ObjectiveResult, resolve_device


@dataclass
class MIPLIBInputArgs(BaseInputArgs):
    """``A`` ((m, n) dense array or host CSC), ``c`` (n,), ``b_vec`` (m,);
    rows are ``A x <= b`` except those ``equality_mask`` flags."""

    A: Union[np.ndarray, CSCMatrix]
    c: np.ndarray
    projection_map: Dict[str, ProjectionEntry]
    b_vec: np.ndarray
    equality_mask: Optional[np.ndarray] = None


def _host_values(x, dtype) -> np.ndarray:
    """Host float32 values of ``x`` in the objective's dtype: a bfloat16 dtype
    rounds them (the JAX package keeps bfloat16 inputs and computes in
    float32, which is the same arithmetic); float64 computes in float32, as
    the JAX package does with 64-bit types off."""
    x = np.asarray(x, dtype=np.float32)
    return round_bfloat16(x) if is_bfloat16(dtype) else x


class _DenseOps:
    """Dense A: two matrix products."""

    def __init__(self, A: np.ndarray, dtype, device):
        self._host = np.asarray(A)
        self.A = torch.as_tensor(_host_values(A, dtype), device=device)
        self.shape = self.A.shape

    def matvec(self, x: torch.Tensor) -> torch.Tensor:  # A @ x
        return self.A @ x

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:  # A.T @ y
        return self.A.T @ y

    def row_norms(self) -> np.ndarray:
        return np.linalg.norm(self._host, axis=1)


def _key_plan(keys: np.ndarray, n_keys: int, device):
    """The segment-sum's plan of the triplets as one tile of L = 1 (one slot
    per nonzero, in CSC order), summed by ``keys``; on ``device``."""
    k = np.ascontiguousarray(keys, dtype=np.int32).reshape(-1, 1)
    return put_row_sum_plan(build_row_sum_plan([k], [np.ones(k.shape[0], dtype=np.int32)], n_keys), device)


class _SparseOps:
    """COO A: gather, multiply, and the fixed-order segment-sum by key."""

    def __init__(self, A: CSCMatrix, dtype, device):
        self.shape = A.shape
        m, n = A.shape
        rows, cols = A.row_indices, csc_col_ids(A)
        self.rows = host_tensor(rows, device, torch.int32)
        self.cols = host_tensor(cols, device, torch.int32)
        self.vals = torch.as_tensor(_host_values(A.data, dtype), device=device)
        self.by_row = _key_plan(rows, m, device)  # A x
        self.by_col = _key_plan(cols, n, device)  # A^T y: CSC order is already by column
        self._host = A

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from dualip_tpu_torch.ops.segment_sum import segment_sum_rows

        v = self.vals * x.index_select(0, self.cols)
        return segment_sum_rows(torch.zeros(self.shape[0], dtype=v.dtype, device=v.device), v, self.by_row)

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        from dualip_tpu_torch.ops.segment_sum import segment_sum_rows

        v = self.vals * y.index_select(0, self.rows)
        return segment_sum_rows(torch.zeros(self.shape[1], dtype=v.dtype, device=v.device), v, self.by_col)

    def row_norms(self) -> np.ndarray:
        return row_norms_csc(self._host)


class _ButterflySparseOps:
    """Sparse A on the Benes companion layout (see the module's docstring).

    The column tiles are built with the identity projection over all
    variables (the bucketing needs a map; the objective's projections act on
    the (n,) vector), 1024 columns to a tile, no flat index kept."""

    def __init__(self, A: CSCMatrix, dtype, device, plan_cache_dir=None):
        from dualip_tpu_torch.sparse.bcsc import build_blockcsc
        from dualip_tpu_torch.sparse.rowmajor import build_row_layout

        self.shape = A.shape
        m, n = A.shape
        pm = {"all": ProjectionEntry("identity", {}, np.arange(n))}
        zeros_c = CSCMatrix(indptr=A.indptr, row_indices=A.row_indices, data=np.zeros_like(np.asarray(A.data)),
                            shape=A.shape)
        bcsc = build_blockcsc(A, zeros_c, pm, batching=True, pad_cols_to=1024, keep_flat_idx=False, dtype=dtype)
        self.rl = build_row_layout(bcsc, method="butterfly", plan_cache_dir=plan_cache_dir, device=device)
        # slot s of the per-column sums holds tile t's column k (tiles in
        # order); colpos maps a variable to its slot (the trailing zero for
        # a variable with no nonzeros)
        colpos = np.full(n, sum(int(t.col_ids.shape[0]) for t in bcsc.tiles), dtype=np.int64)
        ids, off = [], 0
        for t in bcsc.tiles:
            cid = np.asarray(t.col_ids)
            valid = cid >= 0
            colpos[cid[valid]] = off + np.nonzero(valid)[0]
            ids.append(np.maximum(cid, 0))  # a padding column reads x[0]; its a = 0
            off += cid.shape[0]
        self.colpos = host_tensor(colpos, device, torch.int32)
        self.col_ids_cat = host_tensor(np.concatenate(ids), device, torch.int32)
        self._host = A

    def _geometry(self):
        """(panel tile, region offset, KP, L, L2) of every column tile."""
        for pt, off in zip(self.rl.col_tiles_T, self.rl.col_offsets):
            KP, L, _ = pt.a.shape
            yield pt, off, KP, L, (1 << max(L - 1, 0).bit_length()) if L > 1 else 1

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        from dualip_tpu_torch.objectives.matching import _srow_carried

        zero = torch.zeros((), dtype=y.dtype, device=y.device)
        t_col = _srow_carried(self.rl, y, zero)  # y broadcast along each row's lanes, in column space
        sums = []
        for pt, off, KP, L, L2 in self._geometry():
            region = t_col[off : off + KP * L2 * 128].view(KP, L2, 128)
            sums.append(torch.sum(pt.a * region[:, :L, :], dim=1).reshape(-1))
        return torch.cat(sums + [zero.reshape(1)]).index_select(0, self.colpos)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from dualip_tpu_torch.objectives.matching import _carry, _plan_size

        rl = self.rl
        xg = x.index_select(0, self.col_ids_cat)  # one value per column slot
        buf = torch.zeros(_plan_size(rl.plan), dtype=x.dtype, device=x.device)  # ghost lanes stay zero
        k = 0
        for pt, off, KP, L, L2 in self._geometry():
            region = buf[off : off + KP * L2 * 128].view(KP, L2, 128)
            region[:, :L, :] = pt.a * xg[k : k + KP * 128].view(KP, 1, 128)
            k += KP * 128
        u_row = _carry(rl, buf, reverse=True)
        sums, off = [], 0
        for R, Lr in rl.row_shapes:
            sums.append(torch.sum(u_row[off : off + R * Lr].view(R, Lr), dim=1))
            off += R * Lr
        zero = torch.zeros(1, dtype=x.dtype, device=x.device)
        return torch.cat(sums + [zero]).index_select(0, rl.row_pos)

    def row_norms(self) -> np.ndarray:
        return row_norms_csc(self._host)


class _ColShardedOps:
    """A split by variable columns over a mesh (``dualip_tpu/objectives/
    miplib.py::_ColShardedSparseOps``, here for dense A too): rank s holds
    columns ``[bounds[s], bounds[s+1])`` of A (COO through the fixed-order
    segment-sum, or a dense block), of c, and of every projection entry.

    An elementwise projection (box, cone, identity) may span shards; a joint
    one (the simplex family couples its coordinates through a sum) must lie
    in one shard, so the even cuts snap to the joint entries' hulls
    (``_snap_bounds``) and shards go slightly uneven.  A joint entry too
    wide for any snapped shard raises, naming the entry."""

    _ELEMENTWISE = ("box", "cone", "identity")

    @staticmethod
    def _snap_bounds(n: int, S: int, atoms) -> np.ndarray:
        """Shard cuts ``[0, b_1, ..., b_{S-1}, n]``, each even cut moved out of
        any joint-entry hull (atoms: merged, sorted half-open ``(lo, hi)``) to
        the hull's nearer edge (ties to the lower)."""
        bounds = [0]
        for s in range(1, S):
            t = max(round(s * n / S), bounds[-1])
            for lo, hi in atoms:
                if lo < t < hi:
                    t = lo if (t - lo) <= (hi - t) else hi
                    break
            bounds.append(max(t, bounds[-1]))
        bounds.append(n)
        return np.asarray(bounds, dtype=np.int64)

    @classmethod
    def shard_bounds(cls, projection_map, n: int, S: int) -> np.ndarray:
        """The snapped cuts of ``n`` variables over ``S`` shards."""
        hulls = sorted(
            (int(np.min(e.indices)), int(np.max(e.indices)) + 1)
            for e in projection_map.values() if len(e.indices) and e.proj_type not in cls._ELEMENTWISE)
        atoms = []
        for lo, hi in hulls:
            if atoms and lo < atoms[-1][1]:
                atoms[-1] = (atoms[-1][0], max(atoms[-1][1], hi))
            else:
                atoms.append((lo, hi))
        return cls._snap_bounds(n, S, atoms)

    def __init__(self, A, c: np.ndarray, projection_map, dtype, mesh):
        from dualip_tpu_torch.objectives.matching import _mesh_device

        dev = _mesh_device(mesh, None)
        self.mesh = mesh
        self.shape = m, n = A.shape
        S = mesh.world_size
        self._bounds = bounds = self.shard_bounds(projection_map, n, S)
        self.n_local, self.n_shards = max(int(np.diff(bounds).max()), 1), S
        self.c0, self.c1 = c0, c1 = int(bounds[mesh.rank]), int(bounds[mesh.rank + 1])
        self._sparse = isinstance(A, CSCMatrix)
        self._host = A
        if self._sparse:
            lo, hi = int(A.indptr[c0]), int(A.indptr[c1])
            rows = np.asarray(A.row_indices[lo:hi])
            cols = csc_col_ids(A)[lo:hi] - c0
            self.nnz_local = hi - lo
            self.rows, self.cols = host_tensor(rows, dev, torch.int32), host_tensor(cols, dev, torch.int32)
            self.vals = torch.as_tensor(_host_values(A.data[lo:hi], dtype), device=dev)
            if self.nnz_local:
                self.by_row, self.by_col = _key_plan(rows, m, dev), _key_plan(cols, c1 - c0, dev)
        else:
            self.A = torch.as_tensor(_host_values(np.asarray(A)[:, c0:c1], dtype), device=dev)
        self.c_local = torch.as_tensor(_host_values(np.asarray(c)[c0:c1], dtype), device=dev)

        self._proj = []  # (shard-local indices, operator) of the entries that touch this shard
        for key, entry in projection_map.items():
            idx = np.asarray(entry.indices, dtype=np.int64)
            if idx.size == 0:
                continue
            touched = sum(1 for s in range(S) if ((idx >= bounds[s]) & (idx < bounds[s + 1])).any())
            if entry.proj_type not in self._ELEMENTWISE and touched > 1:
                raise ValueError(
                    f"projection entry {key!r} ({entry.proj_type}) couples its coordinates over an index hull "
                    f"too wide to fit any snapped column shard (n={n}, {S} shards); use fewer ranks or the "
                    f"matching objective's entity-block sharding for per-entity polytopes")
            mine = idx[(idx >= c0) & (idx < c1)] - c0
            if mine.size:
                self._proj.append((host_tensor(mine, dev), project(entry.proj_type, **entry.proj_params)))

    def _local_rmatvec(self, y: torch.Tensor) -> torch.Tensor:  # (A^T y) on this shard's columns
        from dualip_tpu_torch.ops.segment_sum import segment_sum_rows

        if not self._sparse:
            return self.A.T @ y
        out = torch.zeros(self.c1 - self.c0, dtype=y.dtype, device=y.device)
        if self.nnz_local:
            out = segment_sum_rows(out, self.vals * y.index_select(0, self.rows), self.by_col)
        return out

    def _local_matvec(self, x_local: torch.Tensor) -> torch.Tensor:  # this shard's part of A x
        from dualip_tpu_torch.ops.segment_sum import segment_sum_rows

        if not self._sparse:
            return self.A @ x_local
        out = torch.zeros(self.shape[0], dtype=x_local.dtype, device=x_local.device)
        if self.nnz_local:
            out = segment_sum_rows(out, self.vals * x_local.index_select(0, self.cols), self.by_row)
        return out

    def fused_iteration(self, dual_val: torch.Tensor, g: torch.Tensor):
        """``(A x, c.x, |x|^2, x_local)`` at ``dual_val``: z, the projections
        and x on this shard's columns, then one ``all_reduce`` of the flat
        buffer ``(A x, c.x, |x|^2)``."""
        x = (-1.0 / g) * (self._local_rmatvec(dual_val) + self.c_local)
        for idx, fn in self._proj:
            x[idx] = fn(x.index_select(0, idx))
        m = self.shape[0]
        # c.x and |x|^2 as the single-device evaluation takes them, so one rank gives its bits
        buf = torch.cat([self._local_matvec(x), (self.c_local @ x).reshape(1), torch.sum(x * x).reshape(1)])
        self.mesh.all_reduce_(buf)
        return buf[:m], buf[m], buf[m + 1], x

    def gather_primal(self, x_local: torch.Tensor) -> torch.Tensor:
        """The ranks' x as one global (n,) vector (an all-gather; on demand
        only, never per iteration)."""
        pad = torch.zeros(self.n_local, dtype=x_local.dtype, device=x_local.device)
        pad[: x_local.shape[0]] = x_local
        parts = self.mesh.all_gather(pad)
        widths = np.diff(self._bounds)
        return torch.cat([p[:w] for p, w in zip(parts, widths)])

    def matvec(self, x: torch.Tensor) -> torch.Tensor:  # A @ x of a global x (rare path)
        return self.mesh.all_reduce_(self._local_matvec(x[self.c0 : self.c1].contiguous()))

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:  # A.T @ y as a global (n,) vector (rare path)
        return self.gather_primal(self._local_rmatvec(y))

    def row_norms(self) -> np.ndarray:
        if self._sparse:
            return row_norms_csc(self._host)
        return np.linalg.norm(np.asarray(self._host), axis=1)


def _param_bound(params: dict, short: str, long: str):
    if short in params:
        return params[short]
    if long in params:
        return params[long]
    return None


class MIPLIB2017ObjectiveFunction(BaseObjective):
    """General-LP dual objective on one device.

    ``layout`` is ``"coo"`` (default) or ``"butterfly"`` (sparse A only);
    ``use_jacobi_precondition`` scales each row of A and b by its norm's
    reciprocal inside the objective; ``dtype`` is the inputs' type (float32;
    a bfloat16 dtype rounds A, c and b as the JAX package does, float64
    computes in float32 as it does); ``plan_cache_dir`` caches the butterfly
    plan; ``device`` (default ``cuda``) is where the data and the solve live.
    ``mesh`` (an ``EntityMesh``; every rank passes the same whole problem)
    splits A, dense or sparse, by variable columns over the ranks
    (``_ColShardedOps``, COO layout only) and keeps c, b and the dual whole
    on every rank."""

    def __init__(
        self,
        miplib_input_args: MIPLIBInputArgs,
        use_jacobi_precondition: bool = False,
        dtype=np.float32,
        mesh=None,
        layout: str = "coo",
        plan_cache_dir=None,
        device=None,
    ):
        args = miplib_input_args
        self._sparse = isinstance(args.A, CSCMatrix)
        if layout not in ("coo", "butterfly"):
            raise ValueError(f"Unknown layout {layout!r} (expected 'coo' or 'butterfly')")
        if layout == "butterfly" and (not self._sparse or mesh is not None):
            raise ValueError("layout='butterfly' needs sparse A and mesh=None")
        self.mesh = mesh
        if mesh is not None:
            from dualip_tpu_torch.objectives.matching import _mesh_device

            self.device = dev = _mesh_device(mesh, device)
        else:
            self.device = dev = resolve_device(device)
        self.layout = layout
        if mesh is not None:
            self.ops = _ColShardedOps(args.A, args.c, args.projection_map, dtype, mesh)
        elif layout == "butterfly":
            self.ops = _ButterflySparseOps(args.A, dtype, dev, plan_cache_dir=plan_cache_dir)
        elif self._sparse:
            self.ops = _SparseOps(args.A, dtype, dev)
        else:
            self.ops = _DenseOps(args.A, dtype, dev)
        self.c = torch.as_tensor(_host_values(args.c, dtype), device=dev)
        self.b_vec = torch.as_tensor(_host_values(args.b_vec, dtype), device=dev)
        self.projection_map = args.projection_map
        self.equality_mask = (
            torch.as_tensor(np.asarray(args.equality_mask, dtype=bool), device=dev)
            if args.equality_mask is not None else None
        )
        self.use_jacobi_precondition = use_jacobi_precondition

        lower, upper = self._construct_variable_lower_upper_bound()
        self.lower = torch.as_tensor(lower, device=dev)
        self.upper = torch.as_tensor(upper, device=dev)

        if use_jacobi_precondition:
            rn = self.ops.row_norms()
            rn = np.where(rn == 0, 1.0, rn)  # all-zero rows stay unscaled
            self.row_norms = torch.as_tensor(_host_values(rn, dtype), device=dev)
        else:
            self.row_norms = None

        # the projection pass: each entry's indices and operator, in map order
        self._proj_entries = []
        for _, entry in self.projection_map.items():
            idx = np.asarray(entry.indices, dtype=np.int64)
            if idx.size:
                self._proj_entries.append(
                    (host_tensor(idx, dev), project(entry.proj_type, **entry.proj_params)))

    @property
    def params(self):
        return ()

    def _project(self, z: torch.Tensor) -> torch.Tensor:
        """Each entry's projection on its indices, entries in map order: a
        later entry reads what an earlier one wrote (``.at[idx].set``)."""
        out = z.clone()
        for idx, proj_fn in self._proj_entries:
            out[idx] = proj_fn(out.index_select(0, idx))
        return out

    def calculate_traceable(self, params, dual_val: torch.Tensor, gamma) -> ObjectiveResult:
        res, _ = self._calculate_full(dual_val, gamma)
        return res

    def _calculate_full(self, dual_val: torch.Tensor, gamma) -> Tuple[ObjectiveResult, torch.Tensor]:
        if self.row_norms is not None:
            dual_val = (1.0 / self.row_norms) * dual_val
        from dualip_tpu_torch.objectives.matching import _scalar

        g = _scalar(gamma, dual_val.dtype, dual_val.device)
        if isinstance(self.ops, _ColShardedOps):
            # the shard's z, projections and x, one all_reduce of (A x, c.x, |x|^2)
            ax, cx, xx, x_local = self.ops.fused_iteration(dual_val, g)
            Ax_minus_b = ax - self.b_vec
            dual_gradient = (1.0 / self.row_norms) * Ax_minus_b if self.row_norms is not None else Ax_minus_b
            reg_penalty = (g / 2.0) * xx
            dual_obj = cx + reg_penalty + dual_val @ Ax_minus_b
            return ObjectiveResult(dual_gradient=dual_gradient, dual_objective=dual_obj,
                                   reg_penalty=reg_penalty), x_local
        z = (-1.0 / g) * (self.ops.rmatvec(dual_val) + self.c)
        projected = self._project(z)

        Ax_minus_b = self.ops.matvec(projected) - self.b_vec
        dual_gradient = (1.0 / self.row_norms) * Ax_minus_b if self.row_norms is not None else Ax_minus_b

        reg_penalty = (g / 2.0) * torch.sum(projected * projected)
        dual_obj = self.c @ projected + reg_penalty + dual_val @ Ax_minus_b
        res = ObjectiveResult(dual_gradient=dual_gradient, dual_objective=dual_obj, reg_penalty=reg_penalty)
        return res, projected

    def calculate(
        self,
        dual_val,
        gamma: float,
        save_primal: bool = False,
        rank: int = 0,
        **kwargs,
    ) -> ObjectiveResult:
        """The objective at ``dual_val``; ``save_primal`` adds ``primal_var``
        (the projected x, a tensor on the device) and ``primal_objective``."""
        del rank, kwargs
        dual_val = torch.as_tensor(dual_val, device=self.device)
        if dual_val.dtype == torch.float64:
            dual_val = dual_val.to(torch.float32)
        res, projected = self._calculate_full(dual_val, gamma)
        if save_primal:
            if isinstance(self.ops, _ColShardedOps):
                projected = self.ops.gather_primal(projected)
            res.primal_var = projected
            res.primal_objective = self.c @ projected
        return res

    def invert_jacobi_precondition(self, dual_val: torch.Tensor, dual_grad: torch.Tensor):
        """A dual and its gradient of the row-scaled problem in the original
        scaling: with D = diag(1/row_norms), lambda = D lambda' and grad =
        D^-1 grad'."""
        if self.row_norms is None:
            return dual_val, dual_grad
        return (1.0 / self.row_norms) * dual_val, self.row_norms * dual_grad

    def _construct_variable_lower_upper_bound(self):
        """Per-variable (lower, upper) from the entries' bounds; NaN where absent."""
        n = self.c.shape[0]
        lower = np.full(n, np.nan, dtype=np.float32)
        upper = np.full(n, np.nan, dtype=np.float32)
        for _, entry in self.projection_map.items():
            idx = np.asarray(entry.indices, dtype=np.int64)
            lo = _param_bound(entry.proj_params, "l", "lower")
            up = _param_bound(entry.proj_params, "u", "upper")
            if lo is not None:
                lower[idx] = lo
            if up is not None:
                upper[idx] = up
        return lower, upper

    def convergence_stop_condition(self, tol: float, gamma: float):
        """A ``stop_condition`` for ``AcceleratedGradientDescent``: the PDLP
        test at the current dual, with x the gamma-subproblem's primal there."""

        def stop(iteration: int, dual_val: torch.Tensor) -> bool:
            del iteration
            res = self.calculate(dual_val, gamma=gamma, save_primal=True)
            *_, converged = self.calculate_convergence_bound(dual_val, x=res.primal_var, tol=tol)
            return converged

        return stop

    @staticmethod
    def _clamp_x_bound_duals(x_bound_duals: torch.Tensor, l_mask_exists, u_mask_exists) -> torch.Tensor:
        """Bound duals onto their cone: lower only -> >= 0; upper only ->
        <= 0; neither -> 0; both -> free."""
        zero = torch.zeros((), dtype=x_bound_duals.dtype, device=x_bound_duals.device)
        out = x_bound_duals
        out = torch.where(l_mask_exists & ~u_mask_exists, torch.maximum(out, zero), out)
        out = torch.where(~l_mask_exists & u_mask_exists, torch.minimum(out, zero), out)
        return torch.where(~l_mask_exists & ~u_mask_exists, zero, out)

    def calculate_convergence_bound(
        self,
        dual_val,
        x=None,
        optimal_primal_obj: Optional[float] = None,
        tol: float = 1e-4,
    ):
        """The PDLP stopping test (Applegate et al. 2022, eq. 6a-6b):
        ``(gap_upperbound, gap_lowerbound, primal_feas, dual_feas,
        converged)``, floats and a bool.  Without ``x`` the primal is the
        reduced-cost vertex ``where(r >= 0, lower, upper)``."""
        dual_val = torch.as_tensor(dual_val, device=self.device)
        if self.row_norms is not None:
            dual_val = (1.0 / self.row_norms) * dual_val

        r = self.c + self.ops.rmatvec(dual_val)  # reduced cost

        if x is None:
            x = torch.where(r >= 0, self.lower, self.upper)
            if bool(torch.isnan(x).any()):
                raise ValueError("Unbounded x.")
        else:
            x = torch.as_tensor(x, device=self.device)

        lambda_neg = torch.clamp_max(r, 0.0)
        lambda_pos = torch.clamp_min(r, 0.0)
        u_exists = ~torch.isnan(self.upper)
        l_exists = ~torch.isnan(self.lower)
        zero = torch.zeros((), dtype=r.dtype, device=r.device)
        lambda_u = torch.sum(torch.where(u_exists, lambda_neg * torch.nan_to_num(self.upper), zero))
        lambda_l = torch.sum(torch.where(l_exists, lambda_pos * torch.nan_to_num(self.lower), zero))
        d = -torch.dot(self.b_vec, dual_val) + lambda_u + lambda_l

        p = torch.dot(self.c, x)
        gap_upperbound = torch.abs(p - d) / (1.0 + torch.abs(p) + torch.abs(d))
        if optimal_primal_obj is not None:
            opt = float(optimal_primal_obj)
            gap_lower_bound = float(torch.abs(p - opt) / (1.0 + torch.abs(p) + abs(opt)))
        else:
            gap_lower_bound = float("nan")

        Ax_minus_b = self.ops.matvec(x) - self.b_vec
        if self.equality_mask is None:
            row_violation = torch.clamp_min(Ax_minus_b, 0.0)
        else:
            row_violation = torch.where(self.equality_mask, torch.abs(Ax_minus_b), torch.clamp_min(Ax_minus_b, 0.0))
        primal_feas = torch.linalg.vector_norm(row_violation) / (1.0 + torch.linalg.vector_norm(self.b_vec))

        x_bound_duals = self._clamp_x_bound_duals(-r, l_exists, u_exists)
        dual_feas = torch.linalg.vector_norm(r + x_bound_duals) / (1.0 + torch.linalg.vector_norm(self.c))

        gap_ub, p_feas, d_feas = float(gap_upperbound), float(primal_feas), float(dual_feas)
        converged = gap_ub <= tol and p_feas <= tol and d_feas <= tol
        return gap_ub, gap_lower_bound, p_feas, d_feas, converged
