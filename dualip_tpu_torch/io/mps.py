"""MPS (fixed/free format) reader and writer for LP relaxations
(``dualip_tpu/io/mps.py``), numpy only.

The subset of the MPS standard and the LP normalization of the reference's
``examples/miplib_2017/read_mps_data.py``:

* sections NAME / ROWS / COLUMNS / RHS / BOUNDS / ENDATA; integer markers
  skipped (LP relaxation), reference ``read_mps_data.py:273-319``;
* row types N (objective), L (<=), G (>=, negated into <= form), E
  (equality, kept with an equality mask), reference ``:504-539``;
* OBJSENSE (extension, same reference mis-parse caveat as RANGES): ``MAX``/
  ``MAXIMIZE`` negates ``c`` so the normalized LP is always a minimization;
  ``MPSLinearProgram.objective_sense`` records the original sense (recover
  the original optimum as ``-dual_objective`` when it is ``"max"``);
* RANGES (extension — the reference has no RANGES handling and silently
  mis-parses such files: an unrecognized section header leaves its
  ``current_section`` pointing at the previous section).  Standard
  semantics: for a row with RHS value ``r`` and range ``R``, L rows become
  ``r - |R| <= ax <= r``, G rows ``r <= ax <= r + |R|``, E rows
  ``r + min(R, 0) <= ax <= r + max(R, 0)``.  Each ranged row's second side
  is materialized as an extra negated <= row (appended after the base rows,
  named ``<row>__range``), keeping the normalized ``Ax <= b`` form;
* bound types LO/LI/UP/UI/FX/FR/BV/MI/PL with the IBM convention for a
  negative-only upper bound (upper-only and ``u >= 0`` ⇒ lower 0; ``u < 0``
  ⇒ lower -inf), default bounds (0, +inf), reference ``:543-598``;
* variables ordered by sorted name; missing RHS treated as 0.

Output: ``MPSLinearProgram`` → ``to_miplib_input_args()`` builds the solver
input with a sparse CSC A and a projection map grouping variables by their
identical (lower, upper) pair.  Unbounded sides are encoded as NaN — the
schema this package's box projection and PDLP certificate share (the
reference emitted ±inf under ``lower``/``upper`` keys which its own bound
extraction then failed to read, defect SURVEY.md §2.6.4).
"""

from __future__ import annotations

import gzip
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from dualip_tpu_torch.projections.base import ProjectionEntry
from dualip_tpu_torch.sparse.csc import CSCMatrix


@dataclass
class MPSLinearProgram:
    """Normalized LP: ``min c^T x  s.t.  A x <= b`` (equality rows flagged),
    ``lower <= x <= upper`` with NaN for absent sides."""

    name: str
    c: np.ndarray  # (n,)
    b: np.ndarray  # (m,)
    a_rows: np.ndarray  # (nnz,) int32
    a_cols: np.ndarray  # (nnz,) int32
    a_vals: np.ndarray  # (nnz,) float
    lower: np.ndarray  # (n,) with NaN = unbounded below
    upper: np.ndarray  # (n,) with NaN = unbounded above
    equality_mask: np.ndarray  # (m,) bool
    row_names: List[str] = field(default_factory=list)
    col_names: List[str] = field(default_factory=list)
    stats: Dict[str, int] = field(default_factory=dict)
    objective_sense: str = "min"  # original sense; c is always min-normalized

    @property
    def shape(self) -> Tuple[int, int]:
        return (len(self.b), len(self.c))

    def to_csc(self, dtype=np.float32) -> CSCMatrix:
        order = np.lexsort((self.a_rows, self.a_cols))
        cols = self.a_cols[order]
        counts = np.bincount(cols, minlength=len(self.c))
        indptr = np.zeros(len(self.c) + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSCMatrix(
            indptr=indptr,
            row_indices=self.a_rows[order].astype(np.int32),
            data=self.a_vals[order].astype(dtype),
            shape=self.shape,
        )

    def build_projection_map(self) -> Dict[str, ProjectionEntry]:
        """Group variables by identical (lower, upper) bound pairs
        (reference ``read_mps_data.py:174-189``)."""
        def keyed(v: float):
            # NaN != NaN would split one logical group per variable
            return None if math.isnan(v) else float(v)

        groups: Dict[Tuple, List[int]] = {}
        for idx in range(len(self.c)):
            key = (keyed(float(self.lower[idx])), keyed(float(self.upper[idx])))
            groups.setdefault(key, []).append(idx)
        pm = {}
        for (lo, up), indices in groups.items():
            pm[f"bound_({lo}, {up})"] = ProjectionEntry(
                proj_type="box",
                proj_params={
                    "lower": float("nan") if lo is None else lo,
                    "upper": float("nan") if up is None else up,
                },
                indices=indices,
            )
        return pm

    def to_miplib_input_args(self, dtype=np.float32, sparse: bool = True):
        from dualip_tpu_torch.objectives.miplib import MIPLIBInputArgs

        A = self.to_csc(dtype)
        if not sparse:
            from dualip_tpu_torch.sparse.csc import csc_to_dense

            A = csc_to_dense(A)
        return MIPLIBInputArgs(
            A=A,
            c=self.c.astype(dtype),
            projection_map=self.build_projection_map(),
            b_vec=self.b.astype(dtype),
            equality_mask=self.equality_mask if self.equality_mask.any() else None,
        )


_BOUND_TYPES_WITH_VALUE = {"LO", "LI", "UP", "UI", "FX"}
_BOUND_TYPES_NO_VALUE = {"FR", "BV", "MI", "PL"}


def read_mps_file(path: str, verbose: bool = False) -> MPSLinearProgram:
    """Parse a (optionally gzipped) MPS file into a normalized LP."""
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open

    obj_row: Optional[str] = None
    row_types: Dict[str, str] = {}
    row_order: List[str] = []
    # coefficient triplets as (row_name, col_name, value)
    coeffs: List[Tuple[str, str, float]] = []
    rhs: Dict[str, float] = {}
    ranges: Dict[str, float] = {}
    bounds: Dict[str, Dict[str, float]] = {}
    col_seen: Dict[str, None] = {}
    name = path.stem
    sense = "min"

    section = None
    with opener(path, "rt", encoding="ISO-8859-1") as fh:
        for raw in fh:
            if not raw.strip() or raw.startswith("*"):
                continue
            if not raw[0].isspace():
                parts = raw.split()
                section = parts[0].upper()
                if section == "NAME" and len(parts) > 1:
                    name = parts[1]
                if section == "OBJSENSE" and len(parts) > 1:
                    sense = parts[1].upper()  # one-line form: OBJSENSE MAX
                if section == "ENDATA":
                    break
                continue

            parts = raw.split()
            if section == "OBJSENSE":
                sense = parts[0].upper()
                continue
            if section == "ROWS":
                rtype, rname = parts[0].upper(), parts[1]
                if rtype == "N":
                    if obj_row is not None:
                        raise ValueError(f"Multiple objective rows: {obj_row}, {rname}")
                    obj_row = rname
                elif rtype in ("L", "G", "E"):
                    row_types[rname] = rtype
                    row_order.append(rname)
                else:
                    raise ValueError(f"Unknown row type {rtype!r}")
            elif section == "COLUMNS":
                if "'MARKER'" in raw:
                    continue  # integer markers: LP relaxation drops integrality
                col = parts[0]
                col_seen.setdefault(col)
                for i in range(1, len(parts) - 1, 2):
                    coeffs.append((parts[i], col, float(parts[i + 1])))
            elif section == "RHS":
                for i in range(1, len(parts) - 1, 2):
                    rhs[parts[i]] = float(parts[i + 1])
            elif section == "RANGES":
                # same (vector-name, row, value [, row, value]) shape as RHS
                for i in range(1, len(parts) - 1, 2):
                    ranges[parts[i]] = float(parts[i + 1])
            elif section == "BOUNDS":
                btype = parts[0].upper()
                var = parts[2]
                entry = bounds.setdefault(var, {})
                if btype in _BOUND_TYPES_WITH_VALUE:
                    val = float(parts[3])
                    if btype == "FX":
                        entry["fx"] = val
                    elif btype in ("LO", "LI"):
                        entry["l"] = val
                    else:  # UP / UI
                        entry["u"] = val
                elif btype in _BOUND_TYPES_NO_VALUE:
                    if btype == "FR":
                        entry["fr"] = True
                    elif btype == "BV":
                        entry["bv"] = True
                    elif btype == "MI":
                        entry["l"] = -math.inf
                    else:  # PL
                        entry["u"] = math.inf
                else:
                    raise ValueError(f"Unsupported bound type {btype!r}")

    if obj_row is None:
        raise ValueError("MPS file has no objective (N) row")
    if sense in ("MAX", "MAXIMIZE"):
        sense = "max"
    elif sense in ("MIN", "MINIMIZE", "min"):
        sense = "min"
    else:
        raise ValueError(f"Unknown OBJSENSE {sense!r}")

    col_names = sorted(col_seen)
    col_idx = {c: i for i, c in enumerate(col_names)}
    row_idx = {r: i for i, r in enumerate(row_order)}
    n, m = len(col_names), len(row_order)

    c = np.zeros(n, dtype=np.float64)
    b = np.zeros(m, dtype=np.float64)
    equality_mask = np.zeros(m, dtype=bool)
    for rname, rtype in row_types.items():
        i = row_idx[rname]
        val = rhs.get(rname, 0.0)
        b[i] = -val if rtype == "G" else val
        equality_mask[i] = rtype == "E"

    a_rows, a_cols, a_vals = [], [], []
    for rname, cname, value in coeffs:
        if rname == obj_row:
            # MPS convention: repeated entries for the same (row, column) sum.
            c[col_idx[cname]] += value
            continue
        if rname not in row_idx:
            raise ValueError(f"Coefficient references unknown row {rname!r}")
        i = row_idx[rname]
        a_rows.append(i)
        a_cols.append(col_idx[cname])
        a_vals.append(-value if row_types[rname] == "G" else value)

    # Merge duplicate (row, col) constraint entries by summing (MPS
    # convention); leaving duplicates would produce a CSC that
    # check_correct_csc_construction rightly rejects.
    if a_vals:
        ar = np.asarray(a_rows, dtype=np.int64)
        ac = np.asarray(a_cols, dtype=np.int64)
        av = np.asarray(a_vals, dtype=np.float64)
        key = ac * m + ar
        uniq, inv = np.unique(key, return_inverse=True)
        if uniq.size != key.size:
            merged = np.zeros(uniq.size, dtype=np.float64)
            np.add.at(merged, inv, av)
            ar = (uniq % m).astype(np.int64)
            ac = (uniq // m).astype(np.int64)
            av = merged
        a_rows, a_cols, a_vals = ar.tolist(), ac.tolist(), av.tolist()

    # --- RANGES: materialize the second side of each ranged row ------------
    # Stored orientation is a'·x <= b' (G rows already negated), so the
    # opposite side of an L/G range is uniformly  -a'·x <= -b' + |R|.
    # Ranged E rows stop being equalities: a·x <= r + max(R,0) replaces the
    # stored row and -a·x <= -(r + min(R,0)) is appended.
    n_ranged = 0
    if ranges:
        ar = np.asarray(a_rows, dtype=np.int64)
        ac = np.asarray(a_cols, dtype=np.int64)
        av = np.asarray(a_vals, dtype=np.float64)
        new_bs: List[float] = []
        for rname, R in sorted(ranges.items(), key=lambda kv: row_idx.get(kv[0], -1)):
            if rname not in row_idx:
                raise ValueError(f"RANGES references unknown row {rname!r}")
            rtype = row_types[rname]
            if R == 0.0 and rtype == "E":
                continue  # zero range keeps the row an equality
            i = row_idx[rname]
            if rtype == "E":
                r0 = rhs.get(rname, 0.0)
                equality_mask[i] = False
                b[i] = r0 + max(R, 0.0)
                new_b = -(r0 + min(R, 0.0))
            else:
                new_b = -b[i] + abs(R)
            sel = ar == i
            k = m + len(new_bs)
            a_rows.extend([k] * int(sel.sum()))
            a_cols.extend(ac[sel].tolist())
            a_vals.extend((-av[sel]).tolist())
            new_bs.append(new_b)
            row_order.append(f"{rname}__range")
        if new_bs:
            n_ranged = len(new_bs)
            b = np.concatenate([b, np.asarray(new_bs, dtype=np.float64)])
            equality_mask = np.concatenate([equality_mask, np.zeros(n_ranged, dtype=bool)])
            m = len(b)

    # Resolve bounds with the reference's conventions (read_mps_data.py:556-588).
    lower = np.zeros(n, dtype=np.float64)
    upper = np.full(n, np.inf, dtype=np.float64)
    stats = {k: 0 for k in ("binary", "free", "fixed", "range", "lower_only", "upper_only", "default")}
    stats["ranged_rows"] = n_ranged
    for j, cname in enumerate(col_names):
        cb = bounds.get(cname)
        if cb is None:
            stats["default"] += 1
            continue
        if "bv" in cb:
            lower[j], upper[j] = 0.0, 1.0
            stats["binary"] += 1
        elif "fr" in cb:
            lower[j], upper[j] = -np.inf, np.inf
            stats["free"] += 1
        elif "fx" in cb:
            lower[j] = upper[j] = cb["fx"]
            stats["fixed"] += 1
        else:
            lo, up = cb.get("l"), cb.get("u")
            if lo is not None and up is not None:
                lower[j], upper[j] = lo, up
                stats["range"] += 1
            elif lo is not None:
                lower[j], upper[j] = lo, np.inf
                stats["lower_only"] += 1
            elif up is not None:
                # IBM convention: upper-only with u < 0 implies free below
                lower[j] = 0.0 if up >= 0 else -np.inf
                upper[j] = up
                stats["upper_only"] += 1

    # NaN-encode unbounded sides (schema shared with box/certificate).
    lower = np.where(np.isinf(lower), np.nan, lower)
    upper = np.where(np.isinf(upper), np.nan, upper)

    if verbose:
        print(
            f"MPS {name}: {m} constraints ({int(equality_mask.sum())} equality), "
            f"{n} variables, {len(a_vals)} nonzeros, bounds {stats}"
        )

    if sense == "max":
        c = -c  # normalize to minimization; original optimum = -dual_objective

    return MPSLinearProgram(
        name=name,
        c=c,
        b=b,
        a_rows=np.asarray(a_rows, dtype=np.int32),
        a_cols=np.asarray(a_cols, dtype=np.int32),
        a_vals=np.asarray(a_vals, dtype=np.float64),
        lower=lower,
        upper=upper,
        equality_mask=equality_mask,
        row_names=row_order,
        col_names=col_names,
        stats=stats,
        objective_sense=sense,
    )


def write_mps_file(lp: MPSLinearProgram, path: str) -> None:
    """Write the normalized LP back out as a (optionally gzipped) MPS file.

    Extension (the reference has no writer): every constraint row is L (<=)
    or E, bounds are written explicitly whenever they differ from the MPS
    default ``[0, +inf)``, an explicit ``LO`` accompanies any finite upper
    bound so the IBM negative-upper convention can never re-interpret it on
    read-back, and a max-sense LP writes ``OBJSENSE MAXIMIZE`` with ``c``
    un-negated so the sense round-trips too.  ``read_mps_file(write_mps_file(
    lp)) == lp`` up to float formatting, PROVIDED ``col_names`` are in sorted
    order (the reader orders variables by sorted name — any
    ``MPSLinearProgram`` the reader produced satisfies this); round-trip
    pinned in ``tests/test_mps_reader.py``.
    """
    p = Path(path)
    opener = gzip.open if p.suffix == ".gz" else open
    m, n = lp.shape
    row_names = list(lp.row_names) if lp.row_names else [f"R{i}" for i in range(m)]
    col_names = list(lp.col_names) if lp.col_names else [f"X{j}" for j in range(n)]
    obj_name = "OBJ"
    taken = set(row_names)
    while obj_name in taken:  # a constraint row named OBJ must not collide
        obj_name += "_"

    # column-major coefficient lists (COO triplets -> per-column)
    per_col: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
    for r, cidx, v in zip(lp.a_rows, lp.a_cols, lp.a_vals):
        per_col[int(cidx)].append((int(r), float(v)))

    c_out = -lp.c if lp.objective_sense == "max" else lp.c

    def fmt(v: float) -> str:
        return np.format_float_scientific(v, precision=17, trim="-")

    with opener(p, "wt", encoding="ISO-8859-1") as fh:
        fh.write(f"NAME          {lp.name or p.stem}\n")
        if lp.objective_sense == "max":
            fh.write("OBJSENSE\n    MAXIMIZE\n")
        fh.write("ROWS\n")
        fh.write(f" N  {obj_name}\n")
        for i, rn in enumerate(row_names):
            fh.write(f" {'E' if lp.equality_mask[i] else 'L'}  {rn}\n")
        fh.write("COLUMNS\n")
        for j, cn in enumerate(col_names):
            if c_out[j] != 0.0 or not per_col[j]:
                # a column with no entries anywhere must still appear in
                # COLUMNS (the reader registers variables there), so emit an
                # explicit zero objective coefficient for it
                fh.write(f"    {cn}  {obj_name}  {fmt(float(c_out[j]))}\n")
            for r, v in per_col[j]:
                fh.write(f"    {cn}  {row_names[r]}  {fmt(v)}\n")
        fh.write("RHS\n")
        for i, rn in enumerate(row_names):
            if lp.b[i] != 0.0:
                fh.write(f"    RHS  {rn}  {fmt(float(lp.b[i]))}\n")
        fh.write("BOUNDS\n")
        for j, cn in enumerate(col_names):
            lo = float(lp.lower[j])
            up = float(lp.upper[j])
            lo_abs, up_abs = math.isnan(lo), math.isnan(up)
            if lo_abs and up_abs:
                fh.write(f" FR BND  {cn}\n")
            elif lo_abs:  # upper only: MI disarms the default lower of 0
                fh.write(f" MI BND  {cn}\n")
                fh.write(f" UP BND  {cn}  {fmt(up)}\n")
            elif up_abs:
                if lo != 0.0:
                    fh.write(f" LO BND  {cn}  {fmt(lo)}\n")
                # lo == 0, up absent == the MPS default: no entry
            elif lo == up:
                fh.write(f" FX BND  {cn}  {fmt(lo)}\n")
            else:
                # explicit LO first: a bare negative UP would flip the lower
                # bound to -inf under the IBM convention (read_mps_file)
                fh.write(f" LO BND  {cn}  {fmt(lo)}\n")
                fh.write(f" UP BND  {cn}  {fmt(up)}\n")
        fh.write("ENDATA\n")
