"""The port's MPS reader and writer against the JAX package's (both numpy:
every field equal), and the bundled MIPLIB-2017 instance through the port's
general-LP objective (a mirror of ``tests/test_mps_reader.py``).

The 10,000-iteration solve of the bundled instance runs on the card
(``chip_smoke.py``, phase ``lp``), not here.  Here a 24-column slice of it,
cut with the port's ``split_csc_by_cols``, holds the butterfly layout to the
COO layout per ``calculate``, at the JAX test's tolerances: gradient within
1e-3 of its largest entry, objective 1e-5 relative (1e-4 absolute), penalty
1e-4 relative; and the COO layout to the JAX package's at 1e-5 relative."""

import gzip
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dualip_tpu.io.mps import MPSLinearProgram as JaxLP
from dualip_tpu.io.mps import read_mps_file as jax_read
from dualip_tpu.objectives.miplib import MIPLIB2017ObjectiveFunction as JaxMIPLIB
from dualip_tpu_torch.io.mps import MPSLinearProgram, read_mps_file, write_mps_file
from dualip_tpu_torch.objectives.miplib import MIPLIB2017ObjectiveFunction, MIPLIBInputArgs
from dualip_tpu_torch.parallel import global_to_local_projection_map
from dualip_tpu_torch.sparse import csc_to_dense, split_csc_by_cols
from tests.test_mps_reader import MPS_TEXT, RANGES_MPS

torch.set_num_threads(1)

BUNDLED = Path(__file__).resolve().parents[1] / "examples" / "miplib_2017" / "v150d30-2hopcds.mps.gz"

BOUNDS_MPS = """NAME bounds
ROWS
 N  obj
 L  c1
 G  c2
COLUMNS
    MARKER    'MARKER'  'INTORG'
    a  obj  1.0  c1  1.0
    MARKER    'MARKER'  'INTEND'
    b  obj  -2.0  c1  2.0
    c  c2  1.0  obj  0.5
    d  c1  -1.0  c2  3.0
    e  c1  4.0
    f  c2  1.0
    g  c1  1.0
    h  c2  2.0
    i  c1  1.5
RHS
    RHS  c1  10.0  c2  -1.0
BOUNDS
 LI BND  a  1
 UI BND  a  5
 BV BND  b
 MI BND  c
 PL BND  d
 FX BND  e  2.5
 UP BND  f  -3.0
 LO BND  g  -4.0
 UP BND  g  6.0
ENDATA
"""

DUP_MPS = """NAME dup
ROWS
 N  COST
 L  R1
COLUMNS
    X  COST  1.0  R1  2.0
    X  COST  0.5  R1  3.0
    Y  R1  1.0
RHS
    RHS  R1  10.0
ENDATA
"""

OBJSENSE_MPS = ("NAME maxtest\n{sense}ROWS\n N  obj\n L  r1\nCOLUMNS\n"
                "    x         obj       3.0        r1        1.0\n"
                "    y         obj       1.0        r1        1.0\n"
                "RHS\n    RHS       r1        2.0\nENDATA\n")

TEXTS = [
    ("tiny", MPS_TEXT),
    ("negative upper", MPS_TEXT.replace(" UP BND       X1        4.0", " UP BND       X1        -2.0")),
    ("ranges", RANGES_MPS),
    ("bound types", BOUNDS_MPS),
    ("duplicates", DUP_MPS),
    ("objsense block", OBJSENSE_MPS.format(sense="OBJSENSE\n    MAXIMIZE\n")),
    ("objsense inline", OBJSENSE_MPS.format(sense="OBJSENSE MAX\n")),
    ("objsense min", OBJSENSE_MPS.format(sense="")),
]


def _assert_same_lp(got, want):
    assert got.name == want.name and got.shape == want.shape
    assert got.objective_sense == want.objective_sense
    assert got.row_names == want.row_names and got.col_names == want.col_names
    assert got.stats == want.stats
    for f in ("c", "b", "a_rows", "a_cols", "a_vals", "lower", "upper", "equality_mask"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("name,text", TEXTS, ids=[t[0] for t in TEXTS])
def test_reader_matches_the_jax_package(tmp_path, name, text, gz):
    p = tmp_path / ("t.mps.gz" if gz else "t.mps")
    if gz:
        with gzip.open(p, "wt") as fh:
            fh.write(text)
    else:
        p.write_text(text)
    got, want = read_mps_file(str(p)), jax_read(str(p))
    _assert_same_lp(got, want)
    A, R = got.to_csc(), want.to_csc()
    for f in ("indptr", "row_indices", "data"):
        np.testing.assert_array_equal(getattr(A, f), getattr(R, f))
    args = got.to_miplib_input_args()
    assert isinstance(args, MIPLIBInputArgs)
    ref_args = want.to_miplib_input_args()
    assert list(args.projection_map) == list(ref_args.projection_map)
    for k, e in args.projection_map.items():
        r = ref_args.projection_map[k]
        assert e.proj_type == r.proj_type and list(e.indices) == list(r.indices)
        np.testing.assert_array_equal(list(e.proj_params.values()), list(r.proj_params.values()))
    np.testing.assert_array_equal(got.to_miplib_input_args(sparse=False).A, csc_to_dense(A))


def test_reader_conventions():
    """The reference's conventions on the tiny file: G rows negated, E rows
    kept with the mask, UP >= 0 alone means lower 0, duplicate entries sum."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "t.mps"
        p.write_text(MPS_TEXT)
        lp = read_mps_file(str(p))
        p.write_text(DUP_MPS)
        dup = read_mps_file(str(p))
        p.write_text("NAME x\nROWS\n N obj\n L r1\nCOLUMNS\n    x obj 1.0 r1 1.0\nRANGES\n    RNG nosuch 1.0\nENDATA\n")
        with pytest.raises(ValueError, match="unknown row"):
            read_mps_file(str(p))
    np.testing.assert_allclose(lp.b, [4.0, -1.0, 7.0])
    assert lp.equality_mask.tolist() == [False, False, True]
    np.testing.assert_allclose(csc_to_dense(lp.to_csc()), [[2.0, 1.0, 0.0], [-3.0, 0.0, -1.0], [0.0, 1.0, -1.0]])
    assert lp.lower[0] == 0.0 and lp.upper[0] == 4.0 and np.isnan(lp.upper[1]) and np.isnan(lp.lower[2])
    xj = dup.col_names.index("X")
    assert dup.c[xj] == 1.5 and csc_to_dense(dup.to_csc())[0, xj] == 5.0


def _random_lp(cls):
    rng = np.random.default_rng(0)
    m, n = 7, 12
    rows, cols = np.nonzero(rng.random((m, n)) < 0.5)
    lower, upper = np.zeros(n), np.full(n, np.nan)
    lower[1] = np.nan                              # FR
    lower[2], upper[2] = np.nan, 2.5               # MI + UP
    lower[3] = -1.5                                # LO only
    lower[4] = upper[4] = 0.75                     # FX
    lower[5], upper[5] = -2.0, 3.0                 # LO + UP
    lower[6], upper[6] = -5.0, -1.0                # negative upper
    eq = np.zeros(m, bool)
    eq[2] = True
    return cls(name="roundtrip", c=rng.normal(size=n), b=rng.normal(size=m), a_rows=rows.astype(np.int32),
               a_cols=cols.astype(np.int32), a_vals=rng.normal(size=rows.size), lower=lower, upper=upper,
               equality_mask=eq, row_names=[f"R{i}" for i in range(m)], col_names=[f"X{j:02d}" for j in range(n)])


@pytest.mark.parametrize("suffix", [".mps", ".mps.gz"])
def test_writer_roundtrips_and_matches_the_jax_package(tmp_path, suffix):
    from dualip_tpu.io.mps import write_mps_file as jax_write

    lp = _random_lp(MPSLinearProgram)
    p, q = tmp_path / ("port" + suffix), tmp_path / ("jax" + suffix)
    write_mps_file(lp, str(p))
    jax_write(_random_lp(JaxLP), str(q))
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(p, "rt") as a, opener(q, "rt") as b:
        assert a.read() == b.read()
    back = read_mps_file(str(p))
    m, n = lp.shape
    A1, A2 = np.zeros((m, n)), np.zeros((m, n))
    A1[lp.a_rows, lp.a_cols] = lp.a_vals
    A2[back.a_rows, back.a_cols] = back.a_vals
    np.testing.assert_allclose(A2, A1)
    for f in ("c", "b", "lower", "upper"):
        np.testing.assert_allclose(getattr(back, f), getattr(lp, f), err_msg=f)
    np.testing.assert_array_equal(back.equality_mask, lp.equality_mask)


@pytest.mark.skipif(not BUNDLED.exists(), reason="bundled MIPLIB instance missing")
def test_v150d30_parses_and_slice_layouts_agree():
    lp = read_mps_file(str(BUNDLED))
    assert lp.shape == (7822, 150)
    assert lp.to_csc().nnz == 103991
    assert not lp.equality_mask.any()
    _assert_same_lp(lp, jax_read(str(BUNDLED)))

    args = lp.to_miplib_input_args()
    K = 24  # real columns, about 670 nnz each
    A_sl = split_csc_by_cols(args.A, [K, args.A.shape[1] - K])[0]
    pm = global_to_local_projection_map(args.projection_map, list(range(K)))  # the slice's columns
    sl = MIPLIBInputArgs(A=A_sl, c=args.c[:K], projection_map=pm, b_vec=args.b_vec, equality_mask=args.equality_mask)
    coo = MIPLIB2017ObjectiveFunction(sl, device="cpu")
    bf = MIPLIB2017ObjectiveFunction(sl, layout="butterfly", device="cpu")
    from dualip_tpu.objectives.miplib import MIPLIBInputArgs as JaxArgs
    from dualip_tpu.projections import ProjectionEntry as JaxEntry
    from dualip_tpu.sparse import CSCMatrix as JaxCSC

    ref = JaxMIPLIB(JaxArgs(A=JaxCSC(*A_sl), c=sl.c, b_vec=sl.b_vec, equality_mask=sl.equality_mask,
                            projection_map={k: JaxEntry(e.proj_type, e.proj_params, e.indices) for k, e in pm.items()}))
    for seed in range(3):
        lam = np.abs(np.random.default_rng(seed).normal(size=lp.shape[0])).astype(np.float32)
        r1, r2 = coo.calculate(torch.from_numpy(lam), gamma=1e-3), bf.calculate(torch.from_numpy(lam), gamma=1e-3)
        g1, g2 = r1.dual_gradient.numpy(), r2.dual_gradient.numpy()
        assert np.allclose(g1, g2, atol=1e-3 * max(1.0, np.abs(g1).max())), np.abs(g1 - g2).max()
        assert np.isclose(float(r1.dual_objective), float(r2.dual_objective), rtol=1e-5, atol=1e-4)
        assert np.isclose(float(r1.reg_penalty), float(r2.reg_penalty), rtol=1e-4, atol=1e-5)
        rj = ref.calculate(jnp.asarray(lam), gamma=1e-3)
        assert float(r1.dual_objective) == pytest.approx(float(rj.dual_objective), rel=1e-5)
        np.testing.assert_allclose(g1, np.asarray(rj.dual_gradient), atol=1e-5 * max(1.0, np.abs(g1).max()))
