"""The port's MovieLens example against the JAX package's, on the same numpy
inputs: the LP builder, snapshots, the proxy generator and LP, the fairness
objective and its solve through ``run_solver``, and the proxy comparison
against the committed logs."""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dualip_tpu_torch import ComputeArgs, ObjectiveArgs, SolverArgs, run_solver
from dualip_tpu_torch.examples.movielens_matching import movies_lens_matching as ml
from dualip_tpu_torch.examples.movielens_matching import proxy_validation as pv

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
JAX_EXAMPLE = ROOT / "examples" / "movielens_matching"


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # the dataclass decorator needs the module registered
    spec.loader.exec_module(mod)
    return mod


jml = sys.modules.get("movies_lens_matching") or _load("movies_lens_matching", JAX_EXAMPLE / "movies_lens_matching.py")
jpv = _load("jax_proxy_validation", JAX_EXAMPLE / "proxy_validation.py")

CSV = """userId,movieId,rating,timestamp
1,10,4.0,111
1,20,3.0,112
2,10,5.0,113
2,30,2.0,114
3,20,1.0,115
1,10,2.0,116
4,20,4.5,117
4,30,3.5,118
"""

# a proxy small enough for the CPU, with the same generator and LP builder
SMALL = dict(n_users=3000, n_movies=600, n_ratings=40_000)


def _csv(tmp_path):
    p = tmp_path / "ratings.csv"
    p.write_text(CSV)
    return str(p)


def _same_lp(port, jax_args):
    for f in ("indptr", "row_indices", "data"):
        for mat in ("A", "c"):
            got, want = getattr(getattr(port, mat), f), getattr(getattr(jax_args, mat), f)
            assert got.dtype == want.dtype and np.array_equal(got, want), (mat, f)
    assert port.A.shape == jax_args.A.shape
    b, jb = np.asarray(port.b_vec), np.asarray(jax_args.b_vec)
    assert b.dtype == jb.dtype and np.array_equal(b, jb)
    assert port.projection_map.keys() == jax_args.projection_map.keys()


@pytest.mark.parametrize("kw", [
    {}, {"per_movie_capacity": 0.7}, {"min_movie_interactions": 2}, {"min_user_interactions": 2},
    {"rating_scale": 0.5, "rating_shift": 1.0},
], ids=["default", "capacity", "movie_filter", "user_filter", "scale_shift"])
def test_prepare_matches_the_jax_package(tmp_path, kw):
    path = _csv(tmp_path)
    port, users, rows = ml.prepare_movielens_matching(ml.MovielensMatchingConfig(ratings_csv_path=path, **kw))
    jargs, jusers, jrows = jml.prepare_movielens_matching(jml.MovielensMatchingConfig(ratings_csv_path=path, **kw))
    _same_lp(port, jargs)
    assert users == jusers and rows == jrows


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshots_load_in_the_other_package(tmp_path, writer):
    path = _csv(tmp_path)
    port, users, rows = ml.prepare_movielens_matching(ml.MovielensMatchingConfig(ratings_csv_path=path))
    jargs, *_ = jml.prepare_movielens_matching(jml.MovielensMatchingConfig(ratings_csv_path=path))
    prefix = str(tmp_path / "snap")
    save, load = (ml.save_snapshot, jml.load_snapshot) if writer == "port" else (jml.save_snapshot, ml.load_snapshot)
    save(port if writer == "port" else jargs, prefix, users, rows)
    got, users2, rows2 = load(prefix)
    _same_lp(port, got) if writer == "port" else _same_lp(got, jargs)
    assert users2 == users and rows2 == rows


@pytest.fixture(scope="module")
def small_proxy(tmp_path_factory):
    """The reduced proxy from both packages' generators (the JAX module's
    constants patched for the call) and both packages' LPs."""
    d = tmp_path_factory.mktemp("proxy")
    mp = pytest.MonkeyPatch()
    mp.setattr(jpv, "N_USERS", SMALL["n_users"])
    mp.setattr(jpv, "N_MOVIES", SMALL["n_movies"])
    mp.setattr(jpv, "N_RATINGS", SMALL["n_ratings"])
    mp.setattr(jpv, "DATA", d)
    try:
        jpv.generate_proxy_ratings(d / "proxy_ratings.npz")
        with np.load(d / "proxy_ratings.npz") as z:
            jax_ratings = (z["users"], z["movies"], z["ratings"])
        jax_lps = {f: jpv.build_lp(f) for f in (False, True)}
    finally:
        mp.undo()
    ratings = pv.generate_proxy_ratings(d / "port_ratings.npz", **SMALL)
    return {"jax_ratings": jax_ratings, "ratings": ratings, "jax_lp": jax_lps,
            "lp": {f: pv.build_lp(f, ratings) for f in (False, True)}, "dir": d}


def test_proxy_ratings_match_bit_for_bit(small_proxy):
    for got, want in zip(small_proxy["ratings"], small_proxy["jax_ratings"]):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert all(np.array_equal(a, b) for a, b in zip(pv.load_ratings(small_proxy["dir"] / "port_ratings.npz"),
                                                    small_proxy["ratings"]))


@pytest.mark.parametrize("fairness", [False, True], ids=["plain", "fairness"])
def test_proxy_lp_matches_bit_for_bit(small_proxy, fairness):
    port, jargs = small_proxy["lp"][fairness], small_proxy["jax_lp"][fairness]
    _same_lp(port, jargs)
    if fairness:
        assert port.group_a_rows == jargs.group_a_rows and port.group_b_rows == jargs.group_b_rows
        assert len(port.group_a_rows) == pv.N_FAIR


def test_proxy_defaults_are_the_jax_scripts():
    for name in ("N_USERS", "N_MOVIES", "N_RATINGS", "SEED", "GAMMA", "MAX_ITER", "INITIAL_STEP", "MAX_STEP",
                 "CAPACITY", "N_FAIR"):
        assert getattr(pv, name) == getattr(jpv, name), name


def _duals(m, which):
    rng = np.random.default_rng(11)
    lam = np.zeros(m + 2, np.float32)
    if which > 0:
        lam[:m] = rng.uniform(0.0, 0.2, m).astype(np.float32)
    lam[m:] = [(0.0, 0.0), (0.0, 0.0), (0.3, 0.0), (0.05, 0.4)][which]
    return lam


@pytest.mark.parametrize("which", range(4), ids=["zero", "rows", "fair_a", "fair_both"])
def test_fairness_calculate_matches_the_jax_package(small_proxy, which):
    port_args, jax_args = small_proxy["lp"][True], small_proxy["jax_lp"][True]
    m = port_args.A.shape[0]
    lam = _duals(m, which)
    obj = ml.FairnessMatchingObjective(port_args, gamma=pv.GAMMA, device="cpu")
    jobj = jml.FairnessMatchingObjective(jax_args, gamma=pv.GAMMA)
    r = obj.calculate(torch.from_numpy(lam))
    jr = jobj.calculate(jnp.asarray(lam))
    got, want = float(r.dual_objective), float(jr.dual_objective)
    assert abs(got - want) <= 1e-6 * abs(want)
    g, jg = r.dual_gradient.numpy(), np.asarray(jr.dual_gradient)
    assert g.shape == (m + 2,)
    np.testing.assert_allclose(g, jg, rtol=1e-6, atol=1e-6 * np.abs(jg).max())
    assert g[-2] == -g[-1] and abs(g[-2]) > 0
    assert abs(float(r.reg_penalty) - float(jr.reg_penalty)) <= 1e-6 * abs(float(jr.reg_penalty))


def test_fairness_solve_through_run_solver_matches_the_jax_log(small_proxy):
    """50 iterations at the proxy's gamma and steps, the whole log within
    1e-5 relative."""
    from dualip_tpu import ComputeArgs as JCompute
    from dualip_tpu import ObjectiveArgs as JObjective
    from dualip_tpu import SolverArgs as JSolver
    from dualip_tpu import run_solver as jax_run_solver

    ml._register_fairness_objective()
    jml._register_fairness_objective()
    kw = dict(max_iter=50, gamma=pv.GAMMA, initial_step_size=pv.INITIAL_STEP, max_step_size=pv.MAX_STEP)
    res = run_solver(small_proxy["lp"][True], SolverArgs(**kw), ComputeArgs(host_device="cpu"),
                     ObjectiveArgs(objective_type="movielens_fairness"))
    jres = jax_run_solver(small_proxy["jax_lp"][True], JSolver(**kw), JCompute(),
                          JObjective(objective_type="movielens_fairness"))
    log, jlog = np.asarray(res.dual_objective_log), np.asarray(jres.dual_objective_log)
    assert len(log) == 50 and np.isfinite(log).all()
    rel = np.abs(log - jlog) / np.abs(jlog)
    assert rel.max() <= 1e-5, rel
    assert res.dual_val.shape == (small_proxy["lp"][True].A.shape[0] + 2,)
    assert res.dual_val.device.type == "cpu"


@pytest.mark.parametrize("kw", [{"layout": "butterfly"}, {"use_pallas": True}, {"mesh": object()}],
                         ids=["butterfly", "use_pallas", "mesh"])
def test_fairness_refuses_what_the_jax_class_refuses(tmp_path, kw):
    args, *_ = ml.prepare_movielens_matching(ml.MovielensMatchingConfig(ratings_csv_path=_csv(tmp_path)))
    ext = ml.make_fairness_input_args(args, [0], [1])
    with pytest.raises(NotImplementedError):
        ml.FairnessMatchingObjective(ext, gamma=0.1, device="cpu", **kw)


def test_fairness_refuses_save_primal(tmp_path):
    args, *_ = ml.prepare_movielens_matching(ml.MovielensMatchingConfig(ratings_csv_path=_csv(tmp_path)))
    obj = ml.FairnessMatchingObjective(ml.make_fairness_input_args(args, [0], [1]), gamma=0.1, device="cpu")
    with pytest.raises(NotImplementedError):
        obj.calculate(torch.zeros(args.A.shape[0] + 2), save_primal=True)


@pytest.mark.parametrize("fairness", [False, True], ids=["plain", "fairness"])
def test_compare_reproduces_the_committed_comparison(tmp_path, fairness):
    """The JAX package's own committed log fed in as ours gives the committed
    comparison JSON's numbers and verdicts."""
    tag = pv._tag(fairness)
    shutil.copy(pv.LOGS / f"{tag}_log.txt", tmp_path / f"{tag}_log.txt")
    summary = pv.compare(fairness, out_dir=tmp_path)
    want = json.loads((pv.LOGS / f"{tag}_comparison.json").read_text())
    for key, value in want.items():
        assert summary[key] == value, key
    assert summary["pass"]
    assert json.loads((tmp_path / f"{tag}_comparison.json").read_text()) == summary
    assert pv.main(["compare", "--out-dir", str(tmp_path)] + (["--fairness"] if fairness else [])) == 0


def test_compare_fails_a_final_outside_the_gate(tmp_path):
    text = (pv.LOGS / "proxy_movies_log.txt").read_text().replace("Dual objective: -637886.75",
                                                                  "Dual objective: -637885.0")
    (tmp_path / "proxy_movies_log.txt").write_text(text)
    assert pv.main(["compare", "--out-dir", str(tmp_path)]) == 1


def test_parse_log_skips_every_line_but_the_iterations(tmp_path):
    p = tmp_path / "log.txt"
    p.write_text("Matching Log\n----\niter=1   dual_objective=-3.5   dual_grad_norm=2.0\niter=2   dual_objective=-2.25\n"
                 "final iter=2   dual_objective=-9.0\nFairness duals: [1.5, 0.0]\nDual objective: -2.25\n"
                 "A shape: (3, 4) nnz: 5 wall: 1s\n")
    got = pv.parse_log(p)
    assert got["trace"].tolist() == [-3.5, -2.25] and got["final"] == -2.25 and got["fair_duals"] == [1.5, 0.0]
    ref = pv.parse_log(pv.LOGS / "proxy_movies_with_fairness_reference_log.txt")
    assert len(ref["trace"]) == 10_000 and ref["final"] == -633543.0625
    assert ref["fair_duals"] == [247.09779357910156, 0.0010584881529211998]


@pytest.mark.parametrize("fairness,layout", [(False, "csc"), (True, "csc")], ids=["csc", "fairness"])
def test_run_ours_writes_a_log_compare_reads(small_proxy, tmp_path, fairness, layout):
    """``run-ours`` on the CPU at the reduced proxy: its log parses back to
    its trace, and its first iterations follow the JAX package's solve."""
    from dualip_tpu.objectives.matching import MatchingSolverDualObjectiveFunction as JaxMatching
    from dualip_tpu.optimizers.agd import AcceleratedGradientDescent as JaxAGD

    iters = 20
    out = pv.run_ours(fairness, iters, "cpu", layout, tmp_path, input_args=small_proxy["lp"][fairness])
    parsed = pv.parse_log(out["log_path"])
    assert np.array_equal(parsed["trace"], out["trace"]) and parsed["final"] == out["final"]
    assert (tmp_path / f"{pv._tag(fairness)}_trace.npz").exists()
    jargs = small_proxy["jax_lp"][fairness]
    jobj = (jml.FairnessMatchingObjective(jargs, gamma=pv.GAMMA) if fairness
            else JaxMatching(jargs, gamma=pv.GAMMA))
    jres = JaxAGD(max_iter=iters, gamma=pv.GAMMA, initial_step_size=pv.INITIAL_STEP,
                  max_step_size=pv.MAX_STEP).maximize(jobj, jnp.zeros(len(np.asarray(jargs.b_vec)), jnp.float32))
    jlog = np.asarray(jres.dual_objective_log)
    assert (np.abs(out["trace"][:10] - jlog[:10]) / np.abs(jlog[:10])).max() <= 1e-5
    if fairness:
        assert parsed["fair_duals"] == out["fair_duals"] and len(out["fair_duals"]) == 2


def test_cli_solves_and_round_trips_a_snapshot(tmp_path):
    path = _csv(tmp_path)
    prefix = str(tmp_path / "snap")
    solve = ["--device", "cpu", "--run_solver", "--max_iter", "20", "--gamma", "0.01"]
    fair = ml.main(["--ratings_csv_path", path, "--fairness_group_a", "0", "--fairness_group_b", "1"] + solve)
    first = ml.main(["--ratings_csv_path", path, "--out_prefix", prefix] + solve)
    again = ml.main(["--in_prefix", prefix] + solve)
    assert np.isfinite(fair.dual_objective) and fair.dual_val.shape == (3 + 2,)
    assert again.dual_objective_log == first.dual_objective_log
