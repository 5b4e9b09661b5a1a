"""The port's device-ready butterfly-layout cache, against the JAX package's
(``tests/test_tile_cache.py``), on the CPU.

Both packages compute the same key; a hit equals a fresh build bit for bit
and skips the layout's build; a float32 entry written by either package serves the
other's objective (1e-6 relative against the JAX objective, the same bound as
the port's other layout tests); bfloat16 entries carry the JAX package's
bytes, and a JAX-written one loads with the JAX build's tiles bit for bit."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dualip_tpu.io.tile_cache import compute_cache_key as jax_key
from dualip_tpu.objectives.matching import (
    MatchingInputArgs as JaxArgs,
    MatchingSolverDualObjectiveFunction as JaxObjective,
    matching_tile_cache_key as jax_matching_key,
)
from dualip_tpu.projections import create_projection_map as jax_pm
from dualip_tpu.sparse import csc_from_dense as jax_csc
from dualip_tpu_torch.io import tile_cache
from dualip_tpu_torch.io.tile_cache import compute_cache_key
from dualip_tpu_torch.objectives.matching import (
    MatchingInputArgs,
    MatchingSolverDualObjectiveFunction,
    matching_tile_cache_key,
)
from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent
from dualip_tpu_torch.projections import create_projection_map
from dualip_tpu_torch.sparse import csc_from_dense

torch.set_num_threads(1)


def _problem(seed=0, m=24, n=512):
    """tests/test_tile_cache.py's problem, for both packages."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((m, n)) < 0.25) * rng.random((m, n)).astype(np.float32)
    empty = np.nonzero(dense.sum(axis=0) == 0)[0]
    dense[rng.integers(0, m, size=empty.size), empty] = 0.5
    cost = np.where(dense != 0, -rng.random((m, n)).astype(np.float32), 0)
    b = rng.random(m).astype(np.float32) * 3
    port = MatchingInputArgs(A=csc_from_dense(dense), c=csc_from_dense(cost),
                             projection_map=create_projection_map("simplex", {"z": 1.0}, n), b_vec=b)
    jax = JaxArgs(A=jax_csc(dense), c=jax_csc(cost), projection_map=jax_pm("simplex", {"z": 1.0}, n), b_vec=b)
    return port, jax


def _build(args, root, cache="tiles", plans="plans", **kw):
    return MatchingSolverDualObjectiveFunction(
        args, gamma=1e-3, layout="butterfly", keep_flat_idx=False, keep_col_tiles=False,
        plan_cache_dir=str(root / plans), tile_cache_dir=str(root / cache), device="cpu", **kw)


def _jax_build(args, root, cache="jax_tiles", **kw):
    return JaxObjective(args, gamma=1e-3, layout="butterfly", keep_flat_idx=False, keep_col_tiles=False,
                        plan_cache_dir=str(root / "jax_plans"), tile_cache_dir=str(root / cache), **kw)


def _lam(m, seed=3):
    return np.abs(np.random.default_rng(seed).normal(size=m)).astype(np.float32)


def _rel(got, want):
    return abs(float(got) - float(want)) / max(1.0, abs(float(want)))


@pytest.mark.parametrize("explicit", [None, "workload-7"])
@pytest.mark.parametrize("dtype,jax_dtype", [(np.float32, np.float32), ("bfloat16", jnp.bfloat16),
                                             (torch.bfloat16, jnp.bfloat16)])
@pytest.mark.parametrize("compact", [False, True])
def test_both_packages_compute_the_same_key(explicit, dtype, jax_dtype, compact):
    port, jax = _problem()
    got = matching_tile_cache_key(port, dtype=dtype, compact=compact, tile_cache_key=explicit)
    assert got == jax_matching_key(jax, dtype=jax_dtype, compact=compact, tile_cache_key=explicit)
    assert got == compute_cache_key(port.A, port.c, port.projection_map, np.int64(1024), dtype, explicit,
                                     extra=f"compact={compact}/batching=True" + ("/g2" if compact else ""))


def test_the_objective_exposes_the_jax_key(tmp_path):
    port, jax = _problem()
    o = _build(port, tmp_path, compact=True, batching=False)
    j = _jax_build(jax, tmp_path, compact=True, batching=False)
    assert o.tile_cache_key == j.tile_cache_key
    assert (tmp_path / "tiles" / f"butterfly_{o.tile_cache_key}" / "meta.json").exists()


def test_key_sensitivity():
    a1, a2 = _problem(seed=0)[0], _problem(seed=2)[0]
    k1 = compute_cache_key(a1.A, a1.c, a1.projection_map, 128, np.float32, None)
    assert k1 != compute_cache_key(a2.A, a2.c, a2.projection_map, 128, np.float32, None)
    assert k1 != compute_cache_key(a1.A, a1.c, a1.projection_map, 128, "bfloat16", None)
    assert k1 != compute_cache_key(a1.A, a1.c, a1.projection_map, 128, np.float32, None, extra="compact=True")
    # the same arrays with another entry -> column assignment
    moved = {k: type(e)(e.proj_type, e.proj_params, list(e.indices)[1:]) for k, e in a1.projection_map.items()}
    assert k1 != compute_cache_key(a1.A, a1.c, moved, 128, np.float32, None)
    # explicit keys skip the content hash but still fold in the layout options
    k3 = compute_cache_key(a1.A, a1.c, a1.projection_map, 128, np.float32, "wk")
    assert k3 == compute_cache_key(a2.A, a2.c, a2.projection_map, 128, np.float32, "wk")
    assert k3 != compute_cache_key(a1.A, a1.c, a1.projection_map, 256, np.float32, "wk")
    assert k3 == jax_key(a1.A, a1.c, a1.projection_map, 128, np.float32, "wk")


def test_hit_skips_the_layout_build(tmp_path, monkeypatch):
    port, _ = _problem(seed=1)
    cold = _build(port, tmp_path)

    import dualip_tpu_torch.objectives.matching as mm
    import dualip_tpu_torch.sparse.rowmajor as rm

    def _boom(*a, **k):
        raise AssertionError("layout built despite a cache hit")

    monkeypatch.setattr(mm, "build_blockcsc", _boom)
    monkeypatch.setattr(rm, "build_row_layout", _boom)
    warm = _build(port, tmp_path)
    assert len(warm.row_layout.col_tiles_T) == len(cold.row_layout.col_tiles_T) > 0
    assert warm.tile_cache_key == cold.tile_cache_key
    assert warm.panel_table is not None and warm.bcsc.specs == cold.bcsc.specs
    with pytest.raises(AssertionError, match="cache hit"):  # the options are in the key: a miss builds
        _build(port, tmp_path, compact=True)


@pytest.mark.parametrize("kw", [{}, {"compact": True}, {"srow_gather": True}, {"dtype": "bfloat16"}])
def test_cold_and_warm_dual_logs_are_bit_identical(tmp_path, kw):
    port, _ = _problem(seed=4)
    m = port.A.shape[0]
    cold, warm = _build(port, tmp_path, **kw), _build(port, tmp_path, **kw)
    assert warm.row_layout.build_seconds["route"] == 0.0  # loaded, not routed
    logs = []
    for obj in (cold, warm):
        solver = AcceleratedGradientDescent(max_iter=12, gamma=1e-3, initial_step_size=1e-3, max_step_size=1e-1)
        logs.append(solver.maximize(obj, torch.zeros(m)).dual_objective_log)
    assert logs[0] == logs[1] and len(logs[0]) == 12


def test_a_jax_entry_serves_the_port_and_a_port_entry_the_jax_package(tmp_path):
    port, jax = _problem(seed=5)
    lam = _lam(port.A.shape[0])
    j_cold = _jax_build(jax, tmp_path, cache="shared")  # the JAX package writes the entry
    p_warm = _build(port, tmp_path, cache="shared")  # the port reads it
    assert p_warm.row_layout.plan_cache_path.startswith(str(tmp_path / "jax_plans"))
    want = j_cold.calculate(jnp.asarray(lam))
    got = p_warm.calculate(torch.from_numpy(lam))
    assert _rel(got.dual_objective, want.dual_objective) <= 1e-6
    grad, g_want = got.dual_gradient.numpy(), np.asarray(want.dual_gradient)
    assert np.abs(grad - g_want).max() <= 1e-6 * max(1.0, np.abs(g_want).max())

    p_cold = _build(port, tmp_path, cache="port")  # the port writes an entry
    j_warm = _jax_build(jax, tmp_path, cache="port")  # the JAX package reads it
    assert _rel(j_warm.calculate(jnp.asarray(lam)).dual_objective,
                p_cold.calculate(torch.from_numpy(lam)).dual_objective) <= 1e-6


def _entry(root, key):
    return root / f"butterfly_{key}"


@pytest.mark.parametrize("compact", [False, True])
def test_bf16_entries_carry_the_jax_bytes(tmp_path, compact):
    """The JAX package's bf16 entry (its panels as ``<V2`` bf16 bits) loads in
    the port with the JAX build's tiles bit for bit, and the port's own entry
    holds the same bytes and round-trips."""
    port, jax = _problem(seed=6)
    j = _jax_build(jax, tmp_path, dtype=jnp.bfloat16, compact=compact)
    from_jax = _build(port, tmp_path, cache="jax_tiles", dtype="bfloat16", compact=compact)
    own = _build(port, tmp_path, dtype="bfloat16", compact=compact)
    again = _build(port, tmp_path, dtype="bfloat16", compact=compact)
    assert from_jax.bcsc.value_dtype == torch.bfloat16 == again.bcsc.value_dtype
    for jt, pt, ot, at in zip(j.row_layout.col_tiles_T, from_jax.row_layout.col_tiles_T,
                              own.row_layout.col_tiles_T, again.row_layout.col_tiles_T):
        for jv, pv, ov, av in zip(jt, pt, ot, at):
            jv = np.asarray(jv)
            want = jv.view(np.int16) if jv.dtype.name == "bfloat16" else jv
            for t in (pv, ov, av):
                assert t.dtype == (torch.bfloat16 if jv.dtype.name == "bfloat16" else torch.int32)
                got = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
                assert np.array_equal(got.numpy(), want)
    d_jax, d_port = _entry(tmp_path / "jax_tiles", j.tile_cache_key), _entry(tmp_path / "tiles", own.tile_cache_key)
    files = sorted(p.name for p in d_jax.iterdir())
    assert files == sorted(p.name for p in d_port.iterdir())
    for name in files:
        if name == "meta.json":  # the same but for the plan file's path
            mj, mp = (json.loads((d / name).read_text()) for d in (d_jax, d_port))
            mj.pop("plan_cache_file"), mp.pop("plan_cache_file")
            assert mj == mp
        else:
            assert (d_jax / name).read_bytes() == (d_port / name).read_bytes(), name
    lam = torch.from_numpy(_lam(port.A.shape[0]))
    assert float(own.calculate(lam).dual_objective) == float(again.calculate(lam).dual_objective) \
        == float(from_jax.calculate(lam).dual_objective)


def test_what_does_not_use_the_cache(tmp_path):
    port, _ = _problem(seed=7)
    # no plan-cache file: nothing to point the entry at, so nothing is written
    o = MatchingSolverDualObjectiveFunction(port, gamma=1e-3, layout="butterfly", keep_flat_idx=False,
                                            keep_col_tiles=False, tile_cache_dir=str(tmp_path / "a"), device="cpu")
    assert o.tile_cache_key is not None and not (tmp_path / "a").exists()
    # other layouts and the options that keep more than the hot path ignore it
    for kw in ({"layout": "csc"}, {"layout": "row"}, {"layout": "butterfly", "keep_flat_idx": True}):
        o = MatchingSolverDualObjectiveFunction(port, gamma=1e-3, keep_col_tiles=False,
                                                tile_cache_dir=str(tmp_path / "b"), device="cpu",
                                                **{"keep_flat_idx": False, **kw})
        assert o.tile_cache_key is None
    assert not (tmp_path / "b").exists()


def test_a_sharded_entry_names_the_distributed_slice(tmp_path):
    port, _ = _problem(seed=8)
    o = _build(port, tmp_path)
    d = _entry(tmp_path / "tiles", o.tile_cache_key)
    meta = json.loads((d / "meta.json").read_text())
    with pytest.raises(NotImplementedError, match="distributed"):
        tile_cache.save_butterfly_state(tmp_path / "x", "k", o.bcsc, o.row_layout, ["p0", "p1"], n_shards=2)
    (d / "meta.json").write_text(json.dumps({**meta, "n_shards": 2}))
    with pytest.raises(NotImplementedError, match="distributed"):
        tile_cache.load_butterfly_state(tmp_path / "tiles", o.tile_cache_key, "cpu")
    (d / "meta.json").write_text(json.dumps({**meta, "version": 0}))
    assert tile_cache.load_butterfly_state(tmp_path / "tiles", o.tile_cache_key, "cpu") is None


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_a_loaded_layout_saves_the_bytes_it_was_loaded_from(tmp_path, dtype):
    """``save_butterfly_state`` copies the leaves back from the placed layout:
    the layout a hit placed, saved again, gives the entry it came from byte
    for byte, and the cold build's save timed its copy and its write."""
    port, _ = _problem(seed=9)
    cold = _build(port, tmp_path, dtype=dtype)
    assert {"tile_cache_copy_s", "tile_cache_write_s"} <= set(cold.row_layout.build_seconds)
    warm = _build(port, tmp_path, dtype=dtype)
    key = warm.tile_cache_key
    secs = tile_cache.save_butterfly_state(tmp_path / "again", key, warm.bcsc, warm.row_layout,
                                           warm.row_layout.plan_cache_path)
    assert secs["copy_s"] >= 0 and secs["write_s"] >= 0
    d1, d2 = _entry(tmp_path / "tiles", key), _entry(tmp_path / "again", key)
    names = sorted(p.name for p in d1.iterdir())
    assert names == sorted(p.name for p in d2.iterdir())
    assert all((d1 / n).read_bytes() == (d2 / n).read_bytes() for n in names)
