"""The port's tile builder and synthetic generator give the JAX package's
arrays element for element; the projections agree at fp32 tolerance."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmark.generate_synthetic_data import _generate_matching_numpy as jax_generate
from dualip_tpu.objectives.matching import transpose_tiles as jax_transpose_tiles
from dualip_tpu.projections import create_projection_map as jax_pm
from dualip_tpu.projections.base import project as jax_project
from dualip_tpu.sparse import build_blockcsc as jax_build, csc_from_dense as jax_csc
from dualip_tpu_torch.objectives.matching import transpose_tiles
from dualip_tpu_torch.projections import create_projection_map
from dualip_tpu_torch.projections.base import project
from dualip_tpu_torch.sparse import blockcsc_from_numpy, build_blockcsc, csc_from_dense, device_put_blockcsc
from dualip_tpu_torch.synthetic import _generate_matching_numpy

torch.set_num_threads(1)


def _problem(seed=0, m=40, n=150):
    rng = np.random.default_rng(seed)
    dense = np.abs(rng.normal(size=(m, n))).astype(np.float32)
    dense[rng.random(size=(m, n)) < 0.8] = 0.0
    dense[:, 5] = 0.0  # an empty column
    dense[:, 7] = np.abs(rng.normal(size=m)) + 0.1  # a full column (top bucket)
    return dense


def _maps(module_pm, n):
    pm = module_pm("simplex", {"z": 1.0}, n, indices=list(range(0, 60)))
    pm.update(module_pm("box", {"lower": 0.0, "upper": 0.5}, n, indices=list(range(60, 100))))
    return pm  # columns 100.. are uncovered: identity


def _assert_tiles_equal(port, ref):
    assert (port.m, port.n, port.nnz) == (ref.m, ref.n, ref.nnz)
    assert len(port.tiles) == len(ref.tiles)
    for tp, tr, sp, sr in zip(port.tiles, ref.tiles, port.specs, ref.specs):
        assert (sp.entry_key, sp.proj_type, sp.proj_params, sp.K, sp.L) == (
            sr.entry_key, sr.proj_type, sr.proj_params, sr.K, sr.L
        )
        np.testing.assert_array_equal(sp.flat_idx, sr.flat_idx)
        for name in ("rows", "a", "c", "length", "col_ids"):
            got = getattr(tp, name)
            got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
            want = np.asarray(getattr(tr, name))
            if name == "rows":
                assert got.dtype == np.int32
                want = want.astype(np.int32)  # JAX stores uint16 for m <= 65535
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("batching", [True, False])
@pytest.mark.parametrize("pad", [1, 64])
def test_build_blockcsc_matches_jax(batching, pad):
    dense = _problem()
    n = dense.shape[1]
    ref = jax_build(jax_csc(dense), jax_csc(-dense), _maps(jax_pm, n), batching=batching, pad_cols_to=pad)
    port = build_blockcsc(
        csc_from_dense(dense), csc_from_dense(-dense), _maps(create_projection_map, n),
        batching=batching, pad_cols_to=pad,
    )
    _assert_tiles_equal(port, ref)
    _assert_tiles_equal(transpose_tiles(port), jax_transpose_tiles(ref))


def test_blockcsc_from_numpy_widens_jax_tiles():
    dense = _problem(seed=1)
    n = dense.shape[1]
    ref = jax_build(jax_csc(dense), jax_csc(-dense), _maps(jax_pm, n), pad_cols_to=8)
    assert ref.tiles[0].rows.dtype == np.uint16
    got = blockcsc_from_numpy(ref.tiles, ref.specs, ref.m, ref.n, ref.nnz, device="cpu")
    assert got.tiles[0].rows.dtype == torch.int32
    _assert_tiles_equal(got, ref)
    own = device_put_blockcsc(
        build_blockcsc(csc_from_dense(dense), csc_from_dense(-dense), _maps(create_projection_map, n), pad_cols_to=8),
        "cpu",
    )
    _assert_tiles_equal(own, ref)


def test_build_blockcsc_rejects_exact_bucketing():
    """Exact bucketing is the compact layout's column rule now; what the
    function rejects is a bucketing it does not know, as the JAX package does."""
    dense = _problem()
    n = dense.shape[1]
    with pytest.raises(ValueError, match="Unknown bucketing"):
        build_blockcsc(csc_from_dense(dense), csc_from_dense(-dense), {}, bucketing="geometric")
    with pytest.raises(ValueError, match="Unknown bucketing"):
        jax_build(jax_csc(dense), jax_csc(-dense), {}, bucketing="geometric")
    ref = jax_build(jax_csc(dense), jax_csc(-dense), _maps(jax_pm, n), bucketing="exact")
    port = build_blockcsc(csc_from_dense(dense), csc_from_dense(-dense), _maps(create_projection_map, n), bucketing="exact")
    _assert_tiles_equal(port, ref)
    assert len({s.L for s in port.specs if s.entry_key == port.specs[0].entry_key}) > 2  # a tile per distinct degree


def test_synthetic_generator_matches_benchmark():
    got = _generate_matching_numpy(3000, 60, 0.05, np.random.default_rng(42))
    want = jax_generate(3000, 60, 0.05, np.random.default_rng(42))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind,params", [
    ("simplex", {"z": 1.0}),
    ("simplex", {"z": 2.0, "method": "bisection_search"}),
    ("simplex_eq", {"z": 1.5}),
    ("simplex_eq", {"z": 1.0, "method": "bisection_search"}),
    ("box", {"l": -0.5, "u": 0.5}),
    ("box", {"lower": float("nan"), "upper": 0.25}),
    ("cone", {"lower": 0.1}),
    ("box_cut", {"lower": 0.0, "upper": 0.6, "z": 1.0}),
    ("box_cut_eq", {"lower": 0.0, "upper": 1.0, "z": 2.0}),
])
def test_projection_matches_jax(kind, params):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, 8)).astype(np.float32) * 2
    x[:4] = np.abs(x[:4]) * 0.05  # some feasible (pass-through) rows
    want = np.asarray(jax_project(kind, **params)(jnp.asarray(x)))
    got = project(kind, **params)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
