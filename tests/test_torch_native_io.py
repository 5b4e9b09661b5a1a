"""The port's native data-plane bindings against the JAX package's, on the CPU.

Every binding returns the JAX binding's arrays bit for bit at equal arguments
(dtypes, shapes, values): the buffered and the streaming generator, and the
tile fill, which also equals the port's numpy fill element for element.
Skipped only where no C++ compiler builds the library, as the JAX tests are."""

import numpy as np
import pytest

from dualip_tpu.io import native_loader as jax_native
from dualip_tpu_torch.io import native_loader
from dualip_tpu_torch.projections import create_projection_map
from dualip_tpu_torch.sparse import bcsc as bcsc_mod
from dualip_tpu_torch.sparse import csc_from_arrays
from dualip_tpu_torch.synthetic import _generate_matching_numpy


@pytest.fixture(scope="module")
def native():
    if not (native_loader.native_available() and jax_native.native_available()):
        pytest.skip("no C++ toolchain builds native/dualip_native.cc")


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("sources,destinations,sparsity,seed", [(3000, 100, 0.05, 11), (5000, 40, 0.1, 3)])
def test_buffered_generator_is_the_jax_binding(native, sources, destinations, sparsity, seed):
    got = native_loader.generate_matching_native(sources, destinations, sparsity, seed=seed)
    _same(got, jax_native.generate_matching_native(sources, destinations, sparsity, seed=seed))
    indptr, rows, a, c, b = got
    assert indptr[-1] == rows.size > 0 and (c > 0).all() and (c <= 0.5).all() and (b > 0).all()


def test_streaming_generator_is_the_jax_binding(native, tmp_path):
    got = native_loader.generate_matching_stream_native(4000, 60, 0.05, seed=5, mm_dir=tmp_path / "port")
    want = jax_native.generate_matching_stream_native(4000, 60, 0.05, seed=5, mm_dir=tmp_path / "jax")
    _same(got, want)
    assert all(isinstance(x, np.memmap) for x in got)
    for k in ("ccol", "rows", "a", "c", "b"):  # the files themselves, byte for byte
        assert (tmp_path / "port" / f"{k}.npy").read_bytes() == (tmp_path / "jax" / f"{k}.npy").read_bytes()
    assert native_loader.generate_matching_stream_native(10, 5, 0.5, seed=1, mm_dir=tmp_path / "x",
                                                         dtype=np.float64) is None


def _matrix(seed=0):
    ccol, rows, a, c, _ = _generate_matching_numpy(3000, 50, 0.05, np.random.default_rng(seed))
    return csc_from_arrays(ccol, rows, a.astype(np.float32), (50, 3000)), (-c).astype(np.float32)


@pytest.mark.parametrize("keep_flat_idx", [True, False])
def test_fill_tile_is_the_jax_binding_and_the_numpy_fill(native, monkeypatch, keep_flat_idx):
    A, c = _matrix()
    C = A._replace(data=c)
    pm = create_projection_map("simplex", {"z": 1.0}, A.shape[1])
    # the numpy fill everywhere: a threshold no tile reaches
    monkeypatch.setattr(bcsc_mod, "NATIVE_FILL_SLOTS", 1 << 62)
    host = bcsc_mod.build_blockcsc(A, C, pm, pad_cols_to=128, keep_flat_idx=keep_flat_idx)
    assert len(host.tiles) > 2
    for tile, spec in zip(host.tiles, host.specs):
        cols = np.asarray(tile.col_ids)
        cols = cols[cols >= 0].astype(np.int64)
        args = (A.indptr, A.row_indices, A.data, C.data, cols, spec.K, spec.L, keep_flat_idx)
        got = native_loader.fill_tile_native(*args)
        _same(got, jax_native.fill_tile_native(*args))
        _same(got, (tile.rows, tile.a, tile.c, tile.length, tile.col_ids, spec.flat_idx))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_build_blockcsc_takes_the_native_fill_at_the_threshold(native, monkeypatch, dtype):
    """Every tile filled natively (threshold 1) equals every tile filled by
    numpy, bf16 tiles included (rounded after the fill)."""
    A, c = _matrix(seed=1)
    C = A._replace(data=c)
    pm = create_projection_map("simplex", {"z": 1.0}, A.shape[1])
    calls = []
    real = native_loader.fill_tile_native
    monkeypatch.setattr(native_loader, "fill_tile_native", lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(bcsc_mod, "NATIVE_FILL_SLOTS", 1)
    nat = bcsc_mod.build_blockcsc(A, C, pm, pad_cols_to=128, dtype=dtype)
    assert len(calls) == len(nat.tiles)
    monkeypatch.setattr(bcsc_mod, "NATIVE_FILL_SLOTS", 1 << 62)
    ref = bcsc_mod.build_blockcsc(A, C, pm, pad_cols_to=128, dtype=dtype)
    assert len(calls) == len(nat.tiles)
    for t_n, t_r, s_n, s_r in zip(nat.tiles, ref.tiles, nat.specs, ref.specs):
        _same(t_n, t_r)
        assert s_n == s_r and np.array_equal(s_n.flat_idx, s_r.flat_idx)


def test_fill_tile_refuses_a_column_longer_than_L(native):
    A, c = _matrix()
    longest = int(np.argmax(A.col_lengths))
    with pytest.raises(ValueError, match="more than L"):
        native_loader.fill_tile_native(A.indptr, A.row_indices, A.data, c, np.array([longest]), 128,
                                       int(A.col_lengths[longest]) - 1, False)
