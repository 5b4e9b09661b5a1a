"""A rank's own part of the entity-sharded csc tiles
(``sparse/bcsc.py::build_blockcsc(..., shard=(d, D))``), on the CPU: element
for element the whole build cut to the rank's columns
(``sparse/rowmajor.py::_slice_bcsc_cols``), transposed or not, through the
numpy fill and the native one, from inputs it only reads."""

import numpy as np
import pytest

from dualip_tpu_torch.io import native_loader
from dualip_tpu_torch.objectives.matching import transpose_tiles
from dualip_tpu_torch.projections.base import ProjectionEntry
from dualip_tpu_torch.sparse import bcsc as bcsc_mod
from dualip_tpu_torch.sparse import csc_from_dense
from dualip_tpu_torch.sparse.rowmajor import _slice_bcsc_cols
from dualip_tpu_torch.utils import profiling

FIELDS = ("rows", "a", "c", "length", "col_ids")


def _problem(seed=5, m=30, n=403):
    """Columns of degree 0 to about 12 (empty ones left out of the tiles),
    the last 40 in no entry (the ``__identity__`` tiles)."""
    rng = np.random.default_rng(seed)
    a = ((rng.random((m, n)) < rng.random(n) * 0.4) * rng.random((m, n))).astype(np.float32)
    a[:, [3, 200, 401]] = 0.0
    A = csc_from_dense(a)
    C = A._replace(data=-(A.data + 0.25).astype(np.float32))
    pm = {"simplex": ProjectionEntry("simplex", {"z": 1.0}, np.arange(n - 40))}
    return A, C, pm


def _read_only(A):
    for x in (A.indptr, A.row_indices, A.data):
        x.flags.writeable = False
    return A


def _same_tiles(got, want):
    assert len(got.tiles) == len(want.tiles) and got.transposed == want.transposed
    for i, (g, w) in enumerate(zip(got.tiles, want.tiles)):
        for f in FIELDS:
            x, y = np.asarray(getattr(g, f)), np.asarray(getattr(w, f))
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), f"tile {i} {f}"


@pytest.fixture
def store(monkeypatch):
    fresh = profiling.Store()
    monkeypatch.setattr(profiling, "STORE", fresh)
    return fresh


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("fill", ["numpy", "native"])
@pytest.mark.parametrize("ws", [2, 4])
def test_a_shard_is_the_whole_builds_slice(monkeypatch, ws, fill, dtype):
    """Every rank's shard equals the whole build's slice, and so does its
    transpose; its specs are the whole build's but for flat_idx, the slab
    of the whole one.  The last ranks' slabs hold padding columns."""
    if fill == "native" and not native_loader.native_available():
        pytest.skip("no C++ toolchain builds native/dualip_native.cc")
    calls = []
    real = native_loader.fill_tile_native
    monkeypatch.setattr(native_loader, "fill_tile_native", lambda *a, **k: calls.append(a[5]) or real(*a, **k))
    monkeypatch.setattr(bcsc_mod, "NATIVE_FILL_SLOTS", 1 if fill == "native" else 1 << 62)
    A, C, pm = _problem()
    _read_only(A)
    whole = bcsc_mod.build_blockcsc(A, C, pm, pad_cols_to=8 * ws, dtype=dtype)
    assert "__identity__" in {s.entry_key for s in whole.specs} and len(whole.tiles) > 4
    assert len(calls) == (len(whole.tiles) if fill == "native" else 0)
    padding = 0
    for d in range(ws):
        del calls[:]
        mine = bcsc_mod.build_blockcsc(A, C, pm, pad_cols_to=8 * ws, dtype=dtype, shard=(d, ws))
        want = _slice_bcsc_cols(whole, d, ws)
        _same_tiles(mine, want)
        _same_tiles(transpose_tiles(mine), _slice_bcsc_cols(transpose_tiles(whole), d, ws))
        assert (mine.m, mine.n, mine.nnz, mine.value_dtype) == (whole.m, whole.n, whole.nnz, whole.value_dtype)
        assert calls == ([s.K // ws for s in whole.specs] if fill == "native" else [])
        for s_mine, s_whole in zip(mine.specs, whole.specs):
            assert s_mine == s_whole  # flat_idx is left out of the comparison
            k = s_whole.K // ws
            np.testing.assert_array_equal(s_mine.flat_idx, s_whole.flat_idx[d * k:(d + 1) * k])
        padding += sum(int((np.asarray(t.col_ids) < 0).sum()) for t in mine.tiles)
    assert padding == sum(s.K for s in whole.specs) - int((A.col_lengths > 0).sum())


def test_a_shard_without_flat_idx_and_of_one_tile_an_entry():
    A, C, pm = _problem(seed=8)
    whole = bcsc_mod.build_blockcsc(A, C, pm, batching=False, pad_cols_to=6, keep_flat_idx=False)
    for d in range(3):
        mine = bcsc_mod.build_blockcsc(A, C, pm, batching=False, pad_cols_to=6, keep_flat_idx=False, shard=(d, 3))
        _same_tiles(mine, _slice_bcsc_cols(whole, d, 3))
        assert all(s.flat_idx is None for s in mine.specs)


def test_a_shard_leaves_its_inputs_as_they_were():
    A, C, pm = _problem(seed=2)
    before = [x.copy() for x in (A.indptr, A.row_indices, A.data, C.data)]
    _read_only(A)  # a write would raise
    C.data.flags.writeable = False
    bcsc_mod.build_blockcsc(A, C, pm, pad_cols_to=4, shard=(3, 4))
    for x, y in zip(before, (A.indptr, A.row_indices, A.data, C.data)):
        np.testing.assert_array_equal(x, y)


def test_a_shard_needs_every_K_to_divide():
    A, C, pm = _problem()
    with pytest.raises(ValueError, match="not divisible by 2 shards"):
        bcsc_mod.build_blockcsc(A, C, pm, pad_cols_to=3, shard=(0, 2))


@pytest.mark.parametrize("ws", [2, 4])
def test_shard_counters_count_a_ranks_slab(store, ws):
    """``dualip.build.shard_columns`` and ``.shard_slots`` add K / D and
    K * L / D a tile; a whole build counts neither."""
    A, C, pm = _problem()
    whole = bcsc_mod.build_blockcsc(A, C, pm, pad_cols_to=8 * ws)
    assert profiling.counter("dualip.build.shard_columns") == profiling.counter("dualip.build.shard_slots") == 0
    bcsc_mod.build_blockcsc(A, C, pm, pad_cols_to=8 * ws, shard=(ws - 1, ws))
    assert profiling.counter("dualip.build.shard_columns") == sum(s.K for s in whole.specs) // ws
    assert profiling.counter("dualip.build.shard_slots") == sum(s.K * s.L for s in whole.specs) // ws


TINY = {"num_sources": 3000, "num_destinations": 40, "target_sparsity": 0.1, "destination_seed": 42}


@pytest.mark.parametrize("part", [None, 0, 3])
def test_the_sharded_generator_draws_upstream_synthetics_law(part):
    """``gpubench/generators/upstream_synthetic_sharded.py`` gives
    ``upstream_synthetic``'s arrays, whole and in parts, bit for bit."""
    import importlib

    import torch

    sharded = importlib.import_module("gpubench.generators.upstream_synthetic_sharded")
    plain = importlib.import_module("gpubench.generators.upstream_synthetic")
    seed = 2**31 + 77
    if part is None:
        got, want = sharded.generate(TINY, seed, "cpu"), plain.generate(TINY, seed, "cpu")
    else:
        got, want = sharded.generate_part(TINY, seed, "cpu", part, 4), plain.generate_part(TINY, seed, "cpu", part, 4)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert sharded.budget is plain.budget


@pytest.mark.parametrize("part", [None, 1])
def test_the_sharded_generator_refuses_a_program_without_the_local_build(monkeypatch, part):
    """A program whose tile build takes no ``shard`` (each rank would build
    the whole problem) is refused before anything is drawn."""
    import importlib

    sharded = importlib.import_module("gpubench.generators.upstream_synthetic_sharded")
    plain = importlib.import_module("gpubench.generators.upstream_synthetic")
    drawn = []
    monkeypatch.setattr(plain, "destination_side", lambda *a: drawn.append(a))
    whole_only = lambda A, C, projection_map, batching=True, pad_cols_to=1: None  # noqa: E731
    monkeypatch.setattr(bcsc_mod, "build_blockcsc", whole_only)
    with pytest.raises(RuntimeError, match="rank-local tile build"):
        if part is None:
            sharded.generate(TINY, 5, "cpu")
        else:
            sharded.generate_part(TINY, 5, "cpu", part, 4)
    assert drawn == []
