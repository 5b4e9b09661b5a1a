"""The port's synthetic generator: its disk cache and its backends, against
the benchmark generator of the JAX package, on the CPU.

For each backend a warm load equals the cold arrays exactly (dtypes and
values), the memmap tier keeps the edge arrays on disk, and an entry written
by either package loads in the other with equal arrays.  Backends that need
the native library skip where no C++ compiler builds it."""

import numpy as np
import pytest

from benchmark.generate_synthetic_data import generate_synthetic_matching_input_args as jax_generate
from dualip_tpu_torch.io import native_loader
from dualip_tpu_torch.synthetic import _cache_path, generate_synthetic_matching_input_args as generate

SHAPE = (3000, 50, 0.05)
BACKENDS = ["numpy", "native", "native-stream"]


def _fields(args):
    return [args.A.indptr, args.A.row_indices, args.A.data, args.c.data, args.b_vec]


def _equal(got, want):
    for g, w in zip(_fields(got), _fields(want)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got.A.shape == want.A.shape


@pytest.fixture(params=BACKENDS)
def backend(request, monkeypatch):
    if request.param != "numpy" and not native_loader.native_available():
        pytest.skip("no C++ toolchain builds native/dualip_native.cc")
    monkeypatch.setenv("DUALIP_GEN_BACKEND", request.param)
    return request.param


@pytest.mark.parametrize("memmap", ["0", "1"])
def test_warm_load_equals_the_cold_arrays(tmp_path, monkeypatch, backend, memmap):
    monkeypatch.setenv("DUALIP_GEN_MEMMAP", memmap)
    cold = generate(*SHAPE, seed=3, cache_dir=tmp_path)
    entries = list(tmp_path.iterdir())
    assert len(entries) == 1
    path = _cache_path(tmp_path, *SHAPE, np.float32, (3, backend))
    on_disk = memmap == "1" or backend == "native-stream"  # the streaming generator writes the memmap tier
    assert entries[0] == (path.with_suffix(".mm") if on_disk else path)
    warm = generate(*SHAPE, seed=3, cache_dir=tmp_path)
    _equal(warm, cold)
    assert cold.A.data.dtype == np.float32 and cold.b_vec.dtype == np.float32
    if on_disk:  # A's values stay mapped read-only from the file: no astype copy on the way in
        assert not warm.A.data.flags.writeable and not warm.A.indptr.flags.writeable
    if backend == "numpy":
        _equal(cold, generate(*SHAPE, seed=3, rng=np.random.default_rng(3)))  # uncached, same stream


def test_backends_differ_and_keys_keep_them_apart(tmp_path, monkeypatch):
    if not native_loader.native_available():
        pytest.skip("no C++ toolchain builds native/dualip_native.cc")
    out = {}
    for be in ("numpy", "native"):
        monkeypatch.setenv("DUALIP_GEN_BACKEND", be)
        out[be] = generate(*SHAPE, seed=3, cache_dir=tmp_path)
    assert len(list(tmp_path.iterdir())) == 2
    assert out["numpy"].A.nnz != out["native"].A.nnz
    monkeypatch.setenv("DUALIP_GEN_BACKEND", "native-buffered")
    with pytest.raises(ValueError, match="DUALIP_GEN_BACKEND"):
        generate(*SHAPE, seed=3, cache_dir=tmp_path)


@pytest.mark.parametrize("memmap", ["0", "1"])
def test_entries_are_shared_with_the_benchmark_generator(tmp_path, monkeypatch, backend, memmap):
    monkeypatch.setenv("DUALIP_GEN_MEMMAP", memmap)
    jax_cold = jax_generate(*SHAPE, seed=4, cache_dir=str(tmp_path / "jax"))
    _equal(generate(*SHAPE, seed=4, cache_dir=tmp_path / "jax"), jax_cold)  # the port reads its entry
    port_cold = generate(*SHAPE, seed=4, cache_dir=tmp_path / "port")
    _equal(jax_generate(*SHAPE, seed=4, cache_dir=str(tmp_path / "port")), port_cold)  # and the reverse
    _equal(port_cold, jax_cold)
    names = lambda d: sorted(p.name for p in d.iterdir())  # noqa: E731
    assert names(tmp_path / "jax") == names(tmp_path / "port")


def test_a_torn_npz_is_a_miss(tmp_path, monkeypatch):
    """An entry another process is still writing reads as a miss and is
    written again whole."""
    monkeypatch.setenv("DUALIP_GEN_BACKEND", "numpy")
    monkeypatch.setenv("DUALIP_GEN_MEMMAP", "0")
    path = _cache_path(tmp_path, *SHAPE, np.float32, (5, "numpy"))
    tmp_path.mkdir(exist_ok=True)
    path.write_bytes(b"PK\x03\x04 not a whole zip")
    got = generate(*SHAPE, seed=5, cache_dir=tmp_path)
    _equal(generate(*SHAPE, seed=5, cache_dir=tmp_path), got)
    assert path.stat().st_size > 1000


def test_the_disk_is_touched_only_where_a_cache_directory_is_named(tmp_path, monkeypatch, backend):
    """Without ``cache_dir`` or ``DUALIP_BENCH_CACHE`` a seeded call writes
    nothing (the streaming backend, which needs the memmap tier, refuses);
    ``DUALIP_BENCH_CACHE`` names the directory as ``cache_dir`` does."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DUALIP_BENCH_CACHE", raising=False)
    if backend == "native-stream":
        with pytest.raises(ValueError, match="cache_dir"):
            generate(*SHAPE, seed=6)
    else:
        pure = generate(*SHAPE, seed=6)
        assert list(tmp_path.iterdir()) == []
        monkeypatch.setenv("DUALIP_BENCH_CACHE", str(tmp_path / "env"))
        _equal(generate(*SHAPE, seed=6), pure)
        _equal(generate(*SHAPE, seed=6, cache_dir=tmp_path / "arg"), pure)
        names = lambda d: sorted(p.name for p in d.iterdir())  # noqa: E731
        assert names(tmp_path / "env") == names(tmp_path / "arg") and len(names(tmp_path / "arg")) == 1
