"""The fused tile kernel's plain version (the CPU path of
``fused_tile_eval_T``) against the JAX package's Pallas kernel in interpret
mode, on the same numpy inputs.

Tolerances are those of ``tests/ops/test_pallas_matching.py``: a*x and x
within ``5e-5 * max(1, max|x|)``; the sums within rtol 1e-4, atol 1e-3 (the
two reduce in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dualip_tpu.ops.pallas_matching import fused_tile_eval_T as jax_fused
from dualip_tpu_torch.utils import profiling
from dualip_tpu_torch.ops.fused_matching import (
    fused_tile_eval_T,
    fused_tile_gather_eval_T,
    fused_tile_gather_eval_T_reference,
    k1_path,
    num_partial_blocks,
)

torch.set_num_threads(1)

CASES = [
    ("simplex", (("z", 1.0),)),
    ("simplex", (("z", 2.5),)),
    ("simplex_eq", (("z", 1.0),)),
    ("box", (("lower", 0.0), ("upper", 1.0))),
    ("box", ()),
    ("box", (("l", -0.5), ("u", 0.5))),
    ("box", (("lower", float("nan")), ("upper", 0.25))),
    ("cone", (("lower", 0.0),)),
    ("cone", (("u", 0.1),)),
    ("identity", ()),
    ("box_cut", (("lower", 0.0), ("upper", 0.6), ("z", 1.0))),
    ("box_cut_eq", (("l", 0.0), ("u", 1.0), ("z", 2.0))),
]


def _random_tile(rng, L, K, m):
    a = np.abs(rng.normal(size=(L, K))).astype(np.float32)
    c = -np.abs(rng.normal(size=(L, K))).astype(np.float32)
    length = rng.integers(1, L + 1, size=K).astype(np.int32)
    length[-3:] = 0  # padding columns
    mask = np.arange(L)[:, None] < length[None, :]
    a = np.where(mask, a, 0).astype(np.float32)
    c = np.where(mask, c, 0).astype(np.float32)
    rows = rng.integers(0, m, size=(L, K)).astype(np.int32)
    return a, c, length, rows


def _compare(kind, params, L, K, want_x, scale=100.0):
    rng = np.random.default_rng(0)
    m = 64
    a, c, length, rows = _random_tile(rng, L, K, m)
    lam = np.abs(rng.normal(size=m)).astype(np.float32)
    nig = np.float32(-scale)
    lam_g = (nig * lam)[rows]

    ref = jax_fused(
        jnp.asarray(lam_g), jnp.asarray(a), jnp.asarray(c), jnp.asarray(length),
        nig, kind, params, block_k=min(512, K), interpret=True, want_x=want_x,
    )
    got = fused_tile_eval_T(
        torch.from_numpy(lam_g), torch.from_numpy(a), torch.from_numpy(c), torch.from_numpy(length),
        float(nig), kind, params, block_k=min(512, K), want_x=want_x,
    )
    assert len(got) == len(ref)
    x_ref = np.asarray(ref[3]) if want_x else None
    scale_x = max(1.0, float(np.abs(x_ref).max())) if want_x else max(1.0, float(np.abs(np.asarray(ref[0])).max()))
    tol = 5e-5 * scale_x
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=tol)
    assert np.isclose(float(got[1]), float(ref[1]), rtol=1e-4, atol=1e-3)
    assert np.isclose(float(got[2]), float(ref[2]), rtol=1e-4, atol=1e-3)
    if want_x:
        np.testing.assert_allclose(got[3].numpy(), x_ref, atol=tol)
        assert np.all(got[3].numpy()[np.arange(L)[:, None] >= length[None, :]] == 0)


@pytest.mark.parametrize("kind,params", CASES)
def test_plain_kernel_matches_pallas(kind, params):
    _compare(kind, params, L=8, K=1024, want_x=False)


@pytest.mark.parametrize("kind,params", [CASES[0], CASES[2], CASES[3], CASES[10], CASES[11]])
def test_plain_kernel_x_matches_pallas(kind, params):
    _compare(kind, params, L=8, K=1024, want_x=True)


@pytest.mark.parametrize("L", [1, 2, 33])
def test_plain_kernel_matches_pallas_other_widths(L):
    _compare("simplex", (("z", 1.0),), L=L, K=256, want_x=True, scale=10.0)


@pytest.mark.parametrize("want_x", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("kind,params", [CASES[0], CASES[2], CASES[10], CASES[11]],
                         ids=["simplex", "simplex_eq", "box_cut", "box_cut_eq"])
@pytest.mark.parametrize("L", [65, 130, 600])
def test_plain_kernel_matches_pallas_wide_columns(L, kind, params, want_x):
    """Above REG_L_CAP = 64, where the card's kernel projects one warp a
    column (one block a column above 512): the plain version against the
    Pallas kernel at the tolerances above (the plain version adds the lane
    sums as at any width; the kernel's warp and block orders are held to the
    plain version on the card)."""
    _compare(kind, params, L=L, K=256, want_x=want_x, scale=10.0)


@pytest.mark.parametrize("want_x", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("kind,params", CASES)
@pytest.mark.parametrize("L", [8, 65, 600])
def test_gather_form_matches_pallas_and_the_lam_g_form(L, kind, params, want_x):
    """The gather form on (scaled, rows) against the Pallas kernel on
    lam_g = scaled[rows], and bit for bit against the lam_g wrapper, which
    runs the gather form on lam_g itself; at a thread's, a warp's and a
    block's widths of the card's kernel."""
    rng = np.random.default_rng(1)
    K, m = 512, 300
    a, c, length, rows = _random_tile(rng, L, K, m)
    scaled = (np.float32(-50.0) * np.abs(rng.normal(size=m))).astype(np.float32)
    lam_g = scaled[rows]
    ref = jax_fused(
        jnp.asarray(lam_g), jnp.asarray(a), jnp.asarray(c), jnp.asarray(length),
        np.float32(-50.0), kind, params, block_k=256, interpret=True, want_x=want_x,
    )
    t = [torch.from_numpy(v) for v in (a, c, length)]
    out = torch.full((L, K), np.nan)
    got = fused_tile_gather_eval_T(torch.from_numpy(scaled), torch.from_numpy(rows), *t, -50.0, kind, params,
                                   block_k=256, want_x=want_x, out=out)
    assert got[0] is out and profiling.counter("dualip.ops.fused_tile_gather_eval_T.enqueued") == 0
    x_ref = np.asarray(ref[3] if want_x else ref[0])
    tol = 5e-5 * max(1.0, float(np.abs(x_ref).max()))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=tol)
    for i in (1, 2):
        assert np.isclose(float(got[i]), float(ref[i]), rtol=1e-4, atol=1e-3)
    if want_x:
        np.testing.assert_allclose(got[3].numpy(), x_ref, atol=tol)
    same = fused_tile_eval_T(torch.from_numpy(lam_g), *t, -50.0, kind, params, block_k=256, want_x=want_x)
    assert len(same) == len(got) and all(torch.equal(u, v) for u, v in zip(same, got))
    plain = fused_tile_gather_eval_T_reference(torch.from_numpy(scaled), torch.from_numpy(rows), *t, -50.0, kind,
                                               params, want_x=want_x)
    assert all(torch.equal(u, v) for u, v in zip(plain, got))


def test_wrapper_rejects_bad_shapes():
    a = torch.zeros((4, 96))
    length = torch.zeros(96, dtype=torch.int32)
    with pytest.raises(ValueError, match="block_k"):
        fused_tile_eval_T(a, a, a, length, -1.0, "simplex", block_k=64)
    with pytest.raises(ValueError, match="shape"):
        fused_tile_eval_T(a[:, :32], a, a, length, -1.0, "simplex", block_k=32)
    with pytest.raises(ValueError, match="length"):
        fused_tile_eval_T(a, a, a, length[:10], -1.0, "simplex", block_k=32)
    with pytest.raises(ValueError, match="kind"):
        fused_tile_eval_T(a, a, a, length, -1.0, "nope", block_k=32)
    rows = torch.zeros((4, 96), dtype=torch.int32)
    with pytest.raises(ValueError, match="rows_T shape"):
        fused_tile_gather_eval_T(torch.zeros(5), rows[:, :32], a, a, length, -1.0, "simplex", block_k=32)
    with pytest.raises(ValueError, match="scaled must be"):
        fused_tile_gather_eval_T(torch.zeros(5, 1), rows, a, a, length, -1.0, "simplex", block_k=32)


def test_partial_block_count_follows_kernel_variant():
    assert num_partial_blocks("simplex", 64, 1000) == 4  # 256 columns a slab
    assert num_partial_blocks("simplex", 65, 1000) == 125  # 8 columns a block, one a warp
    assert num_partial_blocks("box_cut", 512, 1001) == 126
    assert num_partial_blocks("box_cut", 5000, 1001) == 1001  # a block a column above 512
    assert num_partial_blocks("simplex_eq", 513, 1000) == 1000
    assert num_partial_blocks("box", 500, 1000) == 4
    assert num_partial_blocks("box", 5000, 1000) == 4  # the elementwise kinds: a thread a column at any L


@pytest.mark.parametrize("L,path,threads,keep", [
    (64, "thread", 1, "registers"),
    (65, "warp", 32, "registers"),
    (512, "warp", 32, "registers"),
    (513, "block", 128, "registers"),  # 8 lanes a thread
    (1024, "block", 128, "registers"),
    (8192, "block", 1024, "registers"),
    (8193, "block", 1024, "registers"),  # 16 lanes a thread
    (20000, "block", 1024, "shared memory"),
    (60000, "block", 1024, "device memory"),  # past a block's shared memory
])
def test_k1_path_follows_the_column_width(L, path, threads, keep):
    """The host's copy of the kernel's rule: what projects a column of L
    lanes, with how many threads, and where its lanes stay between passes."""
    for kind in ("simplex", "simplex_eq", "box_cut", "box_cut_eq"):
        assert tuple(k1_path(kind, L)) == (path, threads, keep)
    assert tuple(k1_path("box", L)) == ("thread", 1, "registers")
    assert num_partial_blocks("simplex", L, 4096) == {"thread": 16, "warp": 512, "block": 4096}[path]


def test_lam_g_wrapper_refuses_a_tile_past_int32():
    """The lam_g wrapper gathers lam_g through int32 row indices: a tile of
    2**31 slots is refused, on shapes alone (stride-0 views, nothing of that
    size is made)."""
    big = torch.zeros(1).expand(2**16, 2**15)
    length = torch.zeros(1, dtype=torch.int32).expand(2**15)
    with pytest.raises(ValueError, match=r"2\*\*31"):
        fused_tile_eval_T(big, big, big, length, -1.0, "simplex", block_k=2**15)
