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
from dualip_tpu_torch.ops.fused_matching import fused_tile_eval_T, num_partial_blocks

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


def test_partial_block_count_follows_kernel_variant():
    assert num_partial_blocks("simplex", 64, 1000) == 8
    assert num_partial_blocks("simplex", 65, 1000) == 1000
    assert num_partial_blocks("box", 500, 1000) == 8
