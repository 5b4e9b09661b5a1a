"""The panel kernel's plain version (K3/K4) against the JAX package's Pallas
kernel in interpret mode, on the CPU.

Tolerance: 1e-5 of the largest |x| on ``a*x`` and ``x`` (both run 30 fp32
bisection steps; XLA may contract ``a*s + nig*c`` where torch rounds twice),
1e-4 relative on the two sums (tens of thousands of fp32 terms, added in
another order).  Outside the tile's region, and in its ghost
lanes, the buffer is compared exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dualip_tpu.ops.pallas_matching import fused_panel_project as jax_panel
from dualip_tpu_torch.objectives.matching import _panel_x_to_kl
from dualip_tpu_torch.ops.fused_matching import fused_panel_project, fused_panel_project_reference
from dualip_tpu_torch.sparse.rowmajor import _pack_geometry

torch.set_num_threads(1)

CASES = [
    ("simplex", (("z", 1.0),)),
    ("simplex", (("z", 2.5),)),
    ("simplex_eq", (("z", 1.0),)),
    ("box", (("lower", 0.0), ("upper", 1.0))),
    ("box", (("lower", float("nan")), ("upper", 0.25))),
    ("cone", (("lower", 0.0),)),
    ("identity", ()),
    ("box_cut", (("lower", 0.0), ("upper", 0.6), ("z", 1.0))),
    ("box_cut_eq", (("l", 0.0), ("u", 1.0), ("z", 2.0))),
]
# (L, compact): q = 1 with L a power of two and not; q > 1 (L=3: L2=64, q=21; L=5: L2=16, q=3)
SHAPES = [(4, False), (5, False), (1, False), (3, True), (5, True)]


def _tile(L, compact, seed, KP=8):
    rng = np.random.default_rng(seed)
    if compact:
        L2, q = _pack_geometry(L)
        pack = (L, L2, q)
    else:
        L2, q, pack = (1 << max(L - 1, 0).bit_length()) if L > 1 else 1, 1, None
    a = np.abs(rng.normal(size=(KP, q, L, 128))).astype(np.float32)
    c = -np.abs(rng.normal(size=(KP, q, L, 128))).astype(np.float32)
    length = rng.integers(0, L + 1, size=(KP, q, 1, 128)).astype(np.int32)
    mask = np.arange(L)[None, None, :, None] < length
    a = np.where(mask, a, 0).astype(np.float32).reshape(KP, q * L, 128)
    c = np.where(mask, c, 0).astype(np.float32).reshape(KP, q * L, 128)
    region = KP * L2 * 128
    buf = (rng.normal(size=4 * region) * 3).astype(np.float32)
    return a, c, length.reshape(KP, q, 128), buf, 2 * region, region, pack, (KP, L, L2, q)


@pytest.mark.parametrize("want_x", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("L,compact", SHAPES, ids=[f"L{L}{'-compact' if c else ''}" for L, c in SHAPES])
@pytest.mark.parametrize("kind,params", CASES, ids=[f"{k}-{i}" for i, (k, _) in enumerate(CASES)])
def test_panel_plain_version_matches_pallas_interpret(kind, params, L, compact, want_x):
    a, c, length, buf, off, region, pack, (KP, _, L2, q) = _tile(L, compact, seed=L + 7 * compact)
    ref = jax_panel(
        jnp.asarray(buf), jnp.asarray(a), jnp.asarray(c), jnp.asarray(length), off, kind, params,
        interpret=True, want_x=want_x, neg_inv_gamma=jnp.float32(-2.0), pack=pack,
    )
    got = fused_panel_project(
        torch.from_numpy(buf.copy()), torch.from_numpy(a), torch.from_numpy(c), torch.from_numpy(length),
        off, kind, params, want_x=want_x, neg_inv_gamma=-2.0, pack=pack,
    )
    gb, rb = got[0].numpy(), np.asarray(ref[0])
    np.testing.assert_array_equal(gb[:off], buf[:off])
    np.testing.assert_array_equal(gb[off + region:], buf[off + region:])
    g_reg, r_reg = gb[off:off + region].reshape(KP, L2, 128), rb[off:off + region].reshape(KP, L2, 128)
    assert not g_reg[:, q * L:, :].any() and not r_reg[:, q * L:, :].any()
    tol = 1e-5 * max(1.0, np.abs(r_reg).max())
    np.testing.assert_allclose(g_reg, r_reg, atol=tol)
    assert np.isclose(float(got[1]), float(ref[1]), rtol=1e-4, atol=1e-5)
    assert np.isclose(float(got[2]), float(ref[2]), rtol=1e-4, atol=1e-5)
    if want_x:
        x_ref = np.asarray(ref[3])
        assert tuple(got[3].shape) == x_ref.shape == (KP, q * L, 128)
        np.testing.assert_allclose(got[3].numpy(), x_ref, atol=1e-5 * max(1.0, np.abs(x_ref).max()))


@pytest.mark.parametrize("compact", [False, True])
def test_panel_bf16_carry_matches_pallas_interpret(compact):
    """srow upcast to fp32, a*x rounded once to bf16 at the store."""
    a, c, length, buf, off, region, pack, (KP, L, L2, q) = _tile(5, compact, seed=3)
    ref = jax_panel(
        jnp.asarray(buf).astype(jnp.bfloat16), jnp.asarray(a), jnp.asarray(c), jnp.asarray(length), off,
        "simplex", (("z", 1.0),), interpret=True, neg_inv_gamma=jnp.float32(-2.0), pack=pack,
    )
    got = fused_panel_project(
        torch.from_numpy(buf).to(torch.bfloat16), torch.from_numpy(a), torch.from_numpy(c),
        torch.from_numpy(length), off, "simplex", (("z", 1.0),), neg_inv_gamma=-2.0, pack=pack,
    )
    assert got[0].dtype == torch.bfloat16
    gb, rb = got[0].float().numpy(), np.asarray(ref[0].astype(jnp.float32))
    np.testing.assert_array_equal(gb[:off], rb[:off])
    # one bf16 ulp where the fp32 values straddle a rounding boundary
    np.testing.assert_allclose(gb[off:off + region], rb[off:off + region], atol=2.0 ** -7 * np.abs(rb).max())
    assert np.isclose(float(got[1]), float(ref[1]), rtol=1e-4, atol=1e-5)


def test_panel_wrapper_checks_its_arguments():
    a, c, length, buf, off, region, pack, _ = _tile(5, False, seed=1)
    t = [torch.from_numpy(v) for v in (a, c, length)]
    b = torch.from_numpy(buf)
    with pytest.raises(ValueError, match="does not lie"):
        fused_panel_project(b, *t, off + 128, "simplex", neg_inv_gamma=-1.0)
    with pytest.raises(ValueError, match="does not lie"):
        fused_panel_project(b, *t, 4 * region, "simplex", neg_inv_gamma=-1.0)
    with pytest.raises(ValueError, match="len_p must be"):
        fused_panel_project(b, t[0], t[1], t[2][:, :, :64], off, "simplex", neg_inv_gamma=-1.0)
    with pytest.raises(ValueError, match="packed tile shape"):
        fused_panel_project(b, *t, off, "simplex", neg_inv_gamma=-1.0, pack=(4, 8, 2))
    with pytest.raises(ValueError, match="neg_inv_gamma"):
        fused_panel_project(b, *t, off, "simplex")
    with pytest.raises(ValueError, match="Unsupported projection kind"):
        fused_panel_project_reference(b, *t, off, "ball", neg_inv_gamma=-1.0)
    assert fused_panel_project.launches == fused_panel_project.launches_x == 0


def test_panel_x_to_kl_unstacks_both_packings():
    rng = np.random.default_rng(0)
    K, L = 1024, 5
    x_kl = rng.normal(size=(K, L)).astype(np.float32)
    plain = x_kl.reshape(K // 128, 128, L).transpose(0, 2, 1)
    np.testing.assert_array_equal(_panel_x_to_kl(plain, K, None), x_kl)
    L2, q = _pack_geometry(L)  # (16, 3): 8 panel rows stack into 3 buffer rows, padded to 8
    BP = 8
    stacked = np.concatenate([plain, np.zeros((BP * q - K // 128, L, 128), np.float32)]).reshape(BP, q * L, 128)
    np.testing.assert_array_equal(_panel_x_to_kl(stacked, K, (L, L2, q)), x_kl)
