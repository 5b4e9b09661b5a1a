"""The panel kernel's plain version (K3/K4) against the JAX package's Pallas
kernel in interpret mode, on the CPU.

Tolerance: 1e-5 of the largest |x| on ``a*x`` and ``x`` (both run 30 fp32
bisection steps; XLA may contract ``a*s + nig*c`` where torch rounds twice),
1e-4 relative on the two sums (tens of thousands of fp32 terms, added in
another order).  Outside the tile's region, and in its ghost
lanes, the buffer is compared exactly.

The all-tiles form is held to one call per tile: a*x and x bit for bit, the
sums within 1e-6 relative (the same terms, added tile by tile).

Above every ring cap of the kernel (L = 100, L2 = 128), and above the
widest tile a warp projects (L = 513 to 6,726, the block form's), the plain
version is held to the Pallas kernel at the same tolerances: the plain
version adds the bisection sums of L lanes as the narrow tiles' do, and the
card's kernel, which adds them across a warp or a block, is held to the plain
version on the card (``test_torch_panel_card.py``, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dualip_tpu.ops.pallas_matching import fused_panel_project as jax_panel
from dualip_tpu_torch.objectives.matching import _panel_x_to_kl
from dualip_tpu_torch.ops.fused_matching import (
    _panel_args,
    build_panel_table,
    fused_panel_project,
    fused_panel_project_reference,
    fused_panel_project_tiles,
    PANEL_RING_L_CAP,
    PANEL_WARP_L_CAP,
    panel_path,
    panel_unit_where,
)
from dualip_tpu_torch.sparse.rowmajor import PanelTile, _pack_geometry
from dualip_tpu_torch.utils import profiling

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


# the projecting kinds, equality and inequality, on a tile wider than every ring cap (47, 57)
WIDE_CASES = [CASES[0], CASES[2], CASES[7], CASES[8]]


@pytest.mark.parametrize("want_x", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("carry", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind,params", WIDE_CASES, ids=[k for k, _ in WIDE_CASES])
def test_panel_plain_version_matches_pallas_interpret_above_the_ring(kind, params, carry, want_x):
    """L = 100 (L2 = 128), KP = 2: the width the kernel projects one warp a
    column.  Tolerances as above on an fp32 carry; a bf16 carry rounds a*x
    once at the store in both, so one bf16 ulp of the largest |a*x| where the
    fp32 values straddle a rounding boundary."""
    a, c, length, buf, off, region, pack, (KP, L, L2, q) = _tile(100, False, seed=101, KP=2)
    assert (L2, q) == (128, 1) and L > PANEL_RING_L_CAP
    jbuf = jnp.asarray(buf) if carry == torch.float32 else jnp.asarray(buf).astype(jnp.bfloat16)
    ref = jax_panel(
        jbuf, jnp.asarray(a), jnp.asarray(c), jnp.asarray(length), off, kind, params,
        interpret=True, want_x=want_x, neg_inv_gamma=jnp.float32(-2.0), pack=pack,
    )
    got = fused_panel_project(
        torch.from_numpy(buf.copy()).to(carry), torch.from_numpy(a), torch.from_numpy(c), torch.from_numpy(length),
        off, kind, params, want_x=want_x, neg_inv_gamma=-2.0, pack=pack,
    )
    assert got[0].dtype == carry
    gb, rb = got[0].float().numpy(), np.asarray(ref[0].astype(jnp.float32))
    np.testing.assert_array_equal(gb[:off], rb[:off])
    np.testing.assert_array_equal(gb[off + region:], rb[off + region:])
    g_reg, r_reg = gb[off:off + region].reshape(KP, L2, 128), rb[off:off + region].reshape(KP, L2, 128)
    assert not g_reg[:, q * L:, :].any() and not r_reg[:, q * L:, :].any()
    tol = 1e-5 * max(1.0, np.abs(r_reg).max())
    if carry == torch.bfloat16:
        tol += 2.0 ** -7 * np.abs(r_reg).max()
    np.testing.assert_allclose(g_reg, r_reg, atol=tol)
    assert np.isclose(float(got[1]), float(ref[1]), rtol=1e-4, atol=1e-5)
    assert np.isclose(float(got[2]), float(ref[2]), rtol=1e-4, atol=1e-5)
    if want_x:
        x_ref = np.asarray(ref[3])
        assert tuple(got[3].shape) == x_ref.shape == (KP, q * L, 128)
        np.testing.assert_allclose(got[3].numpy(), x_ref, atol=1e-5 * max(1.0, np.abs(x_ref).max()))


# tiles above the widest a warp projects: the block form's, at ml20m's widths above 512 and the first past it
BLOCK_LS = [513, 1024, 2045, 6726]


@pytest.mark.parametrize("want_x", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("carry", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("L", BLOCK_LS)
def test_panel_plain_version_matches_pallas_interpret_in_the_block_form(L, carry, want_x):
    """One buffer row (128 columns) at L = 513 to 6,726, the kind rotating
    over the projecting ones, tolerances as above: padding columns (a whole
    group of 8, and single ones) take a*x = 0 and x = 0, and the ghost lanes
    [L, L2) (511 at L = 513, none at 1,024, 1,466 at 6,726) become zeros."""
    kind, params = WIDE_CASES[BLOCK_LS.index(L)]
    a, c, length, buf, off, region, pack, (KP, _, L2, q) = _tile(L, False, seed=L, KP=1)
    assert (KP, q) == (1, 1) and L > PANEL_WARP_L_CAP and L2 >= L
    length[0, 0, 8:16] = 0  # a group of 8 padding columns, as a tile's tail has
    length[0, 0, [3, 40, 127]] = 0
    length[0, 0, 50] = L
    mask = np.arange(L)[None, :, None] < length[:, 0, None, :]
    a, c = np.where(mask, a, 0).astype(np.float32), np.where(mask, c, 0).astype(np.float32)
    jbuf = jnp.asarray(buf) if carry == torch.float32 else jnp.asarray(buf).astype(jnp.bfloat16)
    ref = jax_panel(
        jbuf, jnp.asarray(a), jnp.asarray(c), jnp.asarray(length), off, kind, params,
        interpret=True, want_x=want_x, neg_inv_gamma=jnp.float32(-2.0), pack=pack,
    )
    got = fused_panel_project(
        torch.from_numpy(buf.copy()).to(carry), torch.from_numpy(a), torch.from_numpy(c), torch.from_numpy(length),
        off, kind, params, want_x=want_x, neg_inv_gamma=-2.0, pack=pack,
    )
    assert got[0].dtype == carry
    gb, rb = got[0].float().numpy(), np.asarray(ref[0].astype(jnp.float32))
    np.testing.assert_array_equal(gb[:off], rb[:off])
    np.testing.assert_array_equal(gb[off + region:], rb[off + region:])
    g_reg, r_reg = gb[off:off + region].reshape(KP, L2, 128), rb[off:off + region].reshape(KP, L2, 128)
    assert not g_reg[:, L:, :].any() and not r_reg[:, L:, :].any()
    assert not g_reg[:, :, 8:16].any() and not g_reg[:, :, [3, 40, 127]].any()
    tol = 1e-5 * max(1.0, np.abs(r_reg).max())
    if carry == torch.bfloat16:
        tol += 2.0 ** -7 * np.abs(r_reg).max()
    np.testing.assert_allclose(g_reg, r_reg, atol=tol)
    assert np.isclose(float(got[1]), float(ref[1]), rtol=1e-4, atol=1e-5)
    assert np.isclose(float(got[2]), float(ref[2]), rtol=1e-4, atol=1e-5)
    if want_x:
        x_ref = np.asarray(ref[3])
        assert tuple(got[3].shape) == x_ref.shape == (KP, L, 128)
        assert not got[3][:, :, 8:16].any()
        np.testing.assert_allclose(got[3].numpy(), x_ref, atol=1e-5 * max(1.0, np.abs(x_ref).max()))


@pytest.mark.parametrize("L,path,threads,keep", [
    (1, "thread", 1, "registers"),
    (32, "thread", 1, "registers"),
    (33, "thread", 1, "shared memory"),  # read again from the ring on every pass
    (47, "thread", 1, "shared memory"),
    (48, "warp", 32, "registers"),
    (128, "warp", 32, "registers"),
    (129, "warp", 32, "shared memory"),  # the warp's stretch
    (512, "warp", 32, "shared memory"),
    (513, "block", 128, "registers"),  # 8 lanes a thread
    (1024, "block", 128, "registers"),
    (2045, "block", 256, "registers"),
    (3924, "block", 512, "registers"),
    (6726, "block", 1024, "registers"),
    (8193, "block", 1024, "registers"),  # 16 lanes a thread
    (20000, "block", 1024, "shared memory"),
    (60000, "block", 1024, "device memory"),  # past a block's shared memory
])
def test_panel_path_follows_the_column_width(L, path, threads, keep):
    """The host's copy of the panel kernel's rule, for every kind: the ring's
    thread, a consumer warp, or the block form with K1's block rule."""
    assert tuple(panel_path(L)) == (path, threads, keep)
    assert (path == "block") == (L > PANEL_WARP_L_CAP) and (path == "thread") == (L <= PANEL_RING_L_CAP)


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
    assert profiling.counter("dualip.ops.fused_panel_project.enqueued") == 0
    assert profiling.counter("dualip.ops.fused_panel_project.enqueued_x") == 0


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


# ---------------------------------------------------------------------------
# The all-tiles form (one launch over a layout's tile table)
# ---------------------------------------------------------------------------

# (L, compact) of a mixed table: plain panels wide and narrow (a warp's and the block form's), compact packings
TABLE_SHAPES = [(1, False), (2, False), (5, False), (16, False), (29, False), (100, False), (600, False),
                (3, True), (29, True), (34, True)]


def _mixed_table(shift, carry, seed=11, KP=2):
    """A table of every TABLE_SHAPES tile, tile i projecting with CASES[i + shift],
    regions placed as build_row_layout places them (descending L2), and a
    carry buffer with a stretch beyond the last region."""
    rng = np.random.default_rng(seed)
    tiles, packs, kinds, geo = [], [], [], []
    for i, (L, compact) in enumerate(TABLE_SHAPES):
        a, c, length, _, _, _, pack, (kp, _, L2, q) = _tile(L, compact, seed=seed + i, KP=KP)
        tiles.append(PanelTile(a=torch.from_numpy(a), c=torch.from_numpy(c), length=torch.from_numpy(length)))
        packs.append(pack)
        kinds.append(CASES[(i + shift) % len(CASES)])
        geo.append((kp, L2))
    offsets, cum = [0] * len(tiles), 0
    for i in sorted(range(len(tiles)), key=lambda i: -geo[i][1]):
        offsets[i] = cum
        cum += geo[i][0] * geo[i][1] * 128
    buf = torch.from_numpy((rng.normal(size=cum + 512) * 3).astype(np.float32)).to(carry)
    return build_panel_table(tiles, offsets, packs, kinds), buf


@pytest.mark.parametrize("want_x", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("carry", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shift", range(len(CASES)))
def test_all_tiles_plain_version_is_the_per_tile_sequence(shift, carry, want_x):
    """a*x and x bit for bit those of one call per tile; obj and reg within
    1e-6 relative of the per-tile sums added in float64."""
    table, buf = _mixed_table(shift, carry)
    assert table.rows is None and table.device == torch.device("cpu")
    got = fused_panel_project_tiles(buf.clone(), table, -2.0, want_x=want_x)
    seq, objs, regs, xs = buf.clone(), [], [], []
    for t in table.tiles:
        _, o, r, *x = fused_panel_project(seq, t.a, t.c, t.length, t.off, t.kind, t.params, want_x=want_x,
                                          neg_inv_gamma=-2.0, pack=t.pack)
        objs.append(float(o))
        regs.append(float(r))
        xs += x
    assert torch.equal(got[0], seq)
    assert np.isclose(float(got[1]), np.sum(objs, dtype=np.float64), rtol=1e-6, atol=0)
    assert np.isclose(float(got[2]), np.sum(regs, dtype=np.float64), rtol=1e-6, atol=0)
    if want_x:
        assert len(got[3]) == len(xs) == len(table.tiles)
        for g, r, t in zip(got[3], xs, table.tiles):
            assert g.shape == t.a.shape and torch.equal(g, r)
    for name in ("enqueued", "enqueued_x", "block_tiles"):
        assert profiling.counter(f"dualip.ops.fused_panel_project_tiles.{name}") == 0


def test_panel_table_geometry():
    """Work units of the ring's launch: an item (buffer row and segment) of a
    tile the ring holds, 16 of 8 columns for each item of L = 100 (above the
    ring's cap), none for L = 600 (above a warp's: the block form's)."""
    table, buf = _mixed_table(0, torch.float32)
    first = 0
    for t, (L, compact) in zip(table.tiles, TABLE_SHAPES):
        assert (t.L, t.q > 1) == (L, compact) and t.q * t.L <= t.L2 and t.KP == 2
        assert t.first == first and t.off % (128 * t.L2) == 0
        first += t.KP * t.q * {100: 16, 600: 0}.get(L, 1)
    assert table.n_items == first and table.n_buf == buf.shape[0] - 512 and table.wide
    assert table.blocks == (TABLE_SHAPES.index((600, False)),)
    assert table.x_slots == sum(t.a.numel() for t in table.tiles)
    assert [t.x_off for t in table.tiles] == np.cumsum([0] + [t.a.numel() for t in table.tiles[:-1]]).tolist()


# (L, compact): narrow, just above the ring's cap (47), narrow packed, wide, the block form's, wide
UNIT_SHAPES = [(5, False), (50, False), (29, True), (100, False), (1030, False), (80, False), (513, False)]


@pytest.mark.parametrize("tiles", [torch.float32, torch.bfloat16], ids=["fp32-tiles", "bf16-tiles"])
def test_panel_table_numbers_the_wide_units(tiles):
    """Each tile's first unit and the ring's launch's units (the ring's cap
    is one for every carry and tile type), then the block form's columns, a
    unit each, tile after tile in table order; the map from a unit back to
    its tile, buffer row, segment and columns: every column of every item
    exactly once, a tile's units in order; the table's ``wide`` flag, set
    with a tile above the ring's cap up to a warp's and clear without one,
    and its ``blocks``, the tiles above a warp's."""
    rng = np.random.default_rng(5)
    pts, packs, kinds, geo = [], [], [], []
    for i, (L, compact) in enumerate(UNIT_SHAPES):
        a, c, length, _, _, _, pack, (KP, _, L2, q) = _tile(L, compact, seed=20 + i, KP=3)
        pts.append(PanelTile(torch.from_numpy(a).to(tiles), torch.from_numpy(c).to(tiles), torch.from_numpy(length)))
        packs.append(pack)
        kinds.append(CASES[i % len(CASES)])
        geo.append((KP, L2, q))
    offsets, cum = [0] * len(pts), 0
    for i in sorted(range(len(pts)), key=lambda i: -geo[i][1]):  # descending L2, as build_row_layout places them
        offsets[i] = cum
        cum += geo[i][0] * geo[i][1] * 128
    table = build_panel_table(pts, offsets, packs, kinds)
    items = [kp * q for kp, _, q in geo]  # 3, 3, 3 * q, 3, 3, 3, 3
    # units per item in the ring's launch: 16 of 8 columns above the ring's cap, none above a warp's
    per = [1, 16, 1, 16, 0, 16, 0]
    want = np.cumsum([0] + [n * u for n, u in zip(items, per)]).tolist()
    assert [t.first for t in table.tiles] == want[:-1] and table.n_items == want[-1] and table.wide
    assert table.blocks == (4, 6)
    block_first = {4: table.n_items, 6: table.n_items + items[4] * 128}  # the block form: a unit a column
    n_units = table.n_items + (items[4] + items[6]) * 128
    seen = {}
    for unit in range(n_units):
        i, row, seg, col0, ncols = panel_unit_where(table, unit)
        assert (ncols, col0 % ncols) == {16: (8, 0), 1: (128, 0), 0: (1, 0)}[per[i]]
        assert (unit >= table.n_items) == (per[i] == 0)
        for col in range(col0, col0 + ncols):
            key = (i, row, seg, col)
            assert key not in seen
            seen[key] = unit
    assert len(seen) == sum(kp * q * 128 for kp, _, q in geo)
    for i, (kp, _, q) in enumerate(geo):  # row-major: row, then segment, then columns
        order = [seen[(i, r, s, col)] for r in range(kp) for s in range(q) for col in range(128)]
        assert order == sorted(order) and order[0] == block_first.get(i, table.tiles[i].first)
        if per[i] == 0:
            assert order == list(range(order[0], order[0] + kp * q * 128))
    with pytest.raises(ValueError, match="is not one of"):
        panel_unit_where(table, n_units)
    narrow = [i for i, (L, _) in enumerate(UNIT_SHAPES) if L <= PANEL_RING_L_CAP]
    only_narrow = build_panel_table([pts[i] for i in narrow], [offsets[i] for i in narrow],
                                    [packs[i] for i in narrow], [kinds[i] for i in narrow])
    assert not only_narrow.wide and only_narrow.n_items == sum(items[i] for i in narrow)
    assert only_narrow.blocks == ()
    wide = [i for i, (L, _) in enumerate(UNIT_SHAPES) if L > PANEL_WARP_L_CAP]
    only_block = build_panel_table([pts[i] for i in wide], [offsets[i] for i in wide],
                                   [packs[i] for i in wide], [kinds[i] for i in wide])
    assert not only_block.wide and only_block.n_items == 0 and only_block.blocks == (0, 1)
    assert panel_unit_where(only_block, items[4] * 128) == (1, 0, 0, 0, 1)


def test_all_tiles_wrapper_checks_its_arguments():
    table, buf = _mixed_table(0, torch.float32)
    with pytest.raises(ValueError, match="buf must be"):
        fused_panel_project_tiles(buf.view(-1, 128), table, -1.0)
    with pytest.raises(ValueError, match="past the"):
        fused_panel_project_tiles(buf[: table.n_buf - 128], table, -1.0)
    with pytest.raises(ValueError, match="panel table on cpu"):
        fused_panel_project_tiles(torch.empty(table.n_buf, device="meta"), table, -1.0)
    with pytest.raises(ValueError, match="neg_inv_gamma"):
        fused_panel_project_tiles(buf, table, None)

    tiles = [PanelTile(t.a, t.c, t.length) for t in table.tiles]
    offsets, packs = [t.off for t in table.tiles], [t.pack for t in table.tiles]
    kinds = [(t.kind, t.params) for t in table.tiles]
    with pytest.raises(ValueError, match="one offset, pack and kind per tile"):
        build_panel_table(tiles, offsets[:-1], packs, kinds)
    with pytest.raises(ValueError, match="not a multiple of 128"):
        build_panel_table(tiles, offsets[:-1] + [offsets[-1] + 128], packs, kinds)  # L2 = 512
    with pytest.raises(ValueError, match="overlap"):
        build_panel_table(tiles[:2], [0, 0], packs[:2], kinds[:2])
    with pytest.raises(ValueError, match="length must be"):
        build_panel_table([tiles[2]._replace(length=tiles[2].length[:, :, :64])], [0], [None], kinds[:1])
    with pytest.raises(TypeError, match="float32 a and c"):
        build_panel_table([tiles[2]._replace(a=tiles[2].a.double())], [0], [None], kinds[:1])
    with pytest.raises(ValueError, match="packed tile shape"):
        build_panel_table(tiles[6:7], [0], [(4, 8, 2)], kinds[:1])
    with pytest.raises(ValueError, match="Unsupported projection kind"):
        build_panel_table(tiles[:1], [0], [None], [("ball", ())])


def test_panel_launch_refuses_a_misaligned_buffer():
    """The kernel brings srow in by bulk copies from 16-byte aligned
    addresses: a carry buffer that does not start on 16 bytes is refused
    before the launch (the CUDA path's checks, run here on a CPU view)."""
    _, buf = _mixed_table(0, torch.float32)
    nig, x, out = _panel_args(buf, -1.0, True, 256)
    assert (float(nig), tuple(x.shape), tuple(out.shape)) == (-1.0, (256,), (2,))
    for view in (buf[1:], buf[3:], buf.to(torch.bfloat16)[7:]):
        with pytest.raises(ValueError, match="16-byte aligned carry buffer"):
            _panel_args(view, -1.0, False, 0)
