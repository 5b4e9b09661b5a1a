"""The panel kernel's block form (K3/K4 on tiles above L = 512) on the card,
marked ``card``: against the plain version, one tile a launch against the
all-tiles launch and two launches against each other bit for bit, bf16 tiles
against fp32 tiles holding the same values bit for bit, and the counter of
the tiles a call sends to the block form.  Skips without a CUDA card."""

import numpy as np
import pytest
import torch

from dualip_tpu_torch.ops.fused_matching import (
    PANEL_WARP_L_CAP,
    build_panel_table,
    fused_panel_project,
    fused_panel_project_reference,
    fused_panel_project_tiles,
    fused_panel_project_tiles_reference,
    panel_path,
)
from dualip_tpu_torch.sparse.rowmajor import PanelTile
from dualip_tpu_torch.utils import profiling

KINDS = [
    ("simplex", (("z", 1.0),)),
    ("simplex", (("z", 2.5),)),
    ("simplex_eq", (("z", 1.0),)),
    ("box", (("lower", 0.0), ("upper", 1.0))),
    ("box_cut", (("lower", 0.0), ("upper", 0.6), ("z", 1.0))),
    ("box_cut_eq", (("l", 0.0), ("u", 1.0), ("z", 2.0))),
]
DTYPES = (torch.float32, torch.bfloat16)
# every block and keep of the block form: 128, 256, 512 and 1024 threads in registers, 16 lanes a thread,
# the block's shared memory, device memory
BLOCK_LS = [(513, 2), (1024, 2), (2045, 1), (6726, 1), (9000, 1), (20000, 1), (60000, 1)]
ML20M_LS = (32, 64, 128, 256, 512, 1024, 2045, 3924, 6726)  # the movielens-20m cells' tile widths


@pytest.fixture
def store(monkeypatch):
    """A fresh store, tracing off, for the test's length."""
    fresh = profiling.Store()
    fresh.on = False
    monkeypatch.setattr(profiling, "STORE", fresh)
    return fresh


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tile(rng, L, KP, dev):
    """A plain panel tile of bf16 values (exact in fp32) with padding
    columns: a whole group of 8, single ones and a tail, as a tile's last
    buffer row has.  Returns (tile in bf16, L2)."""
    L2 = 1 << (L - 1).bit_length()
    length = rng.integers(1, L + 1, size=(KP, 1, 128)).astype(np.int32)
    length[0, 0, 8:16] = 0
    length[0, 0, [3, 40]] = 0
    length[-1, 0, 100:] = 0
    length[0, 0, 50] = L
    mask = np.arange(L)[None, :, None] < length[:, 0, None, :]
    a = np.where(mask, np.abs(rng.normal(size=(KP, L, 128))), 0).astype(np.float32)
    c = np.where(mask, -np.abs(rng.normal(size=(KP, L, 128))), 0).astype(np.float32)
    t = PanelTile(torch.from_numpy(a).to(dev).to(torch.bfloat16), torch.from_numpy(c).to(dev).to(torch.bfloat16),
                  torch.from_numpy(length).to(dev))
    return t, L2


def _widened(t):
    return t._replace(a=t.a.float(), c=t.c.float())


def _tol(ref, carry):
    """5e-5 of max(1, max|.|), and one bf16 ulp on a bf16 carry: a block adds
    a column's lane sums in another order than the plain version."""
    m = float(ref.float().abs().max())
    return 5e-5 * max(1.0, m) + (m * 2.0 ** -7 if carry == torch.bfloat16 else 0.0)


@pytest.mark.card
@pytest.mark.parametrize("L,KP", BLOCK_LS, ids=[f"L{L}" for L, _ in BLOCK_LS])
def test_block_form_matches_the_plain_version(store, L, KP):
    """One tile a launch: every kind, both carries, both tile types (bf16
    tiles bit for bit those of fp32 tiles of the same values), K3 and K4;
    outside the region unchanged, ghost lanes and padding columns zero."""
    dev = _card()
    rng = np.random.default_rng(L)
    gen = torch.Generator(device=dev).manual_seed(L)
    tile16, L2 = _tile(rng, L, KP, dev)
    region = KP * L2 * 128
    off = region
    n = 0
    for kind, params in KINDS:
        for carry in DTYPES:
            buf0 = (torch.randn(3 * region, generator=gen, device=dev) * 50).to(carry)
            for want_x in (False, True):
                tile = _widened(tile16)
                got = fused_panel_project(buf0.clone(), *tile, off, kind, params, want_x=want_x, neg_inv_gamma=-2.0)
                bf = fused_panel_project(buf0.clone(), *tile16, off, kind, params, want_x=want_x, neg_inv_gamma=-2.0)
                ref = fused_panel_project_reference(buf0.clone(), *tile, off, kind, params, want_x=want_x,
                                                    neg_inv_gamma=-2.0)
                name = (kind, params, str(carry), want_x)
                assert all(torch.equal(u, v) for u, v in zip(got, bf)), name
                assert torch.equal(got[0][:off], buf0[:off]) and torch.equal(got[0][off + region:], buf0[off + region:])
                g = got[0][off:off + region].view(KP, L2, 128).float()
                r = ref[0][off:off + region].view(KP, L2, 128).float()
                assert not g[:, L:, :].any() and not g[0, :, 8:16].any(), name
                e = float((g - r).abs().max())
                assert e <= _tol(r, carry), (name, e)
                if want_x:
                    assert not got[3][0, :, 8:16].any()
                    e = float((got[3] - ref[3]).abs().max())
                    assert e <= _tol(ref[3], torch.float32), (name, e)
                for i in (1, 2):
                    assert abs(float(got[i]) - float(ref[i])) <= 1e-3 + 1e-4 * abs(float(ref[i])), name
                n += 1
    assert profiling.counter("dualip.ops.fused_panel_project.block_tiles") == 2 * n


def _table(dev, Ls, KP=2, seed=0, shift=0, tiles=torch.float32):
    """A table of plain tiles of the given widths, regions placed as
    build_row_layout places them (descending L2), and its buffer length."""
    rng = np.random.default_rng(seed)
    pts, geo = [], []
    for L in Ls:
        t, L2 = _tile(rng, L, KP, dev)
        pts.append(t if tiles == torch.bfloat16 else _widened(t))
        geo.append(L2)
    offsets, cum = [0] * len(pts), 128 * max(geo)  # an untouched stretch first, and one after
    for i in sorted(range(len(pts)), key=lambda i: -geo[i]):
        offsets[i] = cum
        cum += KP * geo[i] * 128
    kinds = [KINDS[(i + shift) % len(KINDS)] for i in range(len(pts))]
    return build_panel_table(pts, offsets, [None] * len(pts), kinds), cum + 128 * 64


@pytest.mark.card
@pytest.mark.parametrize("shift", range(len(KINDS)))
def test_all_tiles_launch_is_one_launch_a_tile_bit_for_bit(store, shift):
    """ml20m's tile widths with the block form's four: the all-tiles call
    against one call a tile (a*x and x bit for bit), against itself (obj and
    reg too), bf16 tiles against fp32 tiles of the same values bit for bit;
    every carry, K3 and K4."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(shift)
    tables = {dt: _table(dev, ML20M_LS, shift=shift, tiles=dt) for dt in DTYPES}
    n_buf = tables[torch.float32][1]
    for carry in DTYPES:
        buf0 = (torch.randn(n_buf, generator=gen, device=dev) * 50).to(carry)
        for want_x in (False, True):
            table = tables[torch.float32][0]
            got = fused_panel_project_tiles(buf0.clone(), table, -2.0, want_x=want_x)
            again = fused_panel_project_tiles(buf0.clone(), table, -2.0, want_x=want_x)
            bf = fused_panel_project_tiles(buf0.clone(), tables[torch.bfloat16][0], -2.0, want_x=want_x)
            per, per_x = buf0.clone(), []
            for t in table.tiles:
                per_x += fused_panel_project(per, t.a, t.c, t.length, t.off, t.kind, t.params, want_x=want_x,
                                             neg_inv_gamma=-2.0)[3:]
            assert torch.equal(got[0], per), (str(carry), want_x)
            for other in (again, bf):
                assert all(torch.equal(u, v) for u, v in zip(got[:3], other[:3])), (str(carry), want_x)
            if want_x:
                for g, p, a, b in zip(got[3], per_x, again[3], bf[3]):
                    assert torch.equal(g, p) and torch.equal(g, a) and torch.equal(g, b)
            ref = fused_panel_project_tiles_reference(buf0.clone(), table, -2.0, want_x=want_x)
            e = float((got[0].float() - ref[0].float()).abs().max())
            assert e <= _tol(ref[0], carry), (str(carry), want_x, e)
            for i in (1, 2):
                assert abs(float(got[i]) - float(ref[i])) <= 1e-3 + 1e-4 * abs(float(ref[i]))


@pytest.mark.card
def test_block_tiles_counter(store):
    """A call over ml20m's tile widths sends its four tiles above L = 512 to
    the block form; a table with none sends none."""
    dev = _card()
    ml20m, n_buf = _table(dev, ML20M_LS)
    narrow, n_narrow = _table(dev, [L for L in ML20M_LS if L <= PANEL_WARP_L_CAP])
    assert [ml20m.tiles[i].L for i in ml20m.blocks] == [1024, 2045, 3924, 6726]
    assert [panel_path(L).threads for L in (1024, 2045, 3924, 6726)] == [128, 256, 512, 1024]
    key = "dualip.ops.fused_panel_project_tiles.block_tiles"
    fused_panel_project_tiles(torch.zeros(n_buf, device=dev), ml20m, -2.0)
    assert profiling.counter(key) == 4
    fused_panel_project_tiles(torch.zeros(n_buf, device=dev), ml20m, -2.0, want_x=True)
    assert profiling.counter(key) == 8
    fused_panel_project_tiles(torch.zeros(n_narrow, device=dev), narrow, -2.0)
    assert profiling.counter(key) == 8 and narrow.blocks == ()
    assert profiling.counter("dualip.ops.fused_panel_project_tiles.enqueued") == 2
    assert profiling.counter("dualip.ops.fused_panel_project.block_tiles") == 0
