"""The check: sound runs pass, and each of the traffic's controls (the
reference in bfloat16, or the program on its own lower-precision path, in the
program's place) and each fault the cells can have (``gpubench/faults.py``)
fail, under the real cells' limits, at a tiny size on the CPU.  The fault
between cards (``lost_rank_part``) is a multi-card cell's:
``test_bench_ranks.py`` plants it in two ranks."""

import pytest

from gpubench import core, faults
from gpubench.control import controls

CELLS = ["canon25m-csc-fused", "canon25m-csc-default", "ml20m-csc-fused", "ml20m-butterfly"]
SEED = 2**31 + 99


@pytest.mark.parametrize("cell", CELLS)
def test_sound_and_control(tiny_root, cell):
    assert core.run(cell, SEED, 0.0, False, device="cpu", root=tiny_root, calls=2)["correct"]
    for spec in controls(core.Cell(cell, tiny_root)):
        res = core.run(cell, SEED, 0.0, False, device="cpu", root=tiny_root, calls=2,
                       control=spec)
        assert not res["correct"] and res["failed"] >= 1, spec["name"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_faults_fail(tiny_root, monkeypatch, fault, cell):
    faults.FAULTS[fault](monkeypatch.setattr)
    res = core.run(cell, SEED, 0.0, False, device="cpu", root=tiny_root, calls=2)
    assert not res["correct"], res["compared"]


def test_planted_is_undone():
    from dualip_tpu_torch.optimizers import agd

    before = agd.AcceleratedGradientDescent.maximize
    with faults.planted("altered_answer"):
        assert agd.AcceleratedGradientDescent.maximize is not before
    assert agd.AcceleratedGradientDescent.maximize is before
