"""The harness on the card at a tiny size: the kernels' paths pass the check
and the controls fail it.  Skips without a card."""

import pytest
import torch

from gpubench import core
from gpubench.control import controls

CELLS = ["canon25m-csc-fused", "canon25m-csc-default", "ml20m-csc-fused", "ml20m-butterfly"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_on_the_card(tiny_root, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert core.run(cell, 17, 0.0, False, device="cuda", root=tiny_root, calls=2)["correct"]
    for spec in controls(core.Cell(cell, tiny_root)):
        assert not core.run(cell, 17, 0.0, False, device="cuda", root=tiny_root, calls=2,
                            control=spec)["correct"], spec["name"]


@pytest.mark.card
@pytest.mark.parametrize("config", ["matching-canonical-25m", "movielens-20m"])
def test_generators_repeat_on_the_card(tiny_root, config):
    """The same seed gives the same inputs on the card, bit for bit (a float
    scan or atomic sum there may not)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = next(core.Cell(w, tiny_root) for w in CELLS if core.Cell(w, tiny_root).config["name"] == config)
    one, two = (core.make_inputs(cell, 2**31 + 5, "cuda") for _ in range(2))
    for key in ("indptr", "rows", "a", "c", "b"):
        assert (getattr(one, key) == getattr(two, key)).all(), key
