"""How far two faithful solves of one problem part along the AGD trajectory.

The port's csc solve and the JAX package's, on the same native-generator data
(20,000 sources x 10,000 destinations, sparsity 1e-3, seed 42; gamma 1e-3,
steps 1e-3/1e-1, the canonical run's solver settings), agree to 1e-6
relative over the first 20 iterations; by iteration 200 their rounding
differences have grown to parts in 1e-3, the size of the gap that
``chip_smoke.py --phases canonical`` allows (1e-2) against the JAX package's
canonical dual.  A float64 solve of the same problem by the port is the
third witness: both float32 solves lie within the same 1e-2 of it.  Run with
``-s`` to print the readings."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dualip_tpu.objectives.matching import (
    MatchingInputArgs as JaxArgs,
    MatchingSolverDualObjectiveFunction as JaxObjective,
)
from dualip_tpu.optimizers.agd import AcceleratedGradientDescent as JaxAGD
from dualip_tpu.projections import create_projection_map as jax_pm
from dualip_tpu.sparse import csc_from_arrays as jax_csc
from dualip_tpu_torch.io import native_loader
from dualip_tpu_torch.objectives.matching import MatchingSolverDualObjectiveFunction
from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent
from dualip_tpu_torch.synthetic import generate_synthetic_matching_input_args

torch.set_num_threads(1)

SOURCES, ITERS = 20_000, 200
SOLVER = dict(gamma=1e-3, initial_step_size=1e-3, max_step_size=1e-1, max_iter=ITERS)


def _rel(a, b):
    return np.abs(a - b) / np.abs(b)


def test_port_and_jax_csc_solves_agree_early_and_part_by_rounding_late(monkeypatch):
    if not native_loader.native_available():
        pytest.skip("no C++ toolchain builds native/dualip_native.cc")
    monkeypatch.setenv("DUALIP_GEN_BACKEND", "native")
    port = generate_synthetic_matching_input_args(SOURCES, 10_000, 1e-3, seed=42)
    A, C = port.A, port.c
    m = A.shape[0]
    jax = JaxArgs(A=jax_csc(A.indptr, A.row_indices, A.data, A.shape),
                  c=jax_csc(C.indptr, C.row_indices, C.data, C.shape),
                  projection_map=jax_pm("simplex", {"z": 1.0}, SOURCES), b_vec=port.b_vec)

    obj = MatchingSolverDualObjectiveFunction(port, gamma=SOLVER["gamma"], device="cpu")
    p32 = AcceleratedGradientDescent(**SOLVER).maximize(obj, torch.zeros(m)).dual_objective_log
    p64 = AcceleratedGradientDescent(**SOLVER).maximize(obj, torch.zeros(m, dtype=torch.float64)).dual_objective_log
    j32 = JaxAGD(**SOLVER).maximize(JaxObjective(jax, gamma=SOLVER["gamma"]), jnp.zeros(m)).dual_objective_log
    p32, p64, j32 = (np.asarray(x, dtype=np.float64) for x in (p32, p64, j32))
    assert len(p32) == len(p64) == len(j32) == ITERS

    early, late = _rel(p32, j32)[:20].max(), _rel(p32, j32)[-1]
    print(f"\nport fp32 vs JAX fp32: first 20 iterations {early:.3e}, iteration {ITERS} {late:.3e}; "
          f"port fp32 vs port fp64 {_rel(p32, p64)[-1]:.3e}; JAX fp32 vs port fp64 {_rel(j32, p64)[-1]:.3e}")
    assert early <= 1e-6  # the same computation, before the trajectory amplifies its rounding
    assert _rel(p32, p64)[:20].max() <= 1e-6
    for got in (p32, j32):  # the canonical check's limit holds the spread of faithful solves
        assert _rel(got, p64)[-1] <= 1e-2
    assert late <= 1e-2
