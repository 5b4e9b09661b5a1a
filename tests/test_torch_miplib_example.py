"""The port's MIPLIB 2017 example script against the JAX package's
``run_solver`` on the bundled instance, and its exit codes."""

import re

import numpy as np
import pytest
import torch

from dualip_tpu_torch.examples.miplib_2017 import solve_miplib_dataset as sm

torch.set_num_threads(2)

ITERS = 200


def _printed_dual(out: str) -> float:
    return float(re.search(r"dual objective: (\S+)", out).group(1))


@pytest.fixture(scope="module")
def duals():
    """The 200-iteration logs of both packages on the instance."""
    from dualip_tpu import ComputeArgs, ObjectiveArgs, SolverArgs, run_solver
    from dualip_tpu.io.mps import read_mps_file

    import dualip_tpu_torch as dt
    from dualip_tpu_torch.io.mps import read_mps_file as port_read

    kw = dict(max_iter=ITERS, initial_step_size=1e-5, gamma=1e-3)
    jax_res = run_solver(read_mps_file(str(sm.MPS_PATH)).to_miplib_input_args(), SolverArgs(**kw),
                         ComputeArgs(host_device="cpu"), ObjectiveArgs(objective_type="miplib2017"))
    port_res = dt.run_solver(port_read(str(sm.MPS_PATH)).to_miplib_input_args(), dt.SolverArgs(**kw),
                             dt.ComputeArgs(host_device="cpu"), dt.ObjectiveArgs(objective_type="miplib2017"))
    return np.asarray(jax_res.dual_objective_log), np.asarray(port_res.dual_objective_log)


def test_main_solves_as_run_solver_and_follows_the_jax_package(duals, capsys):
    """The script's dual is the port's ``run_solver`` dual.  Against the JAX
    package: the first 10 iterations within 1e-4 (the objective is a sum of
    large cancelling terms, so the two fp32 sums already differ by up to 7e-5
    while the step sizes are still equal) and the 200th within 1e-2, the
    spread of faithful solves that part through the step-size window."""
    jax_log, port_log = duals
    assert sm.main(["--max-iter", str(ITERS), "--device", "cpu", "--expected-dual", "0", "--tolerance", "1e9"]) == 0
    assert _printed_dual(capsys.readouterr().out) == float(f"{port_log[-1]:.4f}")
    dev = np.abs(port_log - jax_log) / np.maximum(1.0, np.abs(jax_log))
    assert dev[:10].max() <= 1e-4, dev[:10]
    assert dev[-1] <= 1e-2, dev[-1]


@pytest.mark.parametrize("offset,tolerance,code", [(0.0, 1e-3, 0), (1.0, 0.5, 1), (-1.0, 0.5, 1)],
                         ids=["inside", "above", "below"])
def test_exit_code_on_either_side_of_the_tolerance(duals, capsys, offset, tolerance, code):
    dual = float(f"{duals[1][-1]:.4f}")
    args = ["--max-iter", str(ITERS), "--device", "cpu", "--expected-dual", str(dual + offset),
            "--tolerance", str(tolerance)]
    assert sm.main(args) == code
    assert ("OK:" if code == 0 else "FAIL:") in capsys.readouterr().out


def test_two_spawned_ranks_solve_the_sharded_path(capsys):
    """``--num-devices 2`` without a process group spawns two gloo ranks."""
    assert sm.main(["--max-iter", "50", "--device", "cpu", "--num-devices", "2",
                    "--expected-dual", "0", "--tolerance", "1e9"]) == 0
    sharded = _printed_dual(capsys.readouterr().out)
    one, _ = sm.solve(sm.MPS_PATH, 50, 1e-5, 1e-3, "cpu")
    assert abs(sharded - one) <= 1e-4 * max(1.0, abs(one)), (sharded, one)
