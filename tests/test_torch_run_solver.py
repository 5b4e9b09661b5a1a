"""``run_solver`` through the port against the JAX package's, on the README
quickstart problem; the CUDA default; warm starts from a checkpoint."""

import numpy as np
import pytest
import torch

import dualip_tpu
import dualip_tpu_torch
from dualip_tpu.objectives.matching import MatchingInputArgs as JaxArgs
from dualip_tpu.projections import create_projection_map as jax_pm
from dualip_tpu.sparse import csc_from_dense as jax_csc
from dualip_tpu_torch.checkpoint import load_dual, save_dual
from dualip_tpu_torch.objectives.matching import MatchingInputArgs
from dualip_tpu_torch.optimizers.agd import AcceleratedGradientDescent
from dualip_tpu_torch.optimizers.agd_utils import StepSizeState
from dualip_tpu_torch.projections import create_projection_map
from dualip_tpu_torch.sparse import csc_from_dense
from dualip_tpu_torch.synthetic import generate_synthetic_matching_input_args
from dualip_tpu_torch.utils.mlflow_utils import MLflowConfig

torch.set_num_threads(1)

QUICKSTART_A = np.array([[0.3, 0.5], [0.2, 0.8]], dtype=np.float32)  # README quickstart
QUICKSTART_B = np.array([0.7, 0.7], dtype=np.float32)


def _port_args():
    return MatchingInputArgs(
        A=csc_from_dense(QUICKSTART_A), c=csc_from_dense(-QUICKSTART_A),
        projection_map=create_projection_map("simplex", {"z": 1}, num_indices=2), b_vec=QUICKSTART_B,
    )


@pytest.mark.parametrize("objective_kwargs", [None, {"use_pallas": True, "pallas_block_k": 8}])
def test_run_solver_matches_jax_on_quickstart(objective_kwargs):
    ref = dualip_tpu.run_solver(
        input_args=JaxArgs(
            A=jax_csc(QUICKSTART_A), c=jax_csc(-QUICKSTART_A),
            projection_map=jax_pm("simplex", {"z": 1}, num_indices=2), b_vec=QUICKSTART_B,
        ),
        solver_args=dualip_tpu.SolverArgs(max_iter=300, gamma=1e-3),
        compute_args=dualip_tpu.ComputeArgs(host_device="cpu", compute_device_num=1),
        objective_args=dualip_tpu.ObjectiveArgs(objective_type="matching", objective_kwargs=objective_kwargs),
    )
    got = dualip_tpu_torch.run_solver(
        input_args=_port_args(),
        solver_args=dualip_tpu_torch.SolverArgs(max_iter=300, gamma=1e-3),
        compute_args=dualip_tpu_torch.ComputeArgs(host_device="cpu", compute_device_num=1),
        objective_args=dualip_tpu_torch.ObjectiveArgs(objective_type="matching", objective_kwargs=objective_kwargs),
    )
    # fp32 sums in other orders: the traces drift apart by ~3e-5 relative
    # over 300 iterations, so they are held at 1e-4
    assert len(got.dual_objective_log) == 300
    np.testing.assert_allclose(got.dual_objective_log, ref.dual_objective_log, rtol=1e-4)
    np.testing.assert_allclose(got.dual_val.numpy(), np.asarray(ref.dual_val), rtol=1e-4, atol=1e-5)
    assert got.dual_val.device.type == "cpu"


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    assert dualip_tpu_torch.ComputeArgs().host_device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dualip_tpu_torch.run_solver(
            _port_args(), dualip_tpu_torch.SolverArgs(max_iter=2), dualip_tpu_torch.ComputeArgs(),
            dualip_tpu_torch.ObjectiveArgs(),
        )
    from dualip_tpu_torch.objectives.matching import MatchingSolverDualObjectiveFunction

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MatchingSolverDualObjectiveFunction(_port_args(), gamma=1e-3)


def test_later_slices_raise():
    args = (_port_args(), dualip_tpu_torch.SolverArgs(max_iter=2))
    # the sharded solve is in (distributed slice); without a process group it
    # says how to launch one instead of solving on one device
    with pytest.raises(RuntimeError, match="torchrun"):
        dualip_tpu_torch.run_solver(
            *args, dualip_tpu_torch.ComputeArgs(host_device="cpu", compute_device_num=2),
            dualip_tpu_torch.ObjectiveArgs(),
        )

    # MLflow logging is in (observability slice): enabled without mlflow, the solve runs
    res = dualip_tpu_torch.run_solver(
        *args, dualip_tpu_torch.ComputeArgs(host_device="cpu"), dualip_tpu_torch.ObjectiveArgs(),
        MLflowConfig(enabled=True),
    )
    assert len(res.dual_objective_log) == 2 and np.isfinite(res.dual_objective)


def test_warm_start_resumes_the_solve(tmp_path):
    """A checkpoint round-trips (npz with the window, torch .pt), and a solve
    resumed from it starts no worse than the cold start.  The window may be
    numpy arrays with an int count or tensors with a 0-d count; either loads
    with the count as a 0-d int32 tensor."""
    kwargs = dict(compute_args=dualip_tpu_torch.ComputeArgs(host_device="cpu"),
                  objective_args=dualip_tpu_torch.ObjectiveArgs())
    first = dualip_tpu_torch.run_solver(_port_args(), dualip_tpu_torch.SolverArgs(max_iter=30, gamma=1e-3), **kwargs)
    path = tmp_path / "dual.npz"
    for window in (StepSizeState(np.zeros((15, 2), np.float32), np.zeros((15, 2), np.float32), 3),
                   StepSizeState(torch.zeros((15, 2)), torch.zeros((15, 2)), torch.tensor(3, dtype=torch.int32))):
        save_dual(str(path), first.dual_val, window)
        dual, state = load_dual(str(path))
        np.testing.assert_array_equal(dual, first.dual_val.numpy())
        assert int(state.count) == 3 and state.count.dtype == torch.int32 and state.count.dim() == 0
        assert state.grad_hist.shape == (15, 2)
    torch.save(first.dual_val, tmp_path / "dual.pt")
    np.testing.assert_array_equal(load_dual(str(tmp_path / "dual.pt"))[0], dual)
    resumed = dualip_tpu_torch.run_solver(
        _port_args(), dualip_tpu_torch.SolverArgs(max_iter=5, gamma=1e-3, initial_dual_path=str(path)), **kwargs
    )
    assert resumed.dual_objective_log[0] >= first.dual_objective_log[0]
    assert np.all(np.isfinite(resumed.dual_objective_log))


def test_float64_duals_solve_in_float32(tmp_path):
    """A float64 warm start (np.save of a float64 dual) and a float64 numpy
    initial value run in float32, as the JAX package runs them with x64 off."""
    dual64 = np.array([0.05, 0.02], dtype=np.float64)
    np.save(tmp_path / "dual64.npy", dual64)
    kwargs = dict(compute_args=dualip_tpu_torch.ComputeArgs(host_device="cpu"),
                  objective_args=dualip_tpu_torch.ObjectiveArgs(objective_kwargs={"use_pallas": True,
                                                                                  "pallas_block_k": 8}))
    warm = dualip_tpu_torch.run_solver(
        _port_args(), dualip_tpu_torch.SolverArgs(max_iter=20, initial_dual_path=str(tmp_path / "dual64.npy")),
        **kwargs,
    )
    ref = dualip_tpu.run_solver(
        JaxArgs(A=jax_csc(QUICKSTART_A), c=jax_csc(-QUICKSTART_A),
                projection_map=jax_pm("simplex", {"z": 1}, num_indices=2), b_vec=QUICKSTART_B),
        dualip_tpu.SolverArgs(max_iter=20, initial_dual_path=str(tmp_path / "dual64.npy")),
        dualip_tpu.ComputeArgs(host_device="cpu"),
        dualip_tpu.ObjectiveArgs(objective_kwargs={"use_pallas": True, "pallas_block_k": 8}),
    )
    assert warm.dual_val.dtype == torch.float32
    np.testing.assert_allclose(warm.dual_objective_log, ref.dual_objective_log, rtol=1e-5)
    objective = dualip_tpu_torch.build_objective(
        _port_args(), dualip_tpu_torch.SolverArgs(), kwargs["compute_args"], kwargs["objective_args"]
    )
    solver = AcceleratedGradientDescent(max_iter=3, gamma=1e-3)
    assert solver.maximize(objective, dual64).dual_val.dtype == torch.float32


def test_synthetic_input_args_are_float32():
    args = generate_synthetic_matching_input_args(500, 20, 0.1, seed=42)
    assert args.A.data.dtype == np.float32 and args.b_vec.dtype == np.float32
    assert args.A.shape == (20, 500) and args.A.nnz > 0
    assert np.all(args.c.data <= 0)
