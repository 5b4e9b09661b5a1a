"""Solve the LP relaxation of a MIPLIB 2017 instance with the PyTorch/CUDA
port (``examples/miplib_2017/solve_miplib_dataset.py`` of the JAX package).

Reads the bundled ``v150d30-2hopcds`` instance (public MIPLIB 2017 data),
runs 10,000 AGD iterations at gamma 1e-3 (initial step 1e-5) through
``run_solver(objective_type="miplib2017")`` and checks that the dual
objective lands at 27 +- 1: exit code 0 when it does, 1 when it does not.

    python -m dualip_tpu_torch.examples.miplib_2017.solve_miplib_dataset \
        [--mps-path PATH] [--max-iter N] [--device cuda|cpu] [--num-devices N]

``--num-devices N > 1`` runs the sharded solve (``compute_device_num=N``)
over N ranks: those of an initialised ``torch.distributed`` group (a script
started by ``torchrun`` with ``WORLD_SIZE`` set joins it), else N ranks
spawned here (``parallel.run_ranks``): NCCL with one card each on ``cuda``,
gloo on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

MPS_PATH = Path(__file__).resolve().parents[3] / "examples" / "miplib_2017" / "v150d30-2hopcds.mps.gz"


def solve(mps_path, max_iter: int, initial_step_size: float, gamma: float, device: str, num_devices: int = 1):
    """``(dual objective, solve seconds)`` of ``run_solver`` on the instance."""
    from dualip_tpu_torch import ComputeArgs, ObjectiveArgs, SolverArgs, run_solver
    from dualip_tpu_torch.io.mps import read_mps_file

    t0 = time.perf_counter()
    lp = read_mps_file(mps_path, verbose=True)
    print(f"parsed in {time.perf_counter() - t0:.2f}s", flush=True)
    t0 = time.perf_counter()
    result = run_solver(
        input_args=lp.to_miplib_input_args(),
        solver_args=SolverArgs(max_iter=max_iter, initial_step_size=initial_step_size, gamma=gamma),
        compute_args=ComputeArgs(host_device=device, compute_device_num=num_devices),
        objective_args=ObjectiveArgs(objective_type="miplib2017"),
    )
    return float(result.dual_objective), time.perf_counter() - t0


def _rank_solve(mesh, mps_path, max_iter, initial_step_size, gamma):
    """One spawned rank's solve (``parallel.run_ranks`` calls it with the rank's mesh)."""
    device = "cpu" if mesh.device.type == "cpu" else "cuda"
    return solve(mps_path, max_iter, initial_step_size, gamma, device, mesh.world_size)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mps-path", default=str(MPS_PATH))
    parser.add_argument("--max-iter", type=int, default=10000)
    parser.add_argument("--initial-step-size", type=float, default=1e-5)
    parser.add_argument("--gamma", type=float, default=1e-3)
    parser.add_argument("--device", default="cuda", help="cuda | cpu")
    parser.add_argument("--num-devices", type=int, default=1,
                        help="ranks of the sharded general-LP path (sparse A shards by nnz)")
    parser.add_argument("--expected-dual", type=float, default=27.0)
    parser.add_argument("--tolerance", type=float, default=1.0)
    args = parser.parse_args(argv)

    run = (args.mps_path, args.max_iter, args.initial_step_size, args.gamma)
    if args.num_devices > 1:
        import torch.distributed as dist

        from dualip_tpu_torch.parallel import initialize_multihost

        if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
            initialize_multihost("env://", device=args.device)
        if dist.is_initialized():
            dual, solve_s = solve(*run, args.device, args.num_devices)
        else:
            from dualip_tpu_torch.examples.miplib_2017 import solve_miplib_dataset as this
            from dualip_tpu_torch.parallel import run_ranks

            duals = run_ranks(this._rank_solve, args.num_devices, args=run,
                              device="cpu" if args.device == "cpu" else None, join_timeout_s=3600.0)
            dual, solve_s = duals[0]
    else:
        dual, solve_s = solve(*run, args.device)
    print(f"solved in {solve_s:.1f}s")
    print(f"dual objective: {dual:.4f}")

    err = abs(dual - args.expected_dual)
    if err > args.tolerance:
        print(f"FAIL: |{dual:.4f} - {args.expected_dual}| = {err:.4f} > {args.tolerance}")
        return 1
    print(f"OK: within {args.tolerance} of expected {args.expected_dual}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
