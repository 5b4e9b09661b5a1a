"""The PyTorch port imports neither JAX nor anything of the JAX package.

An AST scan, because an interpreter that preloads jax would hide a stray
import from a runtime check."""

import ast
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "dualip_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == p or name.startswith(p + ".") for p in ("jax", "jaxlib", "dualip_tpu"))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_port_package_imports_without_cuda():
    import dualip_tpu_torch
    import dualip_tpu_torch.ops.fused_matching as fm

    assert dualip_tpu_torch.run_solver is not None
    assert fm.fused_tile_eval_T.launches >= 0
