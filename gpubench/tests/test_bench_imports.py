"""Nothing the harness or the reference loads is JAX or the JAX package
(top-level names compared whole: ``dualip_tpu_torch`` is not
``dualip_tpu``), and the reference loads nothing of the program."""

import ast
import subprocess
import sys

from gpubench.tests.conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "dualip_tpu"}


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        names = set(imported(p))
        assert not names & FORBIDDEN, (p, names & FORBIDDEN)
        if "reference" in p.parts:
            assert "dualip_tpu_torch" not in names and "gpubench" not in names, p


PROBE = """
import sys
sys.path.insert(0, {root!r})
import gpubench.reference.matching
ref = sorted(m for m in sys.modules if m.split('.')[0] in ('dualip_tpu_torch', 'jax', 'jaxlib', 'flax', 'dualip_tpu'))
from gpubench import core
from gpubench.tests.conftest import make_root
from pathlib import Path
import tempfile
with tempfile.TemporaryDirectory() as d:
    root = make_root(Path(d))
    for w in ('canon25m-csc-fused', 'ml20m-butterfly'):
        assert core.run(w, 1, 0.05, False, device='cpu', root=root)['correct']
print(ref, core.forbidden_modules(), 'dualip_tpu_torch' in sys.modules)
"""


def test_loaded_modules():
    done = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip().splitlines()[-1] == "[] [] True"


def test_forbidden_names_whole(monkeypatch):
    from gpubench import core

    monkeypatch.setitem(sys.modules, "jax.numpy", type(sys)("jax.numpy"))
    monkeypatch.setitem(sys.modules, "dualip_tpu_torch_extra", type(sys)("dualip_tpu_torch_extra"))
    assert core.forbidden_modules() == ["jax.numpy"]
