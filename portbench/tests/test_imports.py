"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port.  Top-level names are compared
whole: ``repro_torch`` is the port, ``repro`` the JAX package."""
import ast
import subprocess
import sys

import pytest

from portbench.bench import FORBIDDEN, PKG, ROOT

SOURCES = sorted(PKG.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    for m in _imports(path):
        top = m.split(".")[0]
        assert top != "repro_torch", m
        assert top != "portbench" or m.startswith("portbench.reference"), m


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from portbench import bench, port, check\n"
            % (str(ROOT), str(ROOT / "src")))
    code += ("from portbench import calibrate, faults, sweep\n"
             "from portbench.reference import dense\n"
             "import repro_torch.serve.loop, repro_torch.models.model\n"
             "print(bench.loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
