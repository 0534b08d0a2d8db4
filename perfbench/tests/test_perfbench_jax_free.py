"""Nothing the benchmark runs imports JAX or the JAX package: neither its
sources (top-level module names compared whole) nor the modules loaded by
a run; and the reference imports nothing of the system under test."""

import ast
import subprocess
import sys

from perfbench import harness, spec

FORBIDDEN = set(harness.FORBIDDEN)


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_sources_import_no_jax():
    files = sorted((spec.ROOT / "perfbench").rglob("*.py"))
    assert files
    for path in files:
        found = set(_imports(path)) & FORBIDDEN
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_system():
    for path in sorted((spec.ROOT / "perfbench" / "reference").glob("*.py")):
        tops = set(_imports(path))
        assert "nerf_mae_torch" not in tops and "perfbench" not in tops, path
        assert tops <= {"__future__", "functools", "math", "typing", "numpy", "torch"}, path


def test_run_loads_no_jax():
    """A whole (tiny, CPU) run in a fresh interpreter leaves no forbidden
    top-level name in sys.modules; "nerf_mae_torch" starts with the JAX
    package's name and must not count."""
    code = ("import sys; from perfbench.tests import tiny; from perfbench import harness; "
            "tiny.run(tiny.cell('fcos_s160_obb'), traced=True); "
            "assert 'nerf_mae_torch' in sys.modules; print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "nerf_mae_tpu_extra", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert harness.forbidden_modules() == ["flax"]
