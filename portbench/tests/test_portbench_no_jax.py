"""Nothing the benchmark runs or imports is JAX, Flax or the JAX package
(top-level names compared whole: ``gs360x_torch`` is not ``gs360x``), and
the plain reference imports nothing of the program."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

from portbench import harness

BENCH = harness.HERE
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
                 p.parts)


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_forbidden_import(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), tops
    if "reference" in path.relative_to(BENCH).parts:
        assert "gs360x_torch" not in tops


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gs360x_torch_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gs360x.core", object())
    assert harness.forbidden_modules() == ["gs360x.core"]


def test_loading_everything_loads_no_jax():
    """Every benchmark module, driver and reader, and what the drivers
    import of the program, in a fresh process: no JAX is loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness, control, run\n"
        "import pathlib\n"
        "for p in sorted(pathlib.Path(%r).glob('*/*.py')):\n"
        "    if p.parent.name in ('drivers', 'metrics'):\n"
        "        harness.load_module(p)\n"
        "import gs360x_torch.tools.perspcut, gs360x_torch.tools.dualfisheye\n"
        "import gs360x_torch.runtime.executor\n"
        "print(harness.forbidden_modules())\n"
    ) % (str(harness.ROOT), str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=dict(os.environ))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
