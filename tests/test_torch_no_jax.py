"""The port never imports JAX: every ``gs360x_torch`` module, and
``chip_smoke`` as a module, import in a fresh interpreter with no ``jax``
in ``sys.modules`` afterwards, and of the JAX package ``gs360x`` only its
JAX-free host modules. A subprocess, because this test process has
already imported JAX. ``chip_smoke.py`` itself imports nothing of
``gs360x``."""

import ast
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

# the JAX-free host modules of gs360x the port may reuse by import, and
# the package __init__s on their way
ALLOWED_GS360X = {
    "gs360x", "gs360x.io", "gs360x.io.image", "gs360x.io.video",
    "gs360x.runtime", "gs360x.runtime.profiling", "gs360x.runtime.cancel",
    "gs360x.native",
}

PROBE = """
import importlib, json, pkgutil, sys
import gs360x_torch
names = [m.name for m in pkgutil.walk_packages(gs360x_torch.__path__,
                                                "gs360x_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(sys.modules)
print(json.dumps({
    "n_modules": len(names),
    "jax": [m for m in loaded if m == "jax" or m.startswith("jax.")],
    "gs360x": [m for m in loaded if m == "gs360x" or m.startswith("gs360x.")],
}))
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert seen["n_modules"] >= 15, seen
    assert seen["jax"] == [], seen["jax"]
    assert set(seen["gs360x"]) <= ALLOWED_GS360X, seen["gs360x"]


def test_chip_smoke_imports_nothing_of_the_jax_package():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module or "")
    roots = {name.split(".")[0] for name in imported}
    assert "gs360x_torch" in roots
    assert not roots & {"gs360x", "jax", "jaxlib", "flax"}, sorted(roots)
