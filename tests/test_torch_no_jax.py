"""The port never imports JAX, and nothing of the JAX package: every
``gs360x_torch`` module (the remap path, the tools, the sharpness and flow
modules, the host IO and camera-format copies, the segmentation model,
MaskSeg, segtrain, the voxel path, PlyOptimizer, the scene loader, the
warmup tool, the data mesh and the 12 GUI modules named explicitly), and ``chip_smoke`` as a module, import in a
fresh interpreter with no ``jax``, no ``gs360x`` and no ``flax``,
``msgpack``, ``orbax`` or ``optax`` module in ``sys.modules`` afterwards. A
subprocess, because this test process has already imported JAX. No source
file of the port, nor ``chip_smoke.py``, names any of them in an
import, and every ``gs360x-torch-*`` script of ``pyproject.toml`` runs the
``main`` of a port module."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

# the modules of gs360x the port may import: none
ALLOWED_GS360X = set()
GUI_MODULES = {f"gs360x_torch.gui.{name}" for name in (
    "app", "forms", "maskedit", "monitor", "overlay", "plyview",
    "pointedit", "runner", "scorereview", "segpreview", "settings")} \
    | {"gs360x_torch.gui"}

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
    "names": names,
    "jax": [m for m in loaded if m == "jax" or m.startswith("jax.")],
    "gs360x": [m for m in loaded if m == "gs360x" or m.startswith("gs360x.")],
    "forbidden": [m for m in loaded
                  if m.split(".")[0] in ("flax", "msgpack", "orbax", "optax")],
}))
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert seen["n_modules"] >= 40, seen
    assert {"gs360x_torch.kernels.remap_cuda",
            "gs360x_torch.kernels.micro_ops_cuda",
            "gs360x_torch.tools.micro_ops",
            "gs360x_torch.tools.ms360xml",
            "gs360x_torch.tools.camconvert",
            "gs360x_torch.io.image", "gs360x_torch.io.video",
            "gs360x_torch.io.ply", "gs360x_torch.io.formats.hub",
            "gs360x_torch.native", "gs360x_torch.templates",
            "gs360x_torch.runtime.profiling",
            "gs360x_torch.runtime.mesh",
            "gs360x_torch.runtime.cancel",
            "gs360x_torch.runtime.throttle",
            "gs360x_torch.core.pose",
            "gs360x_torch.tools.dualfisheye",
            "gs360x_torch.tools.video2frames",
            "gs360x_torch.tools.frameselector",
            "gs360x_torch.kernels.sharpness",
            "gs360x_torch.kernels.flow",
            "gs360x_torch.kernels.morphology",
            "gs360x_torch.models.weights",
            "gs360x_torch.models.segmentation",
            "gs360x_torch.models.instances",
            "gs360x_torch.models.synthseg",
            "gs360x_torch.tools.maskseg",
            "gs360x_torch.kernels.voxel",
            "gs360x_torch.io.scene",
            "gs360x_torch.tools.segtrain",
            "gs360x_torch.tools.plyopt",
            "gs360x_torch.tools.scene",
            "gs360x_torch.tools.warmup"} | GUI_MODULES <= set(seen["names"])
    assert seen["jax"] == [], seen["jax"]
    assert set(seen["gs360x"]) <= ALLOWED_GS360X, seen["gs360x"]
    assert seen["forbidden"] == [], seen["forbidden"]


# the card's machine has none of these: the JAX package's weights and
# checkpoints go through flax, msgpack, orbax and optax; the port reads its
# weights with its own msgpack reader
FORBIDDEN_ROOTS = {"gs360x", "jax", "jaxlib", "flax", "msgpack", "orbax",
                   "optax"}


def imported_roots(path: pathlib.Path) -> set:
    """Top-level names of every import statement of one source file,
    wherever it stands (module level or inside a function)."""
    tree = ast.parse(path.read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module or "")
    return {name.split(".")[0] for name in imported}


def port_sources() -> list:
    return sorted((ROOT / "gs360x_torch").rglob("*.py"))


def test_chip_smoke_imports_nothing_of_the_jax_package():
    # the port's scripts at the root: the smoke run and the A/B timers
    for script in ("chip_smoke.py", "resample_ab.py", "video_batch_ab.py"):
        roots = imported_roots(ROOT / script)
        assert "gs360x_torch" in roots, script
        assert not roots & FORBIDDEN_ROOTS, (script, sorted(roots))


PACKAGES = ["core", "gui", "io", "kernels", "models", "native", "rig",
            "runtime", "tools"]


def test_every_port_source_is_in_a_checked_package():
    parts = {p.relative_to(ROOT / "gs360x_torch").parts for p in port_sources()}
    assert len(parts) >= 40
    assert {p[0] for p in parts if len(p) > 1} == set(PACKAGES)


@pytest.mark.parametrize("package", PACKAGES + ["*.py"])
def test_port_package_imports_nothing_of_the_jax_package(package):
    """One case a subpackage, and one for the modules at the port's root."""
    base = ROOT / "gs360x_torch"
    sources = sorted(base.glob("*.py")) if package == "*.py" else \
        [p for p in port_sources() if p.relative_to(base).parts[0] == package]
    assert sources, package
    for path in sources:
        roots = imported_roots(path)
        assert not roots & FORBIDDEN_ROOTS, (path, sorted(roots))


# script gs360x-torch-<name>: the port module whose main it runs
PORT_SCRIPTS = {name: f"tools.{name}" for name in (
    "perspcut", "dualfisheye", "video2frames", "frameselector", "ms360xml",
    "camconvert", "maskseg", "segtrain", "plyopt", "scene", "warmup")}
PORT_SCRIPTS["gui"] = "gui.app"


@pytest.mark.parametrize("tool", PORT_SCRIPTS)
def test_port_script_runs_a_port_module(tool):
    text = (ROOT / "pyproject.toml").read_text()
    module = PORT_SCRIPTS[tool]
    line = f'gs360x-torch-{tool} = "gs360x_torch.{module}:main"'
    assert line in text.splitlines()
    roots = imported_roots(ROOT / "gs360x_torch"
                           / f"{module.replace('.', '/')}.py")
    assert not roots & FORBIDDEN_ROOTS, (tool, sorted(roots))
    assert sum(ln.startswith("gs360x-torch-")
               for ln in text.splitlines()) == len(PORT_SCRIPTS)
