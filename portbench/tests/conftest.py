"""The benchmark's CPU tests import ``portbench`` from the checkout's root
(``python -m pytest portbench/tests``); nothing here imports JAX."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def tiny_spec(tmp_path):
    """The checkout's spec with every configuration and traffic file at
    its CPU test size (``tests/tiny/<config>.py``)."""
    from portbench import harness
    from portbench.tests import cpu
    data = harness.Spec.load().data
    return harness.Spec(data, cpu.tiny_spec_dir(data, tmp_path / "spec"))
