"""The port's view-plan builder against the JAX package's: the same
ViewSpecs, output names, plan fields and info lines for every preset and
for addcam/delcam/setcam/add-top specs."""

import dataclasses
import pathlib

import pytest

from gs360x.rig import presets as jax_presets
from gs360x_torch.rig import presets as torch_presets

FILES = [pathlib.Path("/data/pano_0001.jpg"), pathlib.Path("/data/pano_0002.jpg")]
OUT = pathlib.Path("/data/_geometry")

SPECS = [
    dict(addcam="B"),
    dict(addcam="B:U,D:D20,F=U15", addcam_explicit=True),
    dict(delcam="B,D", delcam_explicit=True, count=6),
    dict(setcam="A=30,B:+10,C=D,A_U=5", addcam="A"),
    dict(add_top=True, add_bottom=True, size=512, size_explicit=True),
    dict(hfov=90.0, hfov_explicit=True, sensor_mm="36x24"),
    dict(input_is_video=True, fps=2.0, count=4, ext="png"),
    dict(preset="fisheyeXY", hfov=200.0, hfov_explicit=True),
]


def _plans(**kw):
    ref = jax_presets.build_view_plan(jax_presets.PerspCutConfig(**kw),
                                      FILES, OUT)
    got = torch_presets.build_view_plan(torch_presets.PerspCutConfig(**kw),
                                        FILES, OUT)
    return dataclasses.asdict(ref), dataclasses.asdict(got)


def test_preset_choices_match():
    assert torch_presets.PRESET_CHOICES == jax_presets.PRESET_CHOICES


@pytest.mark.parametrize("preset", jax_presets.PRESET_CHOICES)
def test_every_preset_builds_the_same_plan(preset):
    ref, got = _plans(preset=preset)
    assert got["jobs"], preset
    assert got == ref


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: ",".join(sorted(s)))
def test_grammar_specs_build_the_same_plan(spec):
    ref, got = _plans(**spec)
    assert got == ref


def test_grammar_errors_match():
    for bad in ("B:X", "?"):
        with pytest.raises(ValueError):
            jax_presets.parse_addcam_spec(bad, 30.0)
        with pytest.raises(ValueError):
            torch_presets.parse_addcam_spec(bad, 30.0)
