"""The benchmark's CPU tests import ``portbench`` from the checkout's root
(``python -m pytest portbench/tests``); nothing here imports JAX."""

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_spec_dir(base: pathlib.Path) -> pathlib.Path:
    """The cells' configurations and traffic at a size the CPU runs in a
    second: an 256x128 frame and 48 px views; 192 px lenses under a
    calibration scaled with them, which the harness hands the tool as
    ``--camera-xml``, and 40 px views; 2 distinct inputs."""
    from portbench import harness

    (base / "configs").mkdir(parents=True, exist_ok=True)
    (base / "workloads").mkdir(exist_ok=True)
    pc = harness.load_json(harness.HERE / "configs/perspcut-8k-default.json")
    pc["frame"].update(width=256, height=128)
    pc["views"]["size"] = 48
    pc["args"] = ["--preset", "default", "--size", "48", "--ext", "jpg",
                  "-j", "2"]
    (base / "configs/perspcut-8k-default.json").write_text(json.dumps(pc))
    dc = harness.load_json(
        harness.HERE / "configs/dualfisheye-osmo360-sfm10.json")
    s = 192 / dc["calibration"]["width"]
    cal = dc["calibration"]
    cal.update(width=192, height=192, f=cal["f"] * s, cx=cal["cx"] * s,
               cy=cal["cy"] * s)
    dc["program_calibration"] = "xml"
    dc["views"]["size"] = 40
    dc["args"] = ["--interpolation", "cubic", "--perspective-size", "40",
                  "--perspective-focal-mm", "14", "--workers", "1"]
    (base / "configs/dualfisheye-osmo360-sfm10.json").write_text(
        json.dumps(dc))
    for w in (harness.HERE / "workloads").glob("*.json"):
        t = harness.load_json(w)
        t.update(distinct=2, check_sample=8)
        if "frames_per_s_sizing" in t:
            t.update(warmup_frames=1, frames_per_s_sizing=4.0)
        else:
            t.update(warmup_pairs=2, pairs_per_s_sizing=3.0)
        (base / "workloads" / w.name).write_text(json.dumps(t))
    return base



@pytest.fixture
def tiny_spec(tmp_path):
    from portbench import harness
    return harness.Spec(harness.Spec.load().data,
                        tiny_spec_dir(tmp_path / "spec"))
