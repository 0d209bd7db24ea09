"""The input generator and the .cube synthesizer: the same seed gives the
same inputs, another seed others, and the same amount of work."""

import numpy as np
import pytest

from portbench import scenes
from portbench.reference import cube

PARAMS = {"octaves": 4, "shapes": 12, "grain_lsb": 2, "circle": 0.985}
SEED = 2 ** 35 + 11   # more than 32 bits, as the driver's seeds are


def test_scene_deterministic():
    a = scenes.scene(SEED, 0, 64, 128, PARAMS)
    b = scenes.scene(SEED, 0, 64, 128, PARAMS)
    assert a.dtype == np.uint8 and a.shape == (64, 128, 3)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, scenes.scene(SEED + 1, 0, 64, 128, PARAMS))
    assert not np.array_equal(a, scenes.scene(SEED, 1, 64, 128, PARAMS))


def test_scene_is_photo_like():
    """Edges and grain: neighbouring pixels differ, and not by noise
    alone."""
    img = scenes.scene(SEED, 0, 128, 256, PARAMS).astype(np.int16)
    step = np.abs(np.diff(img, axis=1))
    assert step.mean() > 0.5          # the grain
    assert (step > 40).mean() > 1e-3  # the shapes' edges
    assert img.std() > 20             # the field and the shapes


def test_lens_image_black_outside_circle():
    img = scenes.lens_image(SEED, 0, 96, PARAMS)
    assert img.shape == (96, 96, 3)
    assert img[0, 0].sum() == 0 and img[-1, -1].sum() == 0
    assert img[48, 48].sum() > 0


def test_make_inputs_and_links(tmp_path):
    traffic = {"distinct": 2, "scene": PARAMS}
    frames = scenes.make_inputs(SEED, (32, 64), traffic, tmp_path / "f")
    assert [p.name for p in frames] == ["d0.jpg", "d1.jpg"]
    again = scenes.make_inputs(SEED, (32, 64), traffic, tmp_path / "g")
    assert [p.read_bytes() for p in frames] == [p.read_bytes()
                                                for p in again]
    pairs = scenes.make_inputs(SEED, (48,), traffic, tmp_path / "p")
    assert [p.name for p in pairs] == ["p0_X.jpg", "p0_Y.jpg", "p1_X.jpg",
                                       "p1_Y.jpg"]
    links = scenes.link_names(frames, ["a.jpg", "b.jpg", "c.jpg"],
                              tmp_path / "l")
    assert [p.resolve() for p in links] == [frames[0].resolve(),
                                            frames[1].resolve(),
                                            frames[0].resolve()]
    assert all(p.is_symlink() for p in links)


@pytest.mark.parametrize("size", [2, 5, 33])
def test_cube_deterministic_monotone(size, tmp_path):
    table = scenes.cube_table(SEED, size)
    assert table.shape == (size, size, size, 3)
    assert np.array_equal(table, scenes.cube_table(SEED, size))
    assert not np.array_equal(table, scenes.cube_table(SEED + 1, size))
    assert table.min() >= 0 and table.max() <= 1
    # a grey ramp stays a monotone ramp, as a log decode does
    grey = np.array([table[i, i, i] for i in range(size)])
    assert (np.diff(grey, axis=0) >= -1e-12).all()
    path = tmp_path / "t.cube"
    scenes.write_cube(path, table)
    read, lo, hi = cube.read_cube(path)
    assert lo == [0, 0, 0] and hi == [1, 1, 1]
    assert np.abs(read.numpy() - table).max() <= 5e-7
