"""The port's pose algebra (:mod:`gs360x_torch.core.pose`, host numpy f64)
against :mod:`gs360x.core.pose`: every public function on the same seeded
inputs, arrays equal to 1e-12, and the axis-convention constants equal."""

import numpy as np
import pytest

from gs360x.core import pose as jpose
from gs360x_torch.core import pose as tpose

RNG = np.random.default_rng(11)
ANGLES = [0.0, 30.0, -45.5, 90.0, 179.999, -180.0, 270.0, 541.25]
ROT = jpose.axis_angle_mat3(RNG.normal(size=3), 73.0)
C2W = jpose.mat4_from_rt(ROT, RNG.normal(size=3) * 4.0)

CASES = {
    "rot_x_deg": [(a,) for a in ANGLES],
    "rot_y_deg": [(a,) for a in ANGLES],
    "rot_z_deg": [(a,) for a in ANGLES],
    "axis_angle_mat3": [(RNG.normal(size=3), a) for a in ANGLES]
    + [((0.0, 0.0, 0.0), 40.0), ([0, 2, 0], -12.5)],
    "normalize_angle_deg": [(a,) for a in ANGLES + [180.0, -179.9999999,
                                                     360.0, -540.0]],
    "yaw_pitch_to_rot_gl": [(y, p) for y in ANGLES[:5] for p in (-35, 0, 90)],
    "view_rotation_cv": [(y, p, r) for y in ANGLES[:4] for p in (-90, 20)
                         for r in (0.0, 15.0)],
    "mat4_from_rt": [(ROT,), (ROT, (1.0, -2.0, 3.5))],
    "apply_x_fix_gl": [(C2W, d) for d in (0.0, 180.0, 270.0)],
    "colmap_pose_from_c2w_gl": [(C2W,), (C2W, 270.0)],
    "c2w_gl_from_colmap_pose": [(ROT, RNG.normal(size=3))],
    "apply_unit_scale": [(C2W, s) for s in (1.0, 0.01, 37.5)],
    "quat_wxyz_from_mat3": [(jpose.axis_angle_mat3(RNG.normal(size=3), a),)
                            for a in ANGLES]
    + [(np.diag([1.0, -1.0, -1.0]),), (np.diag([-1.0, 1.0, -1.0]),),
       (np.diag([-1.0, -1.0, 1.0]),), (np.zeros((3, 3)),)],
    "mat3_from_quat_wxyz": [tuple(RNG.normal(size=4)) for _ in range(4)]
    + [(0.0, 0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0)],
}


def assert_same(got, ref, what=""):
    """Nested tuples/lists of floats and arrays, equal to 1e-12."""
    if isinstance(ref, (tuple, list)):
        assert type(got) is type(ref) and len(got) == len(ref), what
        for g, r in zip(got, ref):
            assert_same(g, r, what)
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype, what
        assert got.shape == ref.shape, what
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12, err_msg=what)
    else:
        assert type(got) is type(ref), what
        assert got == pytest.approx(ref, rel=0, abs=1e-12), what


def test_every_public_function_has_a_case():
    public = sorted(name for name, obj in vars(jpose).items()
                    if callable(obj) and not name.startswith("_")
                    and getattr(obj, "__module__", "") == jpose.__name__)
    assert public == sorted(CASES)
    for name in public:
        assert callable(getattr(tpose, name)), name


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_jax_package(name):
    ref_fn, got_fn = getattr(jpose, name), getattr(tpose, name)
    for args in CASES[name]:
        assert_same(got_fn(*args), ref_fn(*args), f"{name}{args}")


def test_constants_match_jax_package():
    names = [n for n in vars(jpose) if n.isupper()]
    assert {"TRANSFORMS_X_FIX_DEG", "COLMAP_X_BASE_DEG",
            "POINTCLOUD_PLY_X_DEG", "REALITYSCAN_AXIS", "CV_TO_GL"} \
        <= set(names)
    for name in names:
        assert_same(getattr(tpose, name), getattr(jpose, name), name)


def test_pose_stays_float64():
    """f32 tensors would break the format round-trips: the port keeps the
    pose algebra in numpy f64 on the host."""
    for name in ("rot_x_deg", "rot_y_deg", "rot_z_deg"):
        assert getattr(tpose, name)(12.5).dtype == np.float64
    r_wc, t = tpose.colmap_pose_from_c2w_gl(C2W, 270.0)
    assert r_wc.dtype == t.dtype == np.float64
    back = tpose.c2w_gl_from_colmap_pose(*tpose.colmap_pose_from_c2w_gl(C2W))
    np.testing.assert_allclose(back, C2W, atol=1e-12)
