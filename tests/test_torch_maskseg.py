"""The port's MaskSeg (:mod:`gs360x_torch.tools.maskseg`, ``--device cpu``)
against the JAX package's (:mod:`gs360x.tools.maskseg`) on the CPU.

Both CLIs run on the same files: a 64×96 crop of a photo-style synthetic
scene (the size ``tests/test_maskseg.py`` uses) in all six ``--mode``s
(with the default refinement, ``--mask-expand-mode percent``, ``--target
animal``, no expansion or edge fusing), and a 672×656 one, whose short
side exceeds 640 so the resize in shrinks, in ``mask`` mode; each with a
manual ``view__<ID>__add.png`` layer. The same files are written: masks
and alphas equal (a failure lists the pixels whose JAX probability lies
within 1e-4 of ``--mask-thresh``, the only ones that could flip), RGB
within 1 LSB; and the same stdout. The refinement helpers equal the JAX
helpers; the error exits print the same lines with the same codes; the
port's own ``[ERR]`` lines (an Orbax ``--checkpoint``, the cached Orbax
default) and ``--checkpoint`` with single-file msgpack weights are
checked, and so are the port's default weights: ``--build-default`` trains
them (in a few steps here) into the port's cache and loads them, and a
cached port default loads, beside an Orbax default or not.
"""

import functools
import io
import pathlib
import shutil
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from gs360x.models import segmentation as jseg
from gs360x.models import synthseg as jsyn
from gs360x.tools import maskseg as jms
from gs360x_torch.models import synthseg as tsyn
from gs360x_torch.tools import maskseg as tms

torch.set_num_threads(1)

CPU = torch.device("cpu")
BAND = 1e-4                 # a pixel this close to --mask-thresh may flip
TARGET_CLASSES = ["person", "bird", "cat", "dog"]


@pytest.fixture(scope="module", autouse=True)
def traced_jax_template():
    """The JAX CLI restores its weights into a template from an eager Flax
    init (~20 s on the CPU) and overwrites every value with the file's; a
    template of zeros in the traced shapes restores the same params."""
    init = jseg.init_params

    def template(rng, input_size=256, features=None):
        shapes = jax.eval_shape(lambda key: init(key, input_size, features),
                                rng)
        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jseg, "init_params", template)
        yield


def _scene(rng, size, rows, cols) -> np.ndarray:
    img, _ = tsyn.generate_scene(rng, size=size, photo_style=True)
    return (img[rows, cols] * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(root, {"small": dir, "big": dir}, manual layers' dir)."""
    root = tmp_path_factory.mktemp("maskseg")
    dirs = {"small": root / "small", "big": root / "big"}
    manual = root / "manual"
    for d in (*dirs.values(), manual):
        d.mkdir()
    rng = np.random.default_rng(5)
    small = _scene(rng, 96, slice(16, 80), slice(None))           # 64×96
    big = _scene(rng, 672, slice(None), slice(8, 664))            # 672×656
    Image.fromarray(small).save(dirs["small"] / "view_0000_A.png")
    Image.fromarray(big).save(dirs["big"] / "view_0001_B.png")
    for vid, (h, w), box in (("A", small.shape[:2], (40, 52, 4, 20)),
                             ("B", big.shape[:2], (600, 672, 0, 90))):
        layer = np.zeros((h, w), np.uint8)
        y0, y1, x0, x1 = box
        layer[y0:y1, x0:x1] = 255
        Image.fromarray(layer).save(manual / f"view__{vid}__add.png")
    return root, dirs, manual


@pytest.fixture(scope="module")
def band_pixels(inputs):
    """Pixels whose JAX probability of a target class lies within BAND of
    the default --mask-thresh, by file: the only ones that may differ."""
    predictor = jseg.SegmentationPredictor(serialization.msgpack_restore(
        jsyn.packaged_weights_path().read_bytes()))
    out = {}
    for d in inputs[1].values():
        for path in d.iterdir():
            rgb01 = np.asarray(Image.open(path)).astype(np.float32) / 255.0
            probs = predictor.class_probabilities(rgb01)
            near = np.zeros(rgb01.shape[:2], bool)
            for name in TARGET_CLASSES:
                p = probs[..., jseg.CLASS_TO_INDEX[name]]
                near |= np.abs(p - jseg.MASK_THRESH) < BAND
            out[path.stem] = np.argwhere(near)
    return out


def _run(module, args, out: pathlib.Path, dest: pathlib.Path):
    """Run one CLI into ``out``, move what it wrote to ``dest``; (rc,
    stdout)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = module.main(args + ["-o", str(out)])
    shutil.move(str(out), str(dest))
    return rc, buf.getvalue()


# (mode, input, extra flags): every mode on the small view, and the mask
# on the large one, where the resize in shrinks
CASES = {
    "mask": ("mask", "small", []),
    "alpha": ("alpha", "small", []),
    "cutout": ("cutout", "small", ["--mask-expand-mode", "percent"]),
    "keep_person": ("keep_person", "small", ["--mask-expand-pixels", "0",
                                             "--edge-fuse-pixels", "0"]),
    "remove_person": ("remove_person", "small", ["--target", "animal"]),
    "inpaint": ("inpaint", "small", []),
    "mask_shrink": ("mask", "big", []),
}


@pytest.mark.parametrize("case", list(CASES))
def test_modes_match_jax(inputs, band_pixels, case):
    mode, which, extra = CASES[case]
    root, dirs, manual = inputs
    args = ["-i", str(dirs[which]), "--mode", mode, "--manual-mask-dir",
            str(manual), *extra]
    out = root / "out"
    ref_dir, got_dir = root / f"jax_{case}", root / f"torch_{case}"
    ref_rc, ref_stdout = _run(jms, args, out, ref_dir)
    got_rc, got_stdout = _run(tms, args + ["--device", "cpu"], out, got_dir)
    assert got_rc == ref_rc == 0
    assert got_stdout == ref_stdout
    names = sorted(p.name for p in ref_dir.iterdir())
    assert sorted(p.name for p in got_dir.iterdir()) == names
    assert len(names) == 1
    for name in names:
        ref = np.asarray(Image.open(ref_dir / name)).astype(int)
        got = np.asarray(Image.open(got_dir / name)).astype(int)
        assert got.shape == ref.shape
        band = next(v for k, v in band_pixels.items()
                    if name.startswith(k))
        lsb = 1 if mode == "inpaint" else 0
        assert int(np.abs(got - ref).max()) <= lsb, (
            f"{name}: pixels in the ±{BAND} band of --mask-thresh: "
            f"{band.tolist()}")
        if mode in ("mask", "alpha"):         # subject (or layer) black
            assert (ref[..., -1] if ref.ndim == 3 else ref).min() == 0
        if mode == "cutout":                  # subject (or layer) opaque
            assert ref[..., -1].max() == 255


def test_error_exits_match_jax(tmp_path, capsys):
    (tmp_path / "empty").mkdir()
    (tmp_path / "imgs").mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
        tmp_path / "imgs" / "x.png")
    cases = [
        (["-i", str(tmp_path / "none")], 1),
        (["-i", str(tmp_path / "imgs"), "--mask-expand-pixels", "-1"], 1),
        (["-i", str(tmp_path / "imgs"), "--edge-fuse-pixels", "-3"], 1),
        (["-i", str(tmp_path / "imgs"), "--target-name", "spaceship"], 1),
        (["-i", str(tmp_path / "empty")], 0),
    ]
    for args, want in cases:
        assert jms.main(args) == want
        ref = capsys.readouterr()
        assert tms.main(args + ["--device", "cpu"]) == want
        got = capsys.readouterr()
        assert (got.out, got.err) == (ref.out, ref.err), args
        assert ref.err.startswith("[ERR]" if want else "[WARN]")


@pytest.fixture
def one_image(tmp_path):
    d = tmp_path / "in"
    d.mkdir()
    img = _scene(np.random.default_rng(2), 64, slice(None), slice(None))
    Image.fromarray(img).save(d / "frame_0001_A.png")
    return d


def test_checkpoint_file_is_read_like_the_shipped_weights(
        one_image, tmp_path, capsys):
    ckpt = tmp_path / "weights.msgpack"
    jseg.save_weights(ckpt, serialization.msgpack_restore(
        jsyn.packaged_weights_path().read_bytes()))
    base = ["-i", str(one_image), "--device", "cpu"]
    assert tms.main(base + ["-o", str(tmp_path / "a")]) == 0
    assert tms.main(base + ["-o", str(tmp_path / "b"), "--checkpoint",
                            str(ckpt)]) == 0
    assert f"[INFO] loaded checkpoint: {ckpt}" in capsys.readouterr().out
    assert (tmp_path / "a" / "frame_0001_A.png").read_bytes() == \
        (tmp_path / "b" / "frame_0001_A.png").read_bytes()

    bad = tmp_path / "bad.msgpack"
    bad.write_bytes(b"\xc0")
    assert tms.main(base + ["--checkpoint", str(bad)]) == 1
    assert capsys.readouterr().err.startswith(
        "[ERR] failed to load checkpoint: msgpack: type 0xc0")


def test_orbax_checkpoint_directory_is_refused(one_image, tmp_path, capsys):
    orbax = tmp_path / "ckpt"
    orbax.mkdir()
    assert tms.main(["-i", str(one_image), "--device", "cpu",
                     "--checkpoint", str(orbax)]) == 1
    err = capsys.readouterr().err
    assert err.startswith(f"[ERR] failed to load checkpoint: {orbax} is a "
                          "directory; Orbax checkpoints are not readable by "
                          "the port")
    assert not (one_image / "masks").exists()


@pytest.fixture
def no_shipped_weights(tmp_path, monkeypatch):
    """Both packages without shipped weights, and a HOME of their own (the
    cached default lives under it)."""
    missing = tmp_path / "missing.msgpack"
    monkeypatch.setattr(tsyn, "packaged_weights_path", lambda: missing)
    monkeypatch.setattr(jsyn, "packaged_weights_path", lambda: missing)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    return tmp_path / "home"


def test_cached_orbax_default_is_refused(one_image, no_shipped_weights,
                                         capsys):
    default = tsyn.default_checkpoint_path()
    assert str(default).startswith(str(no_shipped_weights))
    default.mkdir(parents=True)
    for extra in ([], ["--allow-random"]):
        assert tms.main(["-i", str(one_image), "--device", "cpu",
                         *extra]) == 1
        assert capsys.readouterr().err == (
            f"[ERR] failed to load default checkpoint: {default} is an "
            "Orbax checkpoint; Orbax checkpoints are not readable by the "
            "port\n")


# the port's default weights trained in 2 steps of batch 2 at 32²
FEW = dict(steps=2, n_scenes=4, size=32, batch=2, verbose=False)


@pytest.mark.parametrize("case", ["build", "build beside orbax", "cached",
                                  "cached beside orbax"])
def test_port_default_weights(case, one_image, no_shipped_weights, tmp_path,
                              monkeypatch, capsys):
    """--build-default trains the port's default into its cache and loads
    it; a cached port default loads with or without the flag; the JAX
    package's Orbax default beside it is not read."""
    monkeypatch.setattr(tsyn, "build_default_checkpoint", functools.partial(
        tsyn.build_default_checkpoint, **FEW))
    default = tsyn.default_weights_path()
    assert default == (no_shipped_weights / ".cache" / "gs360x"
                       / "seg_default_v3_torch.msgpack")
    if "orbax" in case:
        tsyn.default_checkpoint_path().mkdir(parents=True)
    if case.startswith("cached"):
        tsyn.build_default_checkpoint(default, device=CPU)
    before = default.read_bytes() if default.exists() else None
    out = tmp_path / "out"
    rc = tms.main(["-i", str(one_image), "--device", "cpu", "-o", str(out),
                   "--build-default"])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    built = ["[INFO] building default checkpoint (one-time, trains the "
             "U-Net on a generated corpus)..."] if before is None else []
    assert lines[:len(built) + 2] == built + [
        f"[INFO] loaded default checkpoint: {default}",
        "[INFO] (synthetic-corpus weights; fine-tune with "
        "gs360x-torch-segtrain for photographic masks)"]
    if before is not None:
        assert default.read_bytes() == before
        return
    # the masks are those of a predictor with the weights just built
    ref_dir = tmp_path / "ref"
    assert tms.main(["-i", str(one_image), "--device", "cpu", "-o",
                     str(ref_dir), "--checkpoint", str(default)]) == 0
    assert (out / "frame_0001_A.png").read_bytes() == \
        (ref_dir / "frame_0001_A.png").read_bytes()


def test_without_weights_the_messages_match_jax(one_image,
                                                no_shipped_weights, capsys):
    args = ["-i", str(one_image)]
    assert jms.main(args) == 1
    ref = capsys.readouterr().err
    assert tms.main(args + ["--device", "cpu"]) == 1
    assert capsys.readouterr().err == ref
    assert ref.startswith("[ERR] no segmentation weights")


def test_allow_random_runs_the_default_width(one_image, no_shipped_weights,
                                             tmp_path, capsys):
    out = tmp_path / "rand"
    assert tms.main(["-i", str(one_image), "--device", "cpu", "-o",
                     str(out), "--allow-random", "--score-thresh",
                     "1.1"]) == 0
    assert capsys.readouterr().err.startswith("[WARN] --allow-random")
    mask = np.asarray(Image.open(out / "frame_0001_A.png"))
    assert mask.shape == (64, 64) and (mask == 255).all()


def test_cuda_device_without_a_card_raises(one_image):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cuda"):
        tms.main(["-i", str(one_image)])


# --- the refinement helpers -------------------------------------------------

def _blobs(shape=(60, 90), seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, np.uint8)
    m[20:35, 40:55] = 255
    m[-8:, 10:20] = 255
    m[rng.random(shape) < 0.01] = 255
    return m


def test_refine_and_expand_match_jax():
    m = _blobs()
    np.testing.assert_array_equal(tms.refine_mask(m, device=CPU),
                                  jms.refine_mask(m))
    np.testing.assert_array_equal(tms.refine_mask(m, 1, device=CPU),
                                  jms.refine_mask(m, 1))
    for mode, pixels, percent in (("pixels", 5, 0), ("percent", 0, 3.0),
                                  ("pixels", 0, 0)):
        np.testing.assert_array_equal(
            tms.expand_mask(m, mode, pixels, percent, device=CPU),
            jms.expand_mask(m, mode, pixels, percent))
    for f in (0, 6, 25):
        np.testing.assert_array_equal(tms.fuse_mask_to_edges(m, f),
                                      jms.fuse_mask_to_edges(m, f))


def test_shadow_mask_matches_jax():
    rng = np.random.default_rng(3)
    rgb01 = rng.random((60, 90, 3), dtype=np.float32)
    rgb01[30:50, 30:70] *= 0.4                      # a dark, grey patch
    rgb01[30:50, 30:70] = rgb01[30:50, 30:70].mean(-1, keepdims=True)
    m = _blobs()
    got = tms.estimate_shadow_mask(rgb01, m, device=CPU)
    ref = jms.estimate_shadow_mask(rgb01, m)
    assert ref.any()
    np.testing.assert_array_equal(got, ref)
    empty = np.zeros_like(m)
    np.testing.assert_array_equal(
        tms.estimate_shadow_mask(rgb01, empty, device=CPU), empty)


def test_manual_layers_and_targets_match_jax(tmp_path):
    for stem in ("video_0000012_A_U", "plain", "x_12", "x_B_D3", "a_b"):
        path = pathlib.Path(f"{stem}.jpg")
        assert tms.manual_mask_key_for_path(path) == \
            jms.manual_mask_key_for_path(path)
    layer = np.zeros((30, 40), np.uint8)
    layer[5:9, 3:30] = 200
    Image.fromarray(layer).save(tmp_path / "view__A__add.png")
    for shape in ((30, 40), (45, 20)):
        got = tms.load_manual_add_layer(pathlib.Path("f_A.png"), tmp_path,
                                        shape)
        np.testing.assert_array_equal(got, jms.load_manual_add_layer(
            pathlib.Path("f_A.png"), tmp_path, shape))
    assert tms.load_manual_add_layer(pathlib.Path("f_B.png"), tmp_path,
                                     (30, 40)) is None

    class Args:
        target = None
        target_name = None
    for target, name in (("animal", None), (None, "Motorbike"),
                         (None, "dog"), (None, None)):
        Args.target, Args.target_name = target, name
        assert tms.resolve_targets(Args) == jms.resolve_targets(Args)
