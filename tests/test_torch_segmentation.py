"""The port's segmentation model (:mod:`gs360x_torch.models`) against the
JAX package's (:mod:`gs360x.models`) on the CPU.

- The weights: the port's copy of ``seg_unet_64_v10.msgpack`` is
  byte-equal to the JAX package's, and its msgpack reader returns every
  leaf bitwise equal to ``flax.serialization.msgpack_restore`` (also for
  Flax weights of the default width, whose larger leaves take the wider
  msgpack types); it refuses every other msgpack type.
- The U-Net: with the shipped weights, logits within 1e-3 of Flax on 16
  held-out 64² scenes with the argmax equal on every pixel, within 2e-3 at
  576×1024; the default width (32, 64, 128, 256), carried across from a
  Flax ``init_params`` tree by ``params_from_flax``, within 1e-3 at 64².
- The predictor: ``class_probabilities`` within 2e-4 of the JAX
  predictor's for a shrinking, a growing and a mixed-axis input (the
  per-axis anti-aliasing of ``jax.image.resize``); ``detect`` and
  ``combined_mask`` equal.
- Capability: the port's model with the port's copy of the weights passes
  the four gates of ``tests/test_synthseg.py``.
- The copies: ``models/instances`` is the JAX module's code byte for byte,
  the corpus generators give the same scenes for the same seed.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from gs360x.models import instances as jinst
from gs360x.models import segmentation as jseg
from gs360x.models import synthseg as jsyn
from gs360x_torch.models import instances as tinst
from gs360x_torch.models import segmentation as tseg
from gs360x_torch.models import synthseg as tsyn
from gs360x_torch.models import weights as tw

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
HELDOUT_TOL = 1e-3
INFERENCE_SIZE_TOL = 2e-3
PROB_TOL = 2e-4


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


def _assert_trees_bitwise(got, ref):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert got.keys() == ref.keys()
    for key, value in ref.items():
        assert got[key].dtype == value.dtype, key
        assert got[key].shape == value.shape, key
        assert got[key].tobytes() == value.tobytes(), key


def _nchw(images: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(images)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def shipped():
    """(Flax params, the port's state_dict, the port's predictor) of the
    shipped weights, each package reading its own copy (the Flax tree as
    ``serialization.from_bytes`` restores it, without the eager init of a
    template)."""
    params = serialization.msgpack_restore(
        jsyn.packaged_weights_path().read_bytes())
    state = tsyn.load_packaged_weights()
    return params, state, tseg.SegmentationPredictor(state, device=CPU)


@pytest.fixture(scope="module")
def default_width():
    """A Flax params tree of the default width (32, 64, 128, 256): the
    structure and shapes of ``init_params`` (traced, not run), seeded
    values scaled by each kernel's fan-in."""
    shapes = jax.eval_shape(lambda key: jseg.init_params(key, 16),
                            jax.random.key(5))
    rng = np.random.default_rng(5)
    return jax.tree.map(
        lambda s: (rng.standard_normal(s.shape)
                   / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32),
        shapes)


@pytest.fixture(scope="module")
def jax_predictor(shipped):
    return jseg.SegmentationPredictor(shipped[0])


def _flax_logits(params, features, images) -> np.ndarray:
    return np.asarray(jax.jit(jseg.create_model(features).apply)(
        {"params": params}, jnp.asarray(images)))


def _port_logits(predictor, images) -> np.ndarray:
    return predictor.logits(_nchw(images)).permute(0, 2, 3, 1).numpy()


# --- weights ---------------------------------------------------------------

def test_port_weights_are_a_byte_equal_copy():
    assert tsyn.packaged_weights_path() == (
        ROOT / "gs360x_torch/models/weights/seg_unet_64_v10.msgpack")
    assert tsyn.packaged_weights_path().read_bytes() == \
        jsyn.packaged_weights_path().read_bytes()


def test_reader_matches_flax_msgpack_restore():
    raw = tsyn.packaged_weights_path().read_bytes()
    got = tw.read_msgpack(raw)
    assert len(dict(_leaves(got))) == 46
    _assert_trees_bitwise(got, serialization.msgpack_restore(raw))


def test_reader_reads_default_width_weights_written_by_flax(default_width):
    raw = serialization.to_bytes(default_width)
    _assert_trees_bitwise(tw.read_msgpack(raw),
                          serialization.msgpack_restore(raw))


# a leaf of the right form: ext 8, type 1, [[2], "float32", bin8 of 8 bytes]
PAYLOAD = bytes([0x93, 0x91, 2, 0xA7]) + b"float32" + bytes([0xC4, 8]) \
    + bytes(8)
LEAF = bytes([0xC7, len(PAYLOAD), 1]) + PAYLOAD


@pytest.mark.parametrize("data,match", [
    (bytes([0x81, 0xA1]) + b"a" + LEAF + b"\x00", "trailing"),
    (bytes([0x81, 0xA1]) + b"a" + LEAF[:-3], "truncated"),
    (bytes([0x81, 0xA1]) + b"a" + bytes([0xC0]), "type 0xc0"),
    (bytes([0x81, 0xA1]) + b"a" + bytes([0xCA]) + bytes(4), "type 0xca"),
    (bytes([0x81, 0xA1]) + b"a" + bytes([0xFF]), "type 0xff"),
    (bytes([0x81, 0x01]) + LEAF, "not a str"),
    (bytes([0x81, 0xA1]) + b"a" + LEAF[:2] + bytes([2]) + LEAF[3:],
     "ext type 2"),
    (bytes([0x81, 0xA1]) + b"a" + bytes([0xC7, 3, 1, 0x92, 1, 2]),
     "triple"),
    (bytes([0x91, 0x01]), "not a map"),
], ids=["trailing", "truncated", "nil", "float", "negative", "int_key",
        "ext2", "not_triple", "array_root"])
def test_reader_refuses_what_is_not_the_weights_format(data, match):
    with pytest.raises(ValueError, match=match):
        tw.read_msgpack(data)


def test_reader_reads_the_leaf_form():
    tree = tw.read_msgpack(bytes([0x81, 0xA1]) + b"a" + LEAF)
    assert tree["a"].dtype == np.float32 and tree["a"].shape == (2,)


def test_params_from_flax_layout(shipped):
    params, state, _ = shipped
    assert set(state) == set(tseg.create_model((16, 32, 64)).state_dict())
    kernel = np.asarray(params["ConvBlock_1"]["Conv_0"]["kernel"])
    np.testing.assert_array_equal(
        state["ConvBlock_1.Conv_0.weight"].numpy(),
        kernel.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        state["ConvBlock_4.GroupNorm_1.weight"].numpy(),
        np.asarray(params["ConvBlock_4"]["GroupNorm_1"]["scale"]))
    assert tseg.features_from_params(state) == \
        jseg.features_from_params(params) == (16, 32, 64)


def test_load_weights_refuses_what_is_not_a_unet(tmp_path):
    path = tmp_path / "other.msgpack"
    path.write_bytes(serialization.to_bytes(
        {"Dense_0": {"bias": np.zeros(3, np.float32)}}))
    with pytest.raises(ValueError, match="not the weights"):
        tseg.load_weights(path)


def test_init_params_draws_from_the_generator():
    a = tseg.init_params(torch.Generator().manual_seed(4), (8, 16))
    b = tseg.init_params(torch.Generator().manual_seed(4), (8, 16))
    assert tseg.features_from_params(a) == (8, 16)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    w = a["ConvBlock_0.Conv_1.weight"]
    assert float(w.abs().max()) <= 2.0 * (1.0 / 72) ** 0.5 / .87962566 + 1e-6
    assert torch.equal(a["ConvBlock_0.GroupNorm_0.weight"], torch.ones(8))


# --- the U-Net --------------------------------------------------------------

def test_unet_matches_flax_on_heldout_scenes(shipped):
    params, _, predictor = shipped
    images, _ = jsyn.generate_corpus(16, size=64, seed=99)
    ref = _flax_logits(params, (16, 32, 64), images)
    got = _port_logits(predictor, images)
    assert float(np.abs(got - ref).max()) <= HELDOUT_TOL
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_unet_matches_flax_at_the_inference_size(shipped):
    params, _, predictor = shipped
    images = np.random.default_rng(0).random((1, 576, 1024, 3),
                                             dtype=np.float32)
    ref = _flax_logits(params, (16, 32, 64), images)
    got = _port_logits(predictor, images)
    assert float(np.abs(got - ref).max()) <= INFERENCE_SIZE_TOL


def test_default_width_carried_across_matches_flax(default_width):
    params = default_width
    state = tw.params_from_flax(params)
    assert tseg.features_from_params(state) == tseg.DEFAULT_FEATURES
    predictor = tseg.SegmentationPredictor(state, device=CPU)
    images, _ = jsyn.generate_corpus(2, size=64, seed=6)
    ref = _flax_logits(params, None, images)
    got = _port_logits(predictor, images)
    assert float(np.abs(got - ref).max()) <= HELDOUT_TOL


# --- the predictor ----------------------------------------------------------

# each runs the U-Net at 640×1024 (one compile on the JAX side); "mixed"
# grows its rows (636 → 640) and shrinks its columns (1030 → 1024)
@pytest.mark.parametrize("shape", [(700, 1120), (64, 102), (636, 1030)],
                         ids=["shrink", "grow", "mixed"])
def test_class_probabilities_match_jax(shipped, jax_predictor, shape):
    assert tseg.inference_size(*shape) == (640, 1024)
    rgb01 = np.random.default_rng(sum(shape)).random((*shape, 3),
                                                     dtype=np.float32)
    ref = jax_predictor.class_probabilities(rgb01)
    got = shipped[2].class_probabilities(rgb01)
    assert got.shape == ref.shape == (*shape, tseg.NUM_CLASSES)
    assert float(np.abs(got - ref).max()) <= PROB_TOL


def test_resize_linear_follows_jax_per_axis():
    x = np.random.default_rng(2).random((37, 53, 2), dtype=np.float32)
    for size in [(20, 30), (90, 120), (20, 120), (90, 30), (37, 20),
                 (37, 53)]:
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (*size, 2),
                                          "linear"))
        got = tseg.resize_linear(torch.from_numpy(x).permute(2, 0, 1)[None],
                                 size)[0].permute(1, 2, 0).numpy()
        assert float(np.abs(got - ref).max()) <= 1e-5, size


def test_detect_and_combined_mask_match_jax(shipped, jax_predictor):
    rng = np.random.default_rng(12)
    found = 0
    for _ in range(2):
        img, _ = tsyn.generate_scene(rng, size=102, photo_style=True)
        img = np.ascontiguousarray(img[19:83])         # 64×102 → 640×1024
        targets = ["bird", "cat", "dog", "person"]
        ref = jax_predictor.detect(img, targets, score_thresh=0.5)
        got = shipped[2].detect(img, targets, score_thresh=0.5)
        assert [d["class_name"] for d in got] == \
            [d["class_name"] for d in ref]
        for g, r in zip(got, ref):
            assert g["score"] == pytest.approx(r["score"], abs=1e-4)
            np.testing.assert_array_equal(g["mask"], r["mask"])
        found += len(got)
        ref_mask = jax_predictor.combined_mask(img, ["person"])
        got_mask = shipped[2].combined_mask(img, ["person"])
        assert (got_mask is None) == (ref_mask is None)
        if ref_mask is not None:
            np.testing.assert_array_equal(got_mask, ref_mask)
    assert found > 0
    assert shipped[2].detect(img, ["spaceship"]) == []


@pytest.mark.parametrize("shape", [(1080, 1920), (1600, 1600), (3840, 7680),
                                   (64, 96), (700, 900), (5, 3000)])
def test_inference_size_matches_jax(shape):
    assert tseg.inference_size(*shape) == jseg.inference_size(*shape)


def test_f32_convs_leaves_the_flags_as_they_were():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled
    with tseg.f32_convs():
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.enabled is False
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.enabled) == before


# --- capability: the four gates of tests/test_synthseg.py -------------------

def _subject_iou(pred, labels) -> float:
    inter = float(((pred > 0) & (labels > 0)).sum())
    union = float(((pred > 0) | (labels > 0)).sum())
    return inter / max(union, 1.0)


def _scenes(generator, seed, **kw):
    rng = np.random.default_rng(seed)
    pairs = [generator(rng, size=64, **kw) for _ in range(16)]
    return (np.stack([p[0] for p in pairs]),
            np.stack([p[1] for p in pairs]))


@pytest.mark.parametrize("name,gate", [("heldout", 0.78), ("photo", 0.70),
                                       ("transfer", 0.68)])
def test_capability_iou(shipped, name, gate):
    if name == "heldout":
        images, labels = tsyn.generate_corpus(16, size=64, seed=99)
    elif name == "photo":
        images, labels = _scenes(tsyn.generate_scene, 4242, photo_style=True)
    else:
        images, labels = _scenes(tsyn.generate_transfer_scene, 777)
    pred = _port_logits(shipped[2], images).argmax(-1)
    iou = _subject_iou(pred, labels)
    assert iou >= gate, f"{name} IoU {iou:.3f} below {gate}"


def test_capability_instance_ap(shipped):
    person = tseg.CLASS_TO_INDEX["person"]
    rng = np.random.default_rng(888)
    dets_all, n_gt = [], 0
    for _ in range(12):
        im, _, inst = tsyn.generate_instance_scene(rng, size=64,
                                                   n_people=(2, 3))
        lg = shipped[2].logits(_nchw(im[None]))
        prob = torch.softmax(lg, dim=1)[0, person].numpy()
        pred = lg.argmax(1)[0].numpy()
        dets = tinst.instance_masks(pred == person, prob, score_thresh=0.3,
                                    max_count=10)
        gts = [inst == k for k in range(1, inst.max() + 1)
               if (inst == k).sum() >= 16]
        for d in dets:
            d["gts"] = gts
        dets_all.extend(dets)
        n_gt += len(gts)
    ap = tinst.average_precision(dets_all, n_gt, iou_thresh=0.5)
    assert n_gt >= 20
    assert ap >= 0.65, f"instance AP@0.5 {ap:.3f} below 0.65 gate"


# --- the copies -------------------------------------------------------------

def _after_docstring(path: pathlib.Path) -> str:
    return path.read_text().split('"""', 2)[2]


def test_instances_is_the_jax_module_copied():
    assert _after_docstring(pathlib.Path(tinst.__file__)) == \
        _after_docstring(pathlib.Path(jinst.__file__))


SCENES = {
    "scene_flat": lambda m, rng: m.generate_scene(rng, size=48),
    "scene_photo": lambda m, rng: m.generate_scene(rng, size=48,
                                                   photo_style=True),
    "transfer": lambda m, rng: m.generate_transfer_scene(rng, size=48),
    "instance": lambda m, rng: m.generate_instance_scene(rng, size=48),
    "instance_flat": lambda m, rng: m.generate_instance_scene(
        rng, size=48, photo_style=False),
    "corpus": lambda m, rng: m.generate_corpus(3, size=32, seed=int(
        rng.integers(1000))),
    "augment": lambda m, rng: (m.augment_batch(
        rng, rng.random((3, 32, 32, 3), dtype=np.float32)),),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_generators_match_jax(name):
    for seed in range(4):
        ref = SCENES[name](jsyn, np.random.default_rng(seed))
        got = SCENES[name](tsyn, np.random.default_rng(seed))
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


def test_synthseg_constants_match_jax():
    assert tsyn.CLASS_TO_INDEX == jseg.CLASS_TO_INDEX == tseg.CLASS_TO_INDEX
    assert tseg.CLASS_NAMES == jseg.CLASS_NAMES
    assert tseg.TARGET_TO_CLASSES == jseg.TARGET_TO_CLASSES
    for name in ("SCORE_THRESH", "MASK_THRESH", "DETECTIONS_PER_IMG",
                 "MIN_SIZE", "MAX_SIZE"):
        assert getattr(tseg, name) == getattr(jseg, name)
    for name in ("PACKAGED_WEIGHTS_NAME", "PACKAGED_WEIGHTS_FEATURES",
                 "DEFAULT_CHECKPOINT_VERSION"):
        assert getattr(tsyn, name) == getattr(jsyn, name)
    assert tsyn.default_checkpoint_path() == jsyn.default_checkpoint_path()
