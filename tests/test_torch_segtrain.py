"""The port's training path (:mod:`gs360x_torch.models.segmentation`,
:mod:`gs360x_torch.models.weights`, ``build_default_checkpoint`` and
:mod:`gs360x_torch.tools.segtrain`) against the JAX package's on the CPU.

- The msgpack writer: the shipped weights, read and written back, are the
  shipped file byte for byte and ``flax.serialization.to_bytes`` of the
  same tree; so are the weights of the default width. ``params_to_flax``
  inverts ``params_from_flax`` bitwise.
- ``train_step`` from the same parameters (carried with
  ``params_from_flax``) on the same batches, at features (8, 16), 32²,
  batch 2, and over a data mesh of three CPU devices at batch 6 (shards
  of unequal foreground) against the JAX step on a batch sharded over
  three JAX CPU devices and against the port on one device, for
  ``fg_weight`` 1 and 4: the loss within ``LOSS_RTOL``, the
  gradients of step 1 within ``GRAD_TOL`` of the largest gradient, and
  after 3 steps the parameters within ``PARAM_TOL`` on every entry whose
  step-1 gradient is above ``GRAD_FLOOR`` of the largest (Adam's first
  step is about lr·sign(g), so an entry whose gradient is rounding noise —
  the bias of a conv before a GroupNorm of one channel a group — moves by
  ±lr in either package; those entries are counted).
- The rate of every step 0 .. ``decay_steps`` + 2 against the optax
  schedule, and the rate ``train_step`` sets.
- A one-device mesh is bitwise the step without a mesh.
- A tied, positive 2×2 max-pool window routes its gradient to the same
  element in both libraries.
- The CLI: the host helpers equal the JAX ones; from the same initial
  weights the same messages (the ``devices`` field aside on
  ``--device cpu``'s one device; ``devices 8`` for both with the port's
  mesh made of 8 CPU devices, the batch rounded to it), the losses and
  validation accuracies within ``CLI_LOSS_TOL`` / ``CLI_ACC_TOL``, and
  final logits within ``LOGIT_TOL``; the
  error exits; ``--resume`` with a msgpack file and with an Orbax
  directory; ``--make-default`` (few steps) writes weights that the JAX
  package's ``load_weights`` reads, from the same batches as JAX's
  ``build_default_checkpoint``.
"""

import functools
import io
import pathlib
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn
from flax import serialization
from flax.training import train_state
from jax.sharding import NamedSharding, PartitionSpec

from gs360x.models import segmentation as jseg
from gs360x.runtime import mesh as jmesh
from gs360x.models import synthseg as jsyn
from gs360x.tools import segtrain as jst
from gs360x_torch.models import segmentation as tseg
from gs360x_torch.models import synthseg as tsyn
from gs360x_torch.models import weights as tw
from gs360x_torch.runtime import mesh as tmesh
from gs360x_torch.tools import segtrain as tst

torch.set_num_threads(1)

CPU = torch.device("cpu")
FEATS = (8, 16)
SIZE = 32
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5           # of the largest |gradient| of the tree
GRAD_FLOOR = 1e-4         # of the largest |gradient|: entries compared
PARAM_TOL = 2e-6          # after 3 steps at lr 1e-3
# the CLI trains the default width for 3 steps at lr 3e-3: Adam's first
# steps move each entry whose gradient is near zero by ±lr in either
# package, and the losses and logits drift apart by that much (measured on
# the CPU: 2e-4 in a loss, 1.2e-3 of the largest logit)
CLI_LOSS_TOL = 1e-3
CLI_ACC_TOL = 2e-3
LOGIT_TOL = 5e-3          # of the largest |logit|, after the CLI's steps


def _flax_params(features=FEATS, size=SIZE, seed=0):
    return jax.tree.map(np.asarray, _jit_init(jax.random.key(seed), size,
                                              features))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jit_init(key, size, features):
    return jseg.create_model(features).init(
        key, jnp.zeros((1, size, size, 3), jnp.float32))["params"]


# --- the weights file --------------------------------------------------------

@pytest.mark.parametrize("which", ["shipped", "default width"])
def test_writer_bytes_equal_flax(which, tmp_path):
    if which == "shipped":
        raw = tsyn.packaged_weights_path().read_bytes()
        tree = serialization.msgpack_restore(raw)
    else:
        tree = _flax_params(None, 32)
        raw = serialization.to_bytes(tree)
    params = tw.params_from_flax(tw.read_msgpack(raw))
    assert tw.write_msgpack(tw.params_to_flax(params)) == raw
    assert tw.write_msgpack(tree) == raw
    tseg.save_weights(tmp_path / "w.msgpack", params)
    assert (tmp_path / "w.msgpack").read_bytes() == raw


def test_params_to_flax_inverts_params_from_flax():
    tree = serialization.msgpack_restore(
        tsyn.packaged_weights_path().read_bytes())
    params = tw.params_from_flax(tree)
    back = tw.params_to_flax(params)
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    for key, value in flat.items():
        assert flat_back[key].dtype == np.float32
        np.testing.assert_array_equal(flat_back[key], value)
    again = tw.params_from_flax(back)
    assert again.keys() == params.keys()
    assert all(torch.equal(again[k], params[k]) for k in params)


def test_writer_refuses_what_the_reader_refuses():
    with pytest.raises(ValueError, match="not a str"):
        tw.write_msgpack({1: np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="float is not part"):
        tw.write_msgpack({"a": 1.5})
    # a scalar leaf packs as a fixext 16, a 70000-long axis as a uint 32:
    # neither is in the reader's subset
    with pytest.raises(ValueError, match="array leaf is not part"):
        tw.write_msgpack({"a": np.array(2.0, np.float32)})
    with pytest.raises(ValueError, match="too large"):
        tw.write_msgpack({"a": np.zeros(70000, np.uint8)})
    for tree in ({"a": np.array(2.0, np.float32)},
                 {"a": np.zeros(70000, np.uint8)}):
        with pytest.raises(ValueError, match="not part of the weights"):
            tw.read_msgpack(serialization.to_bytes(tree))


# --- the training step -------------------------------------------------------

def _batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        im = rng.random((2, SIZE, SIZE, 3), dtype=np.float32)
        lb = rng.integers(0, tseg.NUM_CLASSES, (2, SIZE, SIZE)).astype(
            np.int32)
        lb[:, :12] = 0
        yield im, lb


def _jax_run(p0, batches, fg_weight, place=jnp.asarray):
    """The JAX package's train_step from ``p0`` (create_train_state's
    state) over ``batches``, each placed by ``place``: the losses, step 1's
    gradients and the final parameters, by the port's names."""
    state = train_state.TrainState.create(
        apply_fn=jseg.create_model(FEATS).apply, params=p0,
        tx=optax.adamw(1e-3))

    def loss_fn(params, x, lb):
        logits = state.apply_fn({"params": params}, x)
        ce = -jnp.sum(jax.nn.one_hot(lb, tseg.NUM_CLASSES)
                      * jax.nn.log_softmax(logits), axis=-1)
        if fg_weight == 1.0:
            return jnp.mean(ce)
        w = jnp.where(lb > 0, fg_weight, 1.0)
        return jnp.sum(ce * w) / jnp.sum(w)

    losses, grads = [], None
    for im, lb in batches:
        x, y = place(im), place(lb)
        if grads is None:
            grads = tw.params_from_flax(jax.tree.map(
                np.asarray, jax.grad(loss_fn)(state.params, x, y)))
        state, loss = jseg.train_step(state, x, y, fg_weight=fg_weight)
        losses.append(float(loss))
    return losses, grads, tw.params_from_flax(
        jax.tree.map(np.asarray, state.params))


def _port_run(tstate, batches, fg_weight):
    """The port's train_step over ``batches``: the losses, step 1's
    gradients (on the state's first device) and the final parameters."""
    losses, grads = [], None
    for im, lb in batches:
        losses.append(float(tseg.train_step(
            tstate, torch.from_numpy(im), torch.from_numpy(lb), fg_weight)))
        if grads is None:
            grads = {name: p.grad.clone()
                     for name, p in tstate.model.named_parameters()}
    return losses, grads, tstate.model.state_dict()


def _assert_runs_agree(got, ref):
    """Every loss within ``LOSS_RTOL``, step 1's gradients within
    ``GRAD_TOL`` of the largest, the final parameters within ``PARAM_TOL``
    wherever step 1's gradient is at least ``GRAD_FLOOR`` of the largest
    (at most 2% of the entries are below it)."""
    losses, grads, params = got
    ref_losses, ref_grads, ref_params = ref
    assert len(losses) == len(ref_losses)
    for loss, jloss in zip(losses, ref_losses):
        assert abs(loss - jloss) <= LOSS_RTOL * jloss, (loss, jloss)
    gmax = max(float(g.abs().max()) for g in ref_grads.values())
    assert grads.keys() == ref_grads.keys()
    for name, g in ref_grads.items():
        err = float((grads[name] - g).abs().max())
        assert err <= GRAD_TOL * gmax, (name, err, gmax)
    below = 0
    for name, value in ref_params.items():
        keep = ref_grads[name].abs() >= GRAD_FLOOR * gmax
        below += int((~keep).sum())
        if keep.any():
            err = float((params[name] - value).abs()[keep].max())
            assert err <= PARAM_TOL, (name, err)
    total = sum(v.numel() for v in ref_params.values())
    assert below <= 0.02 * total, (below, total)


@pytest.mark.parametrize("fg_weight", [1.0, 4.0])
def test_train_step_matches_jax(fg_weight):
    p0 = _flax_params()
    batches = list(_batches())
    tstate = tseg.create_train_state(None, 1e-3, FEATS, device=CPU,
                                     params=tw.params_from_flax(p0))
    _assert_runs_agree(_port_run(tstate, batches, fg_weight),
                       _jax_run(p0, batches, fg_weight))


# --- the training step over a data mesh --------------------------------------

MESH_N = 3


def _mesh_batches(n=3, seed=5):
    """Batches of 6 whose three shards hold unequal foreground: samples
    0-1 mostly background, 2-3 half, 4-5 mostly subject."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        im = rng.random((6, SIZE, SIZE, 3), dtype=np.float32)
        lb = rng.integers(1, tseg.NUM_CLASSES, (6, SIZE, SIZE)).astype(
            np.int32)
        for i, rows in enumerate((30, 30, 16, 16, 2, 2)):
            lb[i, :rows] = 0
        out.append((im, lb))
    fg = (out[0][1] > 0).reshape(MESH_N, -1).mean(1)
    assert fg[0] < 0.1 < fg[1] < 0.6 < fg[2]
    return out


def _mesh_state(p0, n):
    return tseg.create_train_state(
        None, 1e-3, FEATS, params=tw.params_from_flax(p0),
        mesh=tmesh.data_mesh([CPU] * n))


@pytest.mark.parametrize("fg_weight", [1.0, 4.0])
def test_sharded_step_matches_jax_sharded(fg_weight):
    """The port's step over three CPU devices against the JAX step on a
    batch sharded over three JAX CPU devices: one loss over the global
    batch (with fg_weight 4, the whole batch's weight as denominator)."""
    p0 = _flax_params()
    batches = _mesh_batches()
    sharding = NamedSharding(jmesh.data_mesh(jax.devices()[:MESH_N]),
                             PartitionSpec(jmesh.DATA_AXIS))

    def place(a):
        x = jax.device_put(jnp.asarray(a), sharding)
        assert len(x.addressable_shards) == MESH_N
        return x
    tstate = _mesh_state(p0, MESH_N)
    assert len(tstate.replicas) == MESH_N - 1
    _assert_runs_agree(_port_run(tstate, batches, fg_weight),
                       _jax_run(p0, batches, fg_weight, place))


@pytest.mark.parametrize("fg_weight", [1.0, 4.0])
def test_sharded_step_matches_one_device(fg_weight):
    """Three replicas against one device from the same weights; after
    every step each replica holds the first device's weights bitwise and
    no gradient, and the optimizer holds only the first's parameters."""
    p0 = _flax_params()
    batches = _mesh_batches()
    tstate = _mesh_state(p0, MESH_N)
    got = _port_run(tstate, batches, fg_weight)
    one = tseg.create_train_state(None, 1e-3, FEATS, device=CPU,
                                  params=tw.params_from_flax(p0))
    _assert_runs_agree(got, _port_run(one, batches, fg_weight))
    main = tstate.model.state_dict()
    for replica in tstate.replicas:
        assert all(torch.equal(v, main[k])
                   for k, v in replica.state_dict().items())
        assert all(p.grad is None for p in replica.parameters())
    opt_params = [p for g in tstate.optimizer.param_groups
                  for p in g["params"]]
    assert [id(p) for p in opt_params] == \
        [id(p) for p in tstate.model.parameters()]


def test_one_device_mesh_is_bitwise_the_meshless_step():
    p0 = _flax_params()
    batches = _mesh_batches()
    mesh1 = _mesh_state(p0, 1)
    assert mesh1.replicas == ()
    plain = tseg.create_train_state(None, 1e-3, FEATS, device=CPU,
                                    params=tw.params_from_flax(p0))
    for fg_weight in (1.0, 4.0):
        got = _port_run(mesh1, batches, fg_weight)
        ref = _port_run(plain, batches, fg_weight)
        assert got[0] == ref[0]
        for a, b in zip(got[1:], ref[1:]):
            assert a.keys() == b.keys()
            assert all(torch.equal(a[k], b[k]) for k in a)


def test_sharded_step_refuses_what_does_not_divide():
    p0 = _flax_params()
    tstate = _mesh_state(p0, MESH_N)
    im, lb = _mesh_batches(1)[0]
    with pytest.raises(ValueError, match="does not divide over 3"):
        tseg.train_step(tstate, torch.from_numpy(im[:5]),
                        torch.from_numpy(lb[:5]))
    with pytest.raises(ValueError, match="not the mesh's first"):
        tseg.create_train_state(None, 1e-3, FEATS, device=torch.device(
            "meta"), mesh=tmesh.data_mesh([CPU] * 2))


@pytest.mark.parametrize("decay_steps", [0, 7, 40, 3000])
def test_schedule_matches_optax(decay_steps):
    lr = 3e-3
    if decay_steps:
        warm = max(1, decay_steps // 20)
        ref = optax.warmup_cosine_decay_schedule(
            init_value=lr * 0.1, peak_value=lr, warmup_steps=warm,
            decay_steps=decay_steps, end_value=lr * 0.1)
        sched = tseg.warmup_cosine(lr, decay_steps)
        for step in range(decay_steps + 3):
            assert sched(step) == pytest.approx(float(ref(step)), rel=1e-6)
        assert sched(0) == pytest.approx(0.1 * lr)
    state = tseg.create_train_state(torch.Generator().manual_seed(0), lr,
                                    FEATS, decay_steps, device=CPU)
    im, lb = next(_batches(1))
    for step in range(3):
        tseg.train_step(state, torch.from_numpy(im), torch.from_numpy(lb))
        want = state.schedule(step)
        assert state.optimizer.param_groups[0]["lr"] == want
        assert want == (tseg.warmup_cosine(lr, decay_steps)(step)
                        if decay_steps else lr)
    group = state.optimizer.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == \
        ((0.9, 0.999), 1e-8, 1e-4)


def test_train_convs_sets_the_training_flags():
    """cuDNN on, autotuned, deterministic algorithms only, TF32 off; the
    process's flags as they were afterwards."""
    flags = torch.backends.cudnn
    before = (flags.enabled, flags.benchmark, flags.deterministic,
              flags.allow_tf32)
    with tseg.train_convs():
        assert (flags.enabled, flags.benchmark, flags.deterministic,
                flags.allow_tf32) == (True, True, True, False)
    assert (flags.enabled, flags.benchmark, flags.deterministic,
            flags.allow_tf32) == before


def test_tied_max_pool_window_routes_like_jax():
    rng = np.random.default_rng(0)
    x = np.repeat(np.repeat(rng.random((1, 4, 4, 2), dtype=np.float32)
                            + 0.5, 2, 1), 2, 2)          # every window tied
    w = rng.random((1, 4, 4, 2), dtype=np.float32)
    ref = np.asarray(jax.grad(lambda a: jnp.sum(
        nn.max_pool(a, (2, 2), strides=(2, 2)) * w))(jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).clone().requires_grad_()
    (F.max_pool2d(xt, 2) * torch.from_numpy(w).permute(0, 3, 1, 2)
     ).sum().backward()
    got = xt.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[0, ::2, ::2] > 0).all() and (got[0, 1::2] == 0).all()


# --- the CLI -----------------------------------------------------------------

def make_dataset(root: pathlib.Path, n: int, h: int = 40, w: int = 48):
    """Synthseg scenes cut to h×w with their class masks as PNG pairs, and
    one orphan image."""
    from PIL import Image

    (root / "img").mkdir(parents=True)
    (root / "mask").mkdir(parents=True)
    rng = np.random.default_rng(3)
    for i in range(n):
        img, lab = tsyn.generate_scene(rng, size=w, photo_style=i % 2 == 0)
        Image.fromarray((img[:h] * 255).astype(np.uint8)).save(
            root / "img" / f"f{i:02d}.png")
        Image.fromarray(lab[:h].astype(np.uint8)).save(
            root / "mask" / f"f{i:02d}.png")
    Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(
        root / "img" / "orphan.jpg")


def test_host_helpers_equal_jax(tmp_path):
    make_dataset(tmp_path, 4)
    pairs = tst.find_pairs(tmp_path / "img", tmp_path / "mask")
    assert pairs == jst.find_pairs(tmp_path / "img", tmp_path / "mask")
    assert len(pairs) == 4
    for target in (None, 3):
        for size in (32, 56):
            got = tst.load_pair(*pairs[1], size, target)
            ref = jst.load_pair(*pairs[1], size, target)
            for a, b in zip(got, ref):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    img = np.random.default_rng(0).random((13, 21, 3)).astype(np.float32)
    for h, w in ((13, 21), (32, 32), (7, 40)):
        np.testing.assert_array_equal(tst.resize_bilinear_np(img, h, w),
                                      jst.resize_bilinear_np(img, h, w))


def _cli(module, args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = module.main(args)
    return rc, buf.getvalue().splitlines()


@pytest.fixture
def same_init(monkeypatch):
    """Both CLIs start from the JAX package's init of their seed: JAX's
    traced (the same values, faster than Flax's eager init), the port's
    carried across with params_from_flax."""
    monkeypatch.setattr(jseg, "init_params",
                        lambda rng, input_size=256, features=None: _jit_init(
                            rng, input_size, features))
    monkeypatch.setattr(tseg, "init_params",
                        lambda generator, features=None: tw.params_from_flax(
                            _flax_params(features, SIZE)))


_NUM = re.compile(r"(loss|val_acc) (\d+\.\d+)")


def _assert_cli_lines_agree(got, ref):
    """The lines after the first of two 12-pair runs of 3 epochs: the same
    text, the losses and accuracies within ``CLI_LOSS_TOL`` /
    ``CLI_ACC_TOL``."""
    assert got[1] == ref[1] == "[INFO] train 11, val 1"
    assert len(got) == len(ref) == 6
    for a, b in zip(got[2:5], ref[2:5]):
        assert _NUM.sub("#", a) == _NUM.sub("#", b)
        for (ka, va), (kb, vb) in zip(_NUM.findall(a), _NUM.findall(b)):
            assert ka == kb
            tol = CLI_LOSS_TOL if ka == "loss" else CLI_ACC_TOL
            assert abs(float(va) - float(vb)) <= tol, (a, b)


def _assert_logits_agree(weights, jax_ckpt):
    """The logits of the port's written weights within ``LOGIT_TOL`` of the
    largest of the JAX checkpoint's, on a random batch."""
    params = tseg.load_weights(weights)
    jparams = jseg.load_checkpoint(jax_ckpt,
                                   _jit_init(jax.random.key(0), SIZE, None))
    x = np.random.default_rng(1).random((2, SIZE, SIZE, 3), np.float32)
    ref_logits = np.asarray(jseg.create_model().apply(
        {"params": jparams}, jnp.asarray(x))).transpose(0, 3, 1, 2)
    model = tseg.create_model(tseg.features_from_params(params))
    model.load_state_dict(params)
    with torch.no_grad():
        got_logits = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    err = np.abs(got_logits - ref_logits).max()
    assert err <= LOGIT_TOL * np.abs(ref_logits).max(), err


def test_cli_matches_jax(tmp_path, same_init):
    make_dataset(tmp_path, 12)
    args = ["-i", str(tmp_path / "img"), "-m", str(tmp_path / "mask"),
            "--size", str(SIZE), "--batch-size", "8", "--epochs", "3",
            "--lr", "3e-3"]
    rc, ref = _cli(jst, args + ["-o", str(tmp_path / "jax_ckpt")])
    assert rc == 0
    rc, got = _cli(tst, args + ["-o", str(tmp_path / "w.msgpack"),
                                "--device", "cpu"])
    assert rc == 0
    assert ref[0] == "[INFO] 12 pairs, size 32, devices 8"
    assert got[0] == "[INFO] 12 pairs, size 32, devices 1"
    _assert_cli_lines_agree(got, ref)
    assert got[5].startswith(f"[OK] checkpoint: {tmp_path / 'w.msgpack'} (")
    _assert_logits_agree(tmp_path / "w.msgpack", tmp_path / "jax_ckpt")

    # --resume from the written file: one more epoch from those weights
    rc, lines = _cli(tst, args[:-2] + ["--epochs", "1", "-o",
                                       str(tmp_path / "w2.msgpack"),
                                       "--resume", str(tmp_path / "w.msgpack"),
                                       "--device", "cpu"])
    assert rc == 0 and lines[2] == f"[INFO] resumed from {tmp_path}/w.msgpack"


@pytest.mark.parametrize("batch_size", [4, 8])
def test_cli_over_an_8_device_mesh_matches_jax(tmp_path, same_init,
                                               monkeypatch, batch_size):
    """The port's CLI with its mesh made of 8 CPU devices against the JAX
    CLI over conftest's 8: both print ``devices 8`` and train batches of 8
    (``--batch-size 4`` rounds up to the mesh), the same number of steps,
    and the losses, accuracies and final logits agree."""
    monkeypatch.setattr(tst, "train_mesh",
                        lambda device: tmesh.data_mesh([device] * 8))
    sizes = {"jax": [], "port": []}

    def counted(module, key):
        step = module.train_step

        def train_step(state, images, labels, *args, **kw):
            sizes[key].append(int(images.shape[0]))
            return step(state, images, labels, *args, **kw)
        monkeypatch.setattr(module, "train_step", train_step)
    counted(jseg, "jax")
    counted(tseg, "port")
    make_dataset(tmp_path, 12)
    args = ["-i", str(tmp_path / "img"), "-m", str(tmp_path / "mask"),
            "--size", str(SIZE), "--batch-size", str(batch_size),
            "--epochs", "3", "--lr", "3e-3"]
    rc, ref = _cli(jst, args + ["-o", str(tmp_path / "jax_ckpt")])
    assert rc == 0
    rc, got = _cli(tst, args + ["-o", str(tmp_path / "w.msgpack"),
                                "--device", "cpu"])
    assert rc == 0
    assert got[0] == ref[0] == "[INFO] 12 pairs, size 32, devices 8"
    assert sizes["port"] == sizes["jax"] == [8] * 3
    _assert_cli_lines_agree(got, ref)
    _assert_logits_agree(tmp_path / "w.msgpack", tmp_path / "jax_ckpt")


def test_error_exits_match_jax(tmp_path, capsys):
    assert jst.main([]) == 2
    ref = capsys.readouterr().err
    assert tst.main(["--device", "cpu"]) == 2
    assert capsys.readouterr().err == ref
    make_dataset(tmp_path, 1)
    args = ["-i", str(tmp_path / "img"), "-m", str(tmp_path / "mask"),
            "-o", str(tmp_path / "out")]
    assert jst.main(args) == 1
    ref = capsys.readouterr().err
    assert tst.main(args + ["--device", "cpu"]) == 1
    assert capsys.readouterr().err == ref
    assert ref.startswith("[ERR] need >=2 image/mask pairs, found 1")


def test_orbax_resume_is_refused(tmp_path, capsys):
    make_dataset(tmp_path, 3)
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    rc = tst.main(["-i", str(tmp_path / "img"), "-m", str(tmp_path / "mask"),
                   "-o", str(tmp_path / "w.msgpack"), "--resume", str(orbax),
                   "--size", "16", "--device", "cpu"])
    assert rc == 1
    assert capsys.readouterr().err == (
        f"[ERR] failed to load checkpoint: {orbax} is a directory; Orbax "
        "checkpoints are not readable by the port (pass the single-file "
        "msgpack that save_weights writes)\n")
    assert not (tmp_path / "w.msgpack").exists()


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    make_dataset(tmp_path, 2)
    with pytest.raises(RuntimeError, match="--device cuda"):
        tst.main(["-i", str(tmp_path / "img"), "-m", str(tmp_path / "mask"),
                  "-o", str(tmp_path / "w.msgpack")])


FEW = dict(steps=3, n_scenes=6, size=32, batch=2)


def test_make_default_writes_weights_jax_loads(tmp_path, monkeypatch,
                                               capsys):
    """``--make-default`` with the recipe cut to 3 steps of batch 2 at 32²:
    the file loads in the JAX package, and the port's
    ``build_default_checkpoint`` trains on the batches the JAX package's
    draws."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setattr(tsyn, "build_default_checkpoint", functools.partial(
        tsyn.build_default_checkpoint, **FEW))
    seen = {}

    def train_step(state, images, labels, fg_weight=1.0):
        seen.setdefault("port", []).append(images.numpy().copy())
        return orig_step(state, images, labels, fg_weight)
    orig_step = tseg.train_step
    monkeypatch.setattr(tseg, "train_step", train_step)
    assert tst.main(["--make-default", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    path = tsyn.default_weights_path()
    assert path == tmp_path / "home/.cache/gs360x/seg_default_v3_torch.msgpack"
    assert out.endswith(f"[synthseg] default checkpoint saved: {path}\n")
    assert len(re.findall(r"\[synthseg\] step \d/3 loss", out)) == 3

    # the JAX package's loader reads the file into its default-width tree
    template = _jit_init(jax.random.key(0), 32, None)
    loaded = jseg.load_weights(path, template)
    ref = tw.params_to_flax(tseg.load_weights(path))
    flat = jax.tree_util.tree_leaves_with_path(loaded)
    assert len(flat) == len(jax.tree_util.tree_leaves(ref))
    for key, value in flat:
        np.testing.assert_array_equal(
            np.asarray(value),
            functools.reduce(lambda d, k: d[k.key], key, ref))

    # the same batches as the JAX package's build_default_checkpoint
    jax_batches = []

    def jax_step(state, images, labels, fg_weight=1.0):
        jax_batches.append(np.asarray(images))
        return state, jnp.float32(0.0)
    monkeypatch.setattr(jseg, "train_step", jax_step)
    monkeypatch.setattr(jseg, "init_params",
                        lambda rng, input_size=256, features=None: _jit_init(
                            rng, input_size, features))
    monkeypatch.setattr(jseg, "save_checkpoint", lambda path, params: None)
    jsyn.build_default_checkpoint(tmp_path / "jax", verbose=False, **FEW)
    assert len(jax_batches) == len(seen["port"]) == 3
    for a, b in zip(seen["port"], jax_batches):
        np.testing.assert_array_equal(a, b)


def test_make_default_honours_checkpoint_path(tmp_path, monkeypatch):
    monkeypatch.setattr(tsyn, "build_default_checkpoint", functools.partial(
        tsyn.build_default_checkpoint, verbose=False, **FEW))
    out = tmp_path / "sub" / "default.msgpack"
    assert tst.main(["--make-default", "-o", str(out), "--device",
                     "cpu"]) == 0
    params = tseg.load_weights(out)
    assert tseg.features_from_params(params) == tseg.DEFAULT_FEATURES
