"""The segmentation U-Net, its training step and its predictor (the port
of :mod:`gs360x.models.segmentation`).

The same network as the JAX package's Flax ``UNet``, in NCHW: ``ConvBlock``
is two 3×3 convs (``padding=1``), each followed by ``GroupNorm(min(8, f))``
with Flax's epsilon (1e-6, not torch's 1e-5) and ReLU; 2×2 max-pools down;
the decoder upsamples ×2 nearest (index ``i // 2``, as ``jax.image.resize``
does at an integer factor), convolves 3×3, concatenates ``[x, skip]`` in
that order and runs a ``ConvBlock``; a 1×1 head gives the class logits.
Module names follow Flax's numbering (``ConvBlock_i``, ``Conv_j``), so the
``state_dict`` of :func:`~gs360x_torch.models.weights.params_from_flax`
loads as it is.

The predictor keeps the JAX order — resize in, U-Net, softmax over the
classes, resize out — and runs it on an explicit device. The convolutions
are library calls in full f32 (:func:`f32_convs`: no TF32, which torch
allows by default and which moves the logits by ~5e-2 against the f32
reference).

Training keeps optax's AdamW (``weight_decay`` 1e-4 on every parameter,
not torch's 1e-2) and its warmup-cosine schedule, evaluated at the step
count before the update. Over a data mesh (``runtime.mesh.Mesh``) a step
is data-parallel, as the JAX step over a sharded batch is: each device's
replica takes its block of the batch, the gradients are summed on the
first device, which alone holds the optimizer, and its weights are copied
back to the replicas. The checkpoint is the single-file msgpack of
:func:`save_weights`, which ``flax.serialization`` reads; the JAX
package's Orbax directories need orbax and tensorstore and are not read.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import pathlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gs360x_torch.models.weights import (params_from_flax, params_to_flax,
                                         read_msgpack, write_msgpack)

# class table: background + the mask tool's supported targets
CLASS_NAMES = ("background", "person", "bicycle", "car", "motorcycle",
               "bus", "truck", "bird", "cat", "dog")
NUM_CLASSES = len(CLASS_NAMES)
CLASS_TO_INDEX = {name: i for i, name in enumerate(CLASS_NAMES)}

# inference contract constants (reference gs360_SegmentationMaskTool.py:48-54)
SCORE_THRESH = 0.7
MASK_THRESH = 0.5
DETECTIONS_PER_IMG = 15
MIN_SIZE = 640
MAX_SIZE = 1024

# COCO label ids for the targets (reference table :75-195)
TARGET_TO_CLASSES = {
    "person": ["person"],
    "bicycle": ["bicycle"],
    "car": ["car"],
    "motorcycle": ["motorcycle"],
    "bus": ["bus"],
    "truck": ["truck"],
    "animal": ["bird", "cat", "dog"],
}

DEFAULT_FEATURES = (32, 64, 128, 256)
GROUPNORM_EPS = 1e-6          # flax.linen.GroupNorm's epsilon


class GroupNorm(nn.GroupNorm):
    """``flax.linen.GroupNorm`` over NCHW: ``(x - mean) * (rsqrt(var + eps)
    * scale) + bias`` per group, with the variance taken about the mean
    (two passes). ``F.group_norm`` on the CPU with one thread loses
    ~1e-4 relative on a 576×1024 activation, more than the gate allows."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        g = self.num_groups
        flat = x.reshape(n, g, -1)       # one flat reduction a group: the
        mean = flat.mean(-1)             # accurate kind on the CPU
        var = (flat - mean[..., None]).square().mean(-1)
        shape = (n, g, c // g, -1)
        mul = torch.rsqrt(var + self.eps)[..., None] \
            * self.weight.view(1, g, c // g)
        d = x.reshape(shape) - mean[..., None, None]
        return (d * mul[..., None] + self.bias.view(1, g, c // g, 1)
                ).reshape(x.shape)


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, features: int) -> None:
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, features, 3, padding=1)
        self.GroupNorm_0 = GroupNorm(min(8, features), features,
                                     eps=GROUPNORM_EPS)
        self.Conv_1 = nn.Conv2d(features, features, 3, padding=1)
        self.GroupNorm_1 = GroupNorm(min(8, features), features,
                                     eps=GROUPNORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        return F.relu(self.GroupNorm_1(self.Conv_1(x)))


class UNet(nn.Module):
    """Encoder/decoder segmentation net with skip connections; input
    (B, 3, H, W) float in [0, 1], output class logits (B, NUM_CLASSES, H,
    W). H and W must be multiples of ``2 ** (len(features) - 1)``."""

    def __init__(self, features: Sequence[int] = DEFAULT_FEATURES,
                 num_classes: int = NUM_CLASSES) -> None:
        super().__init__()
        self.features = tuple(int(f) for f in features)
        n = len(self.features)
        cin = 3
        for i, f in enumerate(self.features):          # encoder, bottleneck
            self.add_module(f"ConvBlock_{i}", ConvBlock(cin, f))
            cin = f
        for j, f in enumerate(reversed(self.features[:-1])):
            self.add_module(f"Conv_{j}", nn.Conv2d(cin, f, 3, padding=1))
            self.add_module(f"ConvBlock_{n + j}", ConvBlock(2 * f, f))
            cin = f
        self.add_module(f"Conv_{n - 1}", nn.Conv2d(cin, num_classes, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.features)
        skips = []
        for i in range(n - 1):
            x = getattr(self, f"ConvBlock_{i}")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = getattr(self, f"ConvBlock_{n - 1}")(x)
        for j, skip in enumerate(reversed(skips)):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = getattr(self, f"Conv_{j}")(x)
            x = torch.cat([x, skip], dim=1)
            x = getattr(self, f"ConvBlock_{n + j}")(x)
        return getattr(self, f"Conv_{n - 1}")(x)


def create_model(features=None) -> UNet:
    return UNet() if features is None else UNet(features=tuple(features))


def init_params(generator: torch.Generator, features=None
                ) -> Dict[str, torch.Tensor]:
    """Random weights drawn from ``generator`` with Flax's initializers:
    conv kernels LeCun normal (truncated at two deviations), biases 0,
    GroupNorm scales 1."""
    params = create_model(features).state_dict()
    for name, p in params.items():
        if p.dim() == 4:
            std = (1.0 / p[0].numel()) ** 0.5 / .87962566103423978
            nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
    return params


def save_weights(path, params: Dict[str, torch.Tensor]) -> None:
    """Write a ``state_dict`` as single-file msgpack weights, the bytes
    ``gs360x.models.segmentation.save_weights`` writes for the same
    values."""
    pathlib.Path(path).write_bytes(write_msgpack(params_to_flax(params)))


def load_weights(path) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a single-file msgpack weights file, the format
    ``gs360x.models.segmentation.save_weights`` writes; ValueError unless
    it is the weights of a U-Net."""
    params = params_from_flax(read_msgpack(pathlib.Path(path).read_bytes()))
    try:
        create_model(features_from_params(params)).load_state_dict(params)
    except (KeyError, RuntimeError) as exc:
        raise ValueError(f"{path}: not the weights of a segmentation U-Net "
                         f"({exc})") from exc
    return params


def load_checkpoint(path) -> Dict[str, torch.Tensor]:
    """:func:`load_weights` of a ``--checkpoint`` / ``--resume`` path;
    ValueError for a directory, which is the JAX package's Orbax format."""
    path = pathlib.Path(path)
    if path.is_dir():
        raise ValueError(f"{path} is a directory; Orbax checkpoints are not "
                         "readable by the port (pass the single-file msgpack "
                         "that save_weights writes)")
    return load_weights(path)


def features_from_params(params) -> Tuple[int, ...]:
    """The U-Net width tuple of a ``state_dict`` (the encoder ConvBlocks'
    out-channels), so one predictor serves weights of any width."""
    blocks = sorted({k.split(".")[0] for k in params
                     if k.startswith("ConvBlock_")},
                    key=lambda k: int(k.split("_")[1]))
    n_enc = (len(blocks) + 1) // 2          # encoder + bottleneck
    return tuple(int(params[f"{b}.Conv_0.weight"].shape[0])
                 for b in blocks[:n_enc])


def f32_convs():
    """A scope in which the convolutions run in full f32 through torch's
    own route (im2col and an f32 cuBLAS product, at torch's default matmul
    precision): cuDNN is off in it, leaving the process's other flags as
    they are. With TF32 off, cuDNN 9 runs the default width's convs about
    40 times slower than this route (``chip_smoke.py`` ``[maskseg]`` times
    both routes at both widths); with TF32, torch's default, it moves the
    logits by ~5e-2."""
    return torch.backends.cudnn.flags(
        enabled=False, benchmark=torch.backends.cudnn.benchmark,
        deterministic=torch.backends.cudnn.deterministic, allow_tf32=False)


def train_convs():
    """The scope of the convolutions in training, in full f32: cuDNN with
    TF32 off, its autotuner on and only its deterministic algorithms, so
    that within a process the same batches give the same weights, run
    after run. Another process may autotune to other algorithms, whose
    rounding moves the weights. For a step of the default width at 256²,
    batch 8, this route is about 1.5 times faster on an H100 than the
    im2col route of :func:`f32_convs` (``chip_smoke.py`` ``[segtrain]``
    times both)."""
    return torch.backends.cudnn.flags(
        enabled=True, benchmark=True, deterministic=True, allow_tf32=False)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


def warmup_cosine(learning_rate: float, decay_steps: int
                  ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule`` as the JAX package sets it
    up: from 0.1× the peak rate linearly up to it over ``max(1,
    decay_steps // 20)`` steps, then a cosine down to 0.1× at
    ``decay_steps``, which counts the warmup; flat after."""
    warm = max(1, decay_steps // 20)
    low = learning_rate * 0.1

    def sched(step: int) -> float:
        if step < warm:
            return (low - learning_rate) * (1.0 - step / warm) + learning_rate
        t = min(step - warm, decay_steps - warm)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / (decay_steps - warm)))
        return learning_rate * (0.9 * cosine + 0.1)
    return sched


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the rate of each step and the count of
    steps taken; on a data mesh of n > 1 devices, the mesh and one replica
    of the model on each device after the first (``model`` is on the
    first)."""
    model: UNet
    optimizer: torch.optim.AdamW
    schedule: Callable[[int], float]
    step: int = 0
    mesh: Optional[object] = None
    replicas: Tuple[UNet, ...] = ()


def create_train_state(generator: torch.Generator,
                       learning_rate: float = 1e-3, features=None,
                       decay_steps: int = 0, *,
                       device: Optional[torch.device] = None,
                       params: Optional[Dict[str, torch.Tensor]] = None,
                       mesh=None) -> TrainState:
    """A U-Net with :func:`init_params` weights drawn from ``generator``
    (or ``params``) on ``device`` and ``optax.adamw``'s optimizer: betas
    0.9 / 0.999, eps 1e-8, weight decay 1e-4 on every parameter, at the
    flat ``learning_rate`` or, with ``decay_steps`` > 0, at
    :func:`warmup_cosine`. With a ``mesh`` (a ``runtime.mesh.Mesh``) the
    model and the optimizer are on its first device (``device``, if given,
    must be that one) and a replica of the model on each further device;
    two replicas may share a device."""
    if mesh is not None:
        if device is not None and torch.device(device) != mesh.devices[0]:
            raise ValueError(f"create_train_state: device {device} is not "
                             f"the mesh's first, {mesh.devices[0]}")
        device = mesh.devices[0]
    if device is None:
        raise ValueError("create_train_state: pass a device or a mesh")
    model = create_model(features)
    model.load_state_dict(params if params is not None
                          else init_params(generator, features))
    model.to(device)
    optimizer = torch.optim.AdamW(model.parameters(), lr=learning_rate,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-4)
    schedule = (warmup_cosine(learning_rate, decay_steps) if decay_steps
                else lambda step: learning_rate)
    if mesh is None or mesh.size == 1:
        return TrainState(model, optimizer, schedule)
    replicas = tuple(copy.deepcopy(model).to(dev)
                     for dev in mesh.devices[1:])
    return TrainState(model, optimizer, schedule, mesh=mesh,
                      replicas=replicas)


def loss_fn(logits: torch.Tensor, labels: torch.Tensor,
            fg_weight: float = 1.0) -> torch.Tensor:
    """Softmax cross-entropy of (B, C, H, W) logits against (B, H, W) class
    ids: the mean, or with ``fg_weight`` != 1 the mean weighted by
    ``fg_weight`` where the label is a subject and 1 elsewhere."""
    ce = F.cross_entropy(logits, labels, reduction="none")
    if fg_weight != 1.0:
        w = torch.where(labels > 0, fg_weight, 1.0)
        return (ce * w).sum() / w.sum()
    return ce.mean()


def train_step(state: TrainState, images: torch.Tensor,
               labels: torch.Tensor, fg_weight: float = 1.0
               ) -> torch.Tensor:
    """One optimization step on (B, H, W, 3) f32 images and (B, H, W) int
    labels on the state's (first) device; the loss of the whole batch
    before the update: ``Σ ce·w / Σ w`` with w = ``fg_weight`` on subject
    pixels and 1 elsewhere (the mean with ``fg_weight`` 1). The rate is the
    schedule's at the count before the update, as optax takes it. On a
    mesh of n > 1 devices B must divide by n: each replica backpropagates
    its block's ``Σ ce·w`` over the whole batch's ``Σ w`` (not its own),
    so the gradients, summed on the first device in device order, are the
    whole batch's up to the order of summation (the U-Net has GroupNorm
    and no batch statistics: a sample's forward does not depend on the
    split)."""
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.step)
    state.optimizer.zero_grad(set_to_none=True)
    if not state.replicas:
        with train_convs():
            logits = state.model(images.permute(0, 3, 1, 2))
            loss = loss_fn(logits, labels.long(), fg_weight)
            loss.backward()
    else:
        loss = _sharded_backward(state, images, labels.long(), fg_weight)
    state.optimizer.step()
    if state.replicas:
        with torch.no_grad():
            for replica in state.replicas:
                for mine, main in zip(replica.parameters(),
                                      state.model.parameters()):
                    mine.copy_(main)
    state.step += 1
    return loss.detach()


def _sharded_backward(state: TrainState, images: torch.Tensor,
                      labels: torch.Tensor, fg_weight: float
                      ) -> torch.Tensor:
    """Forward and backward of each replica on its block of the batch,
    each scaled by the whole batch's weight; the replicas' gradients are
    added to the first device's in device order and then dropped. Returns
    the whole batch's loss on the first device."""
    from gs360x_torch.runtime.mesh import shard_frames

    if fg_weight != 1.0:
        total = torch.where(labels > 0, fg_weight, 1.0).sum()
    else:
        total = torch.tensor(float(labels.numel()), device=labels.device)
    models = (state.model, *state.replicas)
    sums = []
    with train_convs():
        for model, x, y in zip(models, shard_frames(state.mesh, images),
                               shard_frames(state.mesh, labels)):
            ce = F.cross_entropy(model(x.permute(0, 3, 1, 2)), y,
                                 reduction="none")
            if fg_weight != 1.0:
                ce = ce * torch.where(y > 0, fg_weight, 1.0)
            part = ce.sum()
            (part / total.to(part.device)).backward()
            sums.append(part.detach())
    with torch.no_grad():
        for replica in state.replicas:
            for mine, main in zip(replica.parameters(),
                                  state.model.parameters()):
                main.grad += mine.grad.to(main.device)
            replica.zero_grad(set_to_none=True)
    first = state.mesh.devices[0]
    return sum(s.to(first) for s in sums) / total.to(first)


def resize_linear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(…, "linear")`` of an (N, C, H, W) tensor:
    half-pixel centres, and a triangle filter widened by the scale along an
    axis that shrinks (anti-aliased) but not along one that grows. Where
    one axis grows and the other shrinks, one pass an axis."""
    h, w = x.shape[-2:]
    nh, nw = size
    if (nh - h) * (nw - w) < 0:
        x = F.interpolate(x, size=(nh, w), mode="bilinear",
                          align_corners=False, antialias=nh < h)
        h = nh
    return F.interpolate(x, size=(nh, nw), mode="bilinear",
                         align_corners=False, antialias=nh < h or nw < w)


def inference_size(h: int, w: int, min_size: int = MIN_SIZE,
                   max_size: int = MAX_SIZE) -> Tuple[int, int]:
    """Reference-compatible resize rule (short side → 640, long ≤ 1024),
    rounded to multiples of 16 for the U-Net."""
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh = max(16, int(round(h * scale / 16)) * 16)
    nw = max(16, int(round(w * scale / 16)) * 16)
    return nh, nw


class SegmentationPredictor:
    """End-to-end predictor on ``device``: resize → U-Net → instance
    extraction (on the host). ``timers`` (a ``StageTimers``), when given,
    receives the wall of ``detect``'s device part (``infer``: up to the
    fetch) and host part (``instances``)."""

    def __init__(self, params: Optional[Dict[str, torch.Tensor]] = None, *,
                 device: torch.device, rng_seed: int = 0,
                 timers=None) -> None:
        self.timers = timers
        if params is None:
            params = init_params(torch.Generator().manual_seed(rng_seed))
        self.features = features_from_params(params)
        self.device = torch.device(device)
        self.model = create_model(self.features)
        self.model.load_state_dict(params)
        self.model.to(self.device).eval()

    def _stage(self, name: str):
        return self.timers.stage(name) if self.timers \
            else contextlib.nullcontext()

    @torch.inference_mode()
    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """U-Net logits of an (N, 3, H, W) batch on the device."""
        with f32_convs():
            return self.model(x)

    def upload(self, rgb01: np.ndarray) -> torch.Tensor:
        """(H, W, 3) float [0, 1] on the host → (1, 3, H, W) f32 on the
        device."""
        img = torch.from_numpy(np.ascontiguousarray(rgb01, np.float32))
        return img.to(self.device).permute(2, 0, 1)[None]

    @torch.inference_mode()
    def probabilities(self, rgb01: np.ndarray,
                      channels: Optional[Sequence[int]] = None
                      ) -> torch.Tensor:
        """Class probabilities (C, H, W) on the device at the input's size,
        of every class or only of ``channels``: the resize out works per
        channel, so a subset has the values the full map would."""
        h, w = rgb01.shape[:2]
        img = resize_linear(self.upload(rgb01), inference_size(h, w))
        probs = torch.softmax(self.logits(img), dim=1)
        if channels is not None:
            probs = probs[:, list(channels)]
        return resize_linear(probs, (h, w))[0]

    def class_probabilities(self, rgb01: np.ndarray) -> np.ndarray:
        """(H, W, NUM_CLASSES) probabilities on the host."""
        return self.probabilities(rgb01).permute(1, 2, 0).cpu().numpy()

    def detect(self, rgb01: np.ndarray, target_classes: Sequence[str], *,
               score_thresh: float = SCORE_THRESH,
               mask_thresh: float = MASK_THRESH,
               max_detections: int = DETECTIONS_PER_IMG) -> List[dict]:
        """Instance list [{'mask' (H,W) bool, 'score', 'class_name'}],
        score-sorted, capped at max_detections. Only the target classes'
        probabilities are resized and fetched."""
        from gs360x_torch.models.instances import instance_masks

        names = [name for name in target_classes if name in CLASS_TO_INDEX]
        if not names:
            return []
        with self._stage("infer"):
            probs = self.probabilities(
                rgb01, [CLASS_TO_INDEX[name] for name in names]).cpu().numpy()
        detections = []
        with self._stage("instances"):
            for name, p in zip(names, probs):
                binary = p >= mask_thresh
                if not binary.any():
                    continue
                for det in instance_masks(binary, p,
                                          score_thresh=score_thresh,
                                          max_count=max_detections):
                    det["class_name"] = name
                    detections.append(det)
        detections.sort(key=lambda d: -d["score"])
        return detections[:max_detections]

    def combined_mask(self, rgb01: np.ndarray,
                      target_classes: Sequence[str], **kw
                      ) -> Optional[np.ndarray]:
        """Union of detected instance masks as uint8 {0,255}, or None."""
        dets = self.detect(rgb01, target_classes, **kw)
        if not dets:
            return None
        out = np.zeros(rgb01.shape[:2], bool)
        for d in dets:
            out |= d["mask"]
        return out.astype(np.uint8) * 255
