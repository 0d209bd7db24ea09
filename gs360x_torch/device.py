"""Resolve the CLI's ``--device`` into an explicit :class:`torch.device`.

The port has no hidden global device: the CLI resolves one here and passes
it down. ``cuda`` without a card raises instead of quietly running on the
CPU; ``cpu`` runs the plain torch versions of every kernel.
"""

from __future__ import annotations

import torch

DEVICE_CHOICES = ("cuda", "cpu")


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` → the current CUDA device (raises when there is none);
    ``"cpu"`` → the CPU."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda: no CUDA device is available "
                "(torch.cuda.is_available() is False); pass --device cpu "
                "to run the plain torch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r}: expected one of "
                     f"{', '.join(DEVICE_CHOICES)}")
