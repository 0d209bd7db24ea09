"""kernel: ``csrc/remap.cu`` in the LUT cell, on f32 planes:
``remap_roofline``'s reading, where it moves ``kernel_ms_per_pair``."""

import pathlib

from portbench import harness


def read(r):
    return harness.load_module(pathlib.Path(__file__).with_name(
        "remap_roofline.py")).read(r)
