"""plain torch steps: ``core/color``'s LUT decode and colour chain, the
quantize — the device time of the window's kernels outside the planarize,
warp and remap families, over the pairs the window remapped (its remap
launches over 2), in ms."""


def read(r):
    if r.trace is None:
        return None
    pairs = len(r.trace.family_us("remap")) / 2
    if not pairs:
        return None
    return sum(r.trace.family_us("other")) / pairs / 1e3
