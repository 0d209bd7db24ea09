"""the card's kernel time a pair (an end-to-end metric from the device
trace): every kernel's device time in the window, the plain-torch LUT
chain, the texel passes and the remaps, over the pairs the window remapped
(its remap launches over 2), in ms. Copies are left out: a pageable copy
runs at the pace of the host's memory, which is not the card's."""


def read(r):
    if r.trace is None:
        return None
    pairs = len(r.trace.family_us("remap")) / 2
    if not pairs:
        return None
    return sum(d for _n, d in r.trace.kernels()) / pairs / 1e3
