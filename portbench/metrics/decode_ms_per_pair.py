"""decode: ``tools/dualfisheye``'s decode pool (``read_image``, both
lenses) — the tool's ``decode`` timer (``--stats``) over the pairs it
decoded in the call, in ms."""


def read(r):
    n = r.outcome.stage_counts.get("decode")
    return r.outcome.stage_seconds["decode"] / n * 1e3 if n else None
