"""decode: ``tools/dualfisheye``'s mask reads (``read_image`` of each lens's
mask, inside the pair's ``decode``) — the tool's ``mask_decode`` timer
(``--stats``) over the pairs it uploaded in the call, in ms; None where
the program keeps no such timer."""


def read(r):
    s, n = r.outcome.stage_seconds, r.outcome.stage_counts.get("upload")
    if not n or "mask_decode" not in s:
        return None
    return s["mask_decode"] / n * 1e3
