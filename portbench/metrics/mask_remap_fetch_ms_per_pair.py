"""upload + remap + fetch: each lens mask's upload, its nearest launch
through the views' maps and its fetch in ``tools/dualfisheye``'s pair
loop — the tool's ``mask_remap+fetch`` timer (``--stats``) over the pairs
it uploaded in the call, in ms; None where the program keeps no such
timer."""


def read(r):
    s, n = r.outcome.stage_seconds, r.outcome.stage_counts.get("upload")
    if not n or "mask_remap+fetch" not in s:
        return None
    return s["mask_remap+fetch"] / n * 1e3
