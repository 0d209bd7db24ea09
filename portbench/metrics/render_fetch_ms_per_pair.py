"""upload + remap + fetch: ``dualfisheye.prepare_input_planes`` and
``_LensViews.render`` — the tool's ``upload`` and ``remap+fetch`` timers
(``--stats``) over the pairs of the call, in ms."""


def read(r):
    s, n = r.outcome.stage_seconds, r.outcome.stage_counts.get("upload")
    if not n or "remap+fetch" not in s:
        return None
    return (s["upload"] + s["remap+fetch"]) / n * 1e3
