"""decode: ``io/image.read_image`` on ``runtime/executor``'s prefetch
thread — the program's ``decode`` timer over the frames it decoded in the
window (the harness's count of ``read_image`` calls), in ms."""


def read(r):
    frames = r.spans.get("decode", (0.0, 0))[1]
    if not frames or "decode" not in r.outcome.stage_seconds:
        return None
    return r.outcome.stage_seconds["decode"] / frames * 1e3
