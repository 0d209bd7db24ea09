"""upload + dispatch: ``runtime/executor._warp_frame_views`` — the
program's ``warp_dispatch`` timer over the frames dispatched in the window,
in ms."""


def read(r):
    frames = r.spans.get("dispatch", (0.0, 0))[1]
    if not frames or "warp_dispatch" not in r.outcome.stage_seconds:
        return None
    return r.outcome.stage_seconds["warp_dispatch"] / frames * 1e3
