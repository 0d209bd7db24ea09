"""CLI + plan: ``tools/dualfisheye``'s ``map_build`` stage around its
``build_perspective_spec_maps`` calls (host numpy, before the window) —
the tool's own total (``--stats``), in s; it moves ``setup_s``."""


def read(r):
    return r.outcome.stage_seconds.get("map_build")
