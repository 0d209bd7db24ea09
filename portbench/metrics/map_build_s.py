"""CLI + plan: ``dualfisheye.build_perspective_spec_maps`` (host numpy) —
the harness's span around the call, in s; it moves ``setup_s``."""


def read(r):
    return r.bench.notes.get("map_build_s")
