"""kernel: ``csrc/warp_equirect.cu`` via ``kernels/warp_cuda`` — the least
time of the window's ``warp_equirect_kernel`` launches (``work.warp_launch``:
one frame through every view, counted from the configuration's shapes) over
their summed device time, in %."""


def read(r):
    bound = r.outcome.work.get("warp", {}).get("us")
    times = r.trace.family_us("warp") if r.trace is not None else []
    if not bound or not times:
        return None
    return 100.0 * len(times) * bound / sum(times)
