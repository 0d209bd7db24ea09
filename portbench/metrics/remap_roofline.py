"""kernel: ``csrc/remap.cu`` via ``kernels/remap_cuda`` — the least time of
the window's ``remap_kernel`` launches (``work.remap_launches``: a lens's
SFM10 views, the mean of a pair's two launches, counted from the
configuration's shapes and maps) over their summed device time, in %."""


def read(r):
    bound = r.outcome.work.get("remap", {}).get("us")
    times = r.trace.family_us("remap") if r.trace is not None else []
    if not bound or not times:
        return None
    return 100.0 * len(times) * bound / sum(times)
