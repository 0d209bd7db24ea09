"""kernel: ``csrc/remap.cu`` via ``kernels/remap_cuda`` — the least time of
the window's mask launches (``nearest`` over one u8 plane, the u8 store,
told from the views' remaps by the kernel's template arguments,
``mask_work.is_mask_launch``; ``mask_work.mask_remap_launches``: the mean
of a pair's two launches, counted from the configuration's shapes and
maps) over their summed device time, in %."""

from portbench.mask_work import is_mask_launch


def read(r):
    bound = r.outcome.work.get("mask_remap", {}).get("us")
    times = [us for name, us in r.trace.kernels()
             if is_mask_launch(name)] if r.trace is not None else []
    if not bound or not times:
        return None
    return 100.0 * len(times) * bound / sum(times)
