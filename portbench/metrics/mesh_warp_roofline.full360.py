"""kernel: ``csrc/warp_equirect.cu`` via ``runtime/mesh``, carrying the
pitched and pole view classes — the least time of the window's batched
``warp_equirect_kernel`` launches over their summed device time, in %. The
least time is a frame's (``video_work.mesh_warp_frame`` over the
configuration's 14 views: the distinct source texels under the taps, a
pole view's counted once, and the f32 store) times the frames' worth of
view-frames the window's warps carried (``executor.view_counts(start,
end)`` ÷ 14): a program that warped fewer views than planned reads lower,
never higher. None without a trace, a warp launch or the counter."""

LAYOUT_VIEWS = 14   # full360coverage's 12 views, --add-top, --add-bottom


def read(r):
    bound = r.outcome.work.get("mesh_warp", {}).get("frame_us")
    times = r.trace.family_us("warp") if r.trace is not None else []
    if not bound or not times:
        return None
    try:
        from gs360x_torch.runtime.executor import view_counts
    except ImportError:  # a program without the counter
        return None
    views = view_counts(r.bench.start, r.bench.end)["views"]
    if not views:
        return None
    return 100.0 * views / LAYOUT_VIEWS * bound / sum(times)
