"""kernel: ``csrc/warp_equirect.cu`` via ``runtime/mesh`` — the least time
of the window's batched ``warp_equirect_kernel`` launches
(``video_work.mesh_warp_frame``: each frame through every view, its source
texels and the f32 store, counted from the configuration's shapes) over
their summed device time, in %: the frames the window's batches warped
(``executor.video_frames_warped``) times a frame's least time."""


def read(r):
    bound = r.outcome.work.get("mesh_warp", {}).get("frame_us")
    times = r.trace.family_us("warp") if r.trace is not None else []
    if not bound or not times:
        return None
    try:
        from gs360x_torch.runtime.executor import video_frames_warped
    except ImportError:  # a program without the counter
        return None
    frames = video_frames_warped(r.bench.start, r.bench.end)
    return 100.0 * frames * bound / sum(times) if frames else None
