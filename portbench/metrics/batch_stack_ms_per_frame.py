"""upload + dispatch (runtime/executor): ``_warp_frames_batch``'s
``batch_stack`` spans (``np.stack`` of a batch's decoded frames and the
mesh's pad) that start in the window, summed, over the frames the window's
batches warped (``executor.video_frames_warped``), in ms."""


def read(r):
    try:
        from gs360x_torch.runtime.executor import video_frames_warped
        from gs360x_torch.runtime.profiling import spans
    except ImportError:  # a program without the spans or the counter
        return None
    frames = video_frames_warped(r.bench.start, r.bench.end)
    held = [s[3] - s[2] for s in spans()
            if s[0] == "batch_stack" and r.bench.start <= s[2] < r.bench.end]
    return sum(held) / frames * 1e3 if frames and held else None
