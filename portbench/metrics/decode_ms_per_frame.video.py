"""video decode (io/video.MJPEGAVIReader): the program's ``decode`` spans
around each ``next()`` of the frame iterator on the prefetch thread (a
JPEG decoded by Pillow and packed to RGB) that start in the window, less
the ``video_open`` span nested in the first of them (the iterator opens
the clip), over the frames the window's batches warped
(``executor.video_frames_warped``), in ms."""


def read(r):
    try:
        from gs360x_torch.runtime.executor import video_frames_warped
        from gs360x_torch.runtime.profiling import spans
    except ImportError:  # a program without the spans or the counter
        return None
    held = [s for s in spans() if r.bench.start <= s[2] < r.bench.end]
    decodes = [s for s in held if s[0] == "decode"]
    nested = [o for o in held if o[0] == "video_open" and any(
        d[1] == o[1] and d[2] <= o[2] and o[3] <= d[3] for d in decodes)]
    frames = video_frames_warped(r.bench.start, r.bench.end)
    if not frames or not decodes:
        return None
    total = sum(s[3] - s[2] for s in decodes) - sum(
        o[3] - o[2] for o in nested)
    return total / frames * 1e3
