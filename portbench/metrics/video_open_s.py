"""video decode (io/video.MJPEGAVIReader): the program's ``video_open``
spans (the whole clip read into memory, then its index scanned) that start
in the window, summed, in s: ``_run_video``'s probe and the frame
iterator's open, both inside ``run_plan``. The program's open counter
(``io/video.open_counts``) gives their bytes on ``[STATS]``."""


def read(r):
    try:
        from gs360x_torch.runtime.profiling import spans
    except ImportError:  # a program without the span ring
        return None
    opens = [s[3] - s[2] for s in spans()
             if s[0] == "video_open" and r.bench.start <= s[2] < r.bench.end]
    return sum(opens) if opens else None
