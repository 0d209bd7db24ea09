"""video decode (io/video.MJPEGAVIReader): the share of video mode's frame
decodes that started in the window while another decode of the same
decode-ahead stage was running (the program counter
``executor.decode_overlap(start, end)``), in %: 0 where one thread decodes
the clip; None where nothing was decoded or the program keeps no such
counter."""


def read(r):
    try:
        from gs360x_torch.runtime.executor import decode_overlap
    except ImportError:  # a program without the counter
        return None
    counts = decode_overlap(r.bench.start, r.bench.end)
    if not counts["decodes"]:
        return None
    return 100.0 * counts["overlapped"] / counts["decodes"]
