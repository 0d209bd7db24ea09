"""plain torch steps (core/color, quantize): video mode's colour move
(``core/color.video_color_move_planar``) and plain quantize
(``warp_cuda.quantize_plain``) — the device time of the window's kernels
outside the planarize and warp families, over the frames the window's
batches warped (``executor.video_frames_warped``), in ms; None where no
warp launch is in the trace (a CPU run)."""


def read(r):
    try:
        from gs360x_torch.runtime.executor import video_frames_warped
    except ImportError:  # a program without the counter
        return None
    if r.trace is None or not r.trace.family_us("warp"):
        return None
    frames = video_frames_warped(r.bench.start, r.bench.end)
    if not frames:
        return None
    return sum(r.trace.family_us("other")) / frames / 1e3
