"""feeding loop: ``runtime/executor._Prefetcher.__iter__`` — the program's
``decode_wait`` spans (the loop that feeds the card waiting on the prefetch
thread's decode) that start in the window, summed, over the frames it
dispatched there (its ``warp_dispatch`` spans), in ms."""


def read(r):
    try:
        from gs360x_torch.runtime.profiling import spans
    except ImportError:  # a program without the span ring
        return None
    held = [s for s in spans() if r.bench.start <= s[2] < r.bench.end]
    frames = sum(1 for s in held if s[0] == "warp_dispatch")
    waits = [s[3] - s[2] for s in held if s[0] == "decode_wait"]
    return sum(waits) / frames * 1e3 if frames and waits else None
