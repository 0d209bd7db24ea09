"""feeding loop: ``io/image.AsyncImageWriter.submit`` — the program's
``writer_block`` spans (the loop blocked until one of the writer's pending
slots frees) that start in the window, summed, over the frames it
dispatched there (its ``warp_dispatch`` spans), in ms."""


def read(r):
    try:
        from gs360x_torch.runtime.profiling import spans
    except ImportError:  # a program without the span ring
        return None
    held = [s for s in spans() if r.bench.start <= s[2] < r.bench.end]
    frames = sum(1 for s in held if s[0] == "warp_dispatch")
    blocks = [s[3] - s[2] for s in held if s[0] == "writer_block"]
    return sum(blocks) / frames * 1e3 if frames and blocks else None
