"""encode: ``io/image.AsyncImageWriter``'s task for a mask — the program's
``mask_encode`` spans around ``write_image`` in the writer threads that
start in the window, summed over the threads, over the pairs the loop
uploaded there (its ``upload`` spans), in ms."""


def read(r):
    try:
        from gs360x_torch.runtime.profiling import spans
    except ImportError:  # a program without the span ring
        return None
    held = [s for s in spans() if r.bench.start <= s[2] < r.bench.end]
    pairs = sum(1 for s in held if s[0] == "upload")
    encodes = [s[3] - s[2] for s in held if s[0] == "mask_encode"]
    return sum(encodes) / pairs * 1e3 if pairs and encodes else None
