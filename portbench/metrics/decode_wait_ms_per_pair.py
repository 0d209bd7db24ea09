"""feeding loop: ``tools/dualfisheye``'s pair loop around ``fut.result()``
— the program's ``decode_wait`` spans (the loop that feeds the card
waiting on the decode pool) that start in the window, summed, over the
pairs it uploaded there (its ``upload`` spans), in ms."""


def read(r):
    try:
        from gs360x_torch.runtime.profiling import spans
    except ImportError:  # a program without the span ring
        return None
    held = [s for s in spans() if r.bench.start <= s[2] < r.bench.end]
    pairs = sum(1 for s in held if s[0] == "upload")
    waits = [s[3] - s[2] for s in held if s[0] == "decode_wait"]
    return sum(waits) / pairs * 1e3 if pairs and waits else None
