"""feeding loop: ``io/image.AsyncImageWriter.submit`` from
``tools/dualfisheye``'s pair loop — the program's ``writer_block`` spans
(the loop blocked until one of the writer's pending slots frees) that
start in the window, summed, over the pairs it uploaded there (its
``upload`` spans), in ms."""


def read(r):
    try:
        from gs360x_torch.runtime.profiling import spans
    except ImportError:  # a program without the span ring
        return None
    held = [s for s in spans() if r.bench.start <= s[2] < r.bench.end]
    pairs = sum(1 for s in held if s[0] == "upload")
    blocks = [s[3] - s[2] for s in held if s[0] == "writer_block"]
    return sum(blocks) / pairs * 1e3 if pairs and blocks else None
