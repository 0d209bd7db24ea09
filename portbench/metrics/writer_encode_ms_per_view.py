"""encode: ``io/image.AsyncImageWriter``'s task — the program's ``encode``
spans around ``write_image`` in the writer threads that start in the
window, summed over the threads, over their number (a view each), in ms."""


def read(r):
    try:
        from gs360x_torch.runtime.profiling import spans
    except ImportError:  # a program without the span ring
        return None
    encodes = [s[3] - s[2] for s in spans()
               if s[0] == "encode" and r.bench.start <= s[2] < r.bench.end]
    return sum(encodes) / len(encodes) * 1e3 if encodes else None
