"""decode: ``io/image.read_image`` on ``runtime/executor._Prefetcher``'s
thread — the thread's CPU seconds inside the program's ``decode`` spans
that start in the window over the spans' wall seconds, in %: under 100 the
decode waits for a core (or on I/O)."""


def read(r):
    try:
        from gs360x_torch.runtime.profiling import spans
    except ImportError:  # a program without the span ring
        return None
    held = [s for s in spans()
            if s[0] == "decode" and r.bench.start <= s[2] < r.bench.end]
    wall = sum(s[3] - s[2] for s in held)
    return 100.0 * sum(s[4] for s in held) / wall if wall > 0 else None
