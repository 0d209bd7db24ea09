"""device (perspcut's window): the share of the card's idle time during
which the loop that feeds it waits on a decode, in %: 100 × the device-idle
µs inside the program's ``decode_wait`` spans that start in the window ÷
the device-idle µs, the spans laid on the profiler's trace by the window
annotation's anchor."""


def read(r):
    try:
        from gs360x_torch.runtime.profiling import spans
    except ImportError:  # a program without the span ring
        return None
    from portbench.trace import union
    if r.trace is None:
        return None

    def trace_us(t):
        return r.trace.start + (t - r.bench.anchor) * 1e6
    waits = [(trace_us(s[2]), trace_us(s[3])) for s in spans()
             if s[0] == "decode_wait" and r.bench.start <= s[2] < r.bench.end]
    idle = sum(b - a for a, b in r.trace.gaps)
    if not waits or idle <= 0:
        return None
    return 100.0 * sum(union(waits, a, b)[0] for a, b in r.trace.gaps) / idle
