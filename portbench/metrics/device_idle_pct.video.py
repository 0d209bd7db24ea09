"""device (perspcut video mode's window): the card's idle share, in %:
100 × (1 − the union of the device operations' intervals ÷ the window),
from the profiler's trace."""


def read(r):
    return None if r.trace is None else r.trace.idle_pct()
