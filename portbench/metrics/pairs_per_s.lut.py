"""the pair loop (the LUT cell): ``pairs_per_s`` as the driver measures it
on the host's clock, views written inside the window over 10 over the
window. The host's speed moves it by some tenths from run to run, so in
this cell it is read here and bounds nothing."""


def read(r):
    return r.outcome.e2e.get("pairs_per_s")
