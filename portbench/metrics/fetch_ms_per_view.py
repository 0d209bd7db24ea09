"""fetch: ``runtime/executor._ViewFetcher`` — the program's ``fetch``
timer over the views written in the window, in ms."""


def read(r):
    views = r.outcome.counts.get("views", 0)
    if not views or "fetch" not in r.outcome.stage_seconds:
        return None
    return r.outcome.stage_seconds["fetch"] / views * 1e3
