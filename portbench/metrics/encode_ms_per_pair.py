"""encode: ``io/image.AsyncImageWriter`` — the harness's spans around
``write_image`` in the writer threads, summed over the threads, over the
pairs they wrote in the window (views ÷ views a pair), in ms."""


def read(r):
    total, views = r.spans.get("encode", (0.0, 0))
    per_pair = r.outcome.counts.get("views_per_pair", 0)
    return total / views * per_pair * 1e3 if views and per_pair else None
