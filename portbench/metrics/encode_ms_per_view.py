"""encode: ``io/image.AsyncImageWriter`` — the harness's spans around
``write_image`` in the writer threads, summed over the threads, over the
views they wrote in the window, in ms."""


def read(r):
    total, views = r.spans.get("encode", (0.0, 0))
    return total / views * 1e3 if views else None
