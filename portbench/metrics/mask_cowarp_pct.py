"""decode: ``tools/dualfisheye.find_mask`` — the share of the lens images
whose mask was looked for in the window (``--mask-input-dir``) that had
one, by the program's counter ``dualfisheye.mask_counts(start, end)``, in
%; None where nothing was looked for or the program keeps no such
counter."""


def read(r):
    try:
        from gs360x_torch.tools.dualfisheye import mask_counts
    except ImportError:  # a program without the counter
        return None
    counts = mask_counts(r.bench.start, r.bench.end)
    if not counts["looked_up"]:
        return None
    return 100.0 * counts["found"] / counts["looked_up"]
