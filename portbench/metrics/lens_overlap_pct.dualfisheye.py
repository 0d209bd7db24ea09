"""decode (io/image.read_image): the share of ``tools/dualfisheye``'s pair
decodes that started in the window whose two lens decodes (each lens
image with its mask) ran at the same time for a while (the program
counter ``dualfisheye.lens_overlap(start, end)``), in %; None where no
pair was decoded or the program keeps no such counter."""


def read(r):
    try:
        from gs360x_torch.tools.dualfisheye import lens_overlap
    except ImportError:  # a program without the counter
        return None
    counts = lens_overlap(r.bench.start, r.bench.end)
    if not counts["pairs"]:
        return None
    return 100.0 * counts["overlapped"] / counts["pairs"]
