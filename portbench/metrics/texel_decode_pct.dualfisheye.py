"""decode: ``io/image.read_image(..., texels=True)`` in
``tools/dualfisheye``'s decode pool (both lenses, asked for without a
LUT) — the share of the texel requests that started in the window that
came back as Pillow's own RGBX block (the rest took the packed RGB
decode), in %; None where nothing asked for texels or the program keeps no
such counter."""


def read(r):
    try:
        from gs360x_torch.io.image import texel_decode_counts
    except ImportError:  # a program without the counter
        return None
    counts = texel_decode_counts(r.bench.start, r.bench.end)
    if not counts["requested"]:
        return None
    return 100.0 * counts["served"] / counts["requested"]
