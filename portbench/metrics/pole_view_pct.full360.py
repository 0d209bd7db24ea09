"""kernel: ``csrc/warp_equirect.cu`` — the share of the view-frames the
window's warps carried whose frustum holds a pole (``executor.holds_pole``:
the taps there reflect over the pole onto the opposite meridian), by the
program's counter ``executor.view_counts(start, end)``, in %: 14.29 where
every frame goes through ``full360coverage --add-top --add-bottom`` (2 of
14 views); None where nothing was warped or the program keeps no such
counter."""


def read(r):
    try:
        from gs360x_torch.runtime.executor import view_counts
    except ImportError:  # a program without the counter
        return None
    counts = view_counts(r.bench.start, r.bench.end)
    if not counts["views"]:
        return None
    return 100.0 * counts["pole"] / counts["views"]
