"""The reader of ``lens_overlap_pct.dualfisheye``: the share of the pairs
whose decode started in the window that decoded their two lenses at once,
from the program's counter ``dualfisheye.lens_overlap(start, end)``; None
against a program without the counter or with no pair in the window."""

from operator import add
from types import SimpleNamespace

from portbench import harness

NAME = "lens_overlap_pct.dualfisheye"


def _read(start, end):
    reader = harness.load_module(harness.HERE / "metrics" / f"{NAME}.py")
    return reader.read(SimpleNamespace(bench=SimpleNamespace(start=start,
                                                             end=end)))


def test_reads_the_share_of_the_window(monkeypatch):
    from gs360x_torch.runtime.profiling import WindowCounter
    from gs360x_torch.tools import dualfisheye
    counter = WindowCounter(pairs=add, overlapped=add)
    # (start, overlapped): one pair before the window, four in it, one at
    # its end (outside: the window is [start, end))
    for t, overlapped in ((99.5, False), (100.0, True), (100.2, True),
                          (100.4, False), (100.9, True), (101.0, False)):
        counter.add(t, pairs=1, overlapped=overlapped)
    monkeypatch.setattr(dualfisheye, "lens_overlap", counter.read)
    assert _read(100.0, 101.0) == 75.0
    assert _read(99.0, 100.0) == 0.0
    assert _read(102.0, 103.0) is None


def test_none_without_the_counter(monkeypatch):
    from gs360x_torch.tools import dualfisheye
    monkeypatch.delattr(dualfisheye, "lens_overlap")
    assert _read(100.0, 101.0) is None
