"""The decode-ahead stage of every feeding loop of the port: perspcut's
image and video modes (:mod:`gs360x_torch.runtime.executor`),
Video2Frames and dualfisheye's pair loop. Host decode and IO of the next
items overlap the device work on the current one; :func:`decode_overlap`
counts the stage's decodes.
"""

from __future__ import annotations

import contextlib
import threading
import time
from operator import add
from typing import Callable, Dict, Optional

from gs360x_torch.runtime.profiling import WindowCounter

# every decode of every Prefetcher: (start, 1, overlapped, the width)
_DECODES = WindowCounter(decodes=add, overlapped=add, width=max)


def decode_overlap(start: Optional[float] = None,
                   end: Optional[float] = None) -> dict:
    """``{"decodes", "overlapped", "width"}``: the decodes of every
    :class:`Prefetcher` in this process (one an item; where the items'
    own ``next()`` decodes, as in Video2Frames and video mode on a Y4M or
    ffmpeg stream, the width is 1 and none overlaps), those that started
    while another decode of the same stage was running, and the widest
    stage that ran them (0: none);
    given ``start`` and ``end`` (``time.perf_counter``), only those of the
    newest 65536 that started in [start, end)."""
    return _DECODES.read(start, end)


class Prefetcher:
    """Decode ahead of the loop that feeds the card.

    ``width`` threads each take the next of ``items`` (any iterable) under
    one lock, then run ``decode`` on it outside the lock; where ``decode``
    is None, taking the item is the work (an iterator whose ``next()``
    decodes). Results are handed out in the order the items were taken; at
    most ``width + depth`` items are taken and not yet passed by the
    consumer, the one it holds included. An exception from ``next()`` or
    from ``decode`` reaches the consumer at its own item. Iteration ends
    once ``stop_event`` is set, also while the consumer waits; the threads
    then finish the item they are on and end, as they do once the consumer
    stops early. With ``timers``, each wait is a ``decode_wait`` stage.
    Each decode counts in :func:`decode_overlap`."""

    _DONE = object()
    _POLL_S = 0.25

    def __init__(self, items, stop_event, depth: int = 2, timers=None, *,
                 decode: Optional[Callable] = None, width: int = 1):
        self._items = iter(items)
        self._decode = decode if decode is not None else (lambda item: item)
        self._width = width
        self._stop = stop_event
        self._closed = threading.Event()
        self._timers = timers
        self._slots = threading.Semaphore(width + depth)
        self._take = threading.Lock()
        self._cond = threading.Condition()
        self._results: Dict[int, object] = {}
        self._taken = self._given = self._running = 0
        self._threads = [threading.Thread(target=self._work, daemon=True)
                         for _ in range(width)]
        for t in self._threads:
            t.start()

    def _halted(self) -> bool:
        return self._stop.is_set() or self._closed.is_set()

    def _work(self):
        """One thread: once a slot is free, take the next item under the
        take lock, decode it outside, file the result under its index."""
        while True:
            while not self._slots.acquire(timeout=self._POLL_S):
                if self._halted():
                    return
            with self._take:
                k = self._taken
                if self._halted():
                    self._slots.release()
                    return
                failure = None
                try:
                    item = next(self._items)
                except StopIteration:
                    self._file(k, self._DONE)
                    self._slots.release()
                    return
                except Exception as exc:  # surfaced on the consumer side
                    failure = exc
                self._taken += 1
            self._file(k, self._decoded(item) if failure is None else failure)

    def _decoded(self, item):
        """``decode(item)``, or the exception it raised, counted."""
        with self._cond:
            overlapped = self._running > 0
            self._running += 1
        _DECODES.add(time.perf_counter(), decodes=1, overlapped=overlapped,
                     width=self._width)
        try:
            return self._decode(item)
        except Exception as exc:  # surfaced on the consumer side
            return exc
        finally:
            with self._cond:
                self._running -= 1

    def _file(self, k: int, result) -> None:
        with self._cond:
            self._results[k] = result
            self._cond.notify_all()

    def _next_result(self):
        """The result of the next item in order (``_DONE`` past the last
        one, or once stopped)."""
        with self._cond:
            while self._given not in self._results:
                if self._stop.is_set():
                    return self._DONE
                self._cond.wait(self._POLL_S)
            self._given += 1
            return self._results.pop(self._given - 1)

    def __iter__(self):
        try:
            while True:
                with (contextlib.nullcontext() if self._timers is None
                      else self._timers.stage("decode_wait")):
                    item = self._next_result()
                if item is self._DONE:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
                self._slots.release()   # the consumer is past it
        finally:
            self._closed.set()
