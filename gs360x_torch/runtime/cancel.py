"""Interactive cancellation listener (reference
``gs360_FrameSelector.py:202-222``): a background thread that sets the
stop event when the user types ``q`` on a TTY. Complements the SIGINT
handler — long batch runs can be stopped without a control character."""

from __future__ import annotations

import sys
import threading
from typing import Optional


def start_cancel_listener(stop_event: threading.Event
                          ) -> Optional[threading.Thread]:
    """Watch stdin for a lone 'q' line; no-op when stdin isn't a TTY."""
    try:
        if not sys.stdin or not sys.stdin.isatty():
            return None
    except (AttributeError, ValueError):
        return None

    def _watch():
        try:
            while not stop_event.is_set():
                line = sys.stdin.readline()
                if not line:
                    break
                if line.strip().lower() == "q":
                    print("\nCancellation requested (q). "
                          "Finishing current tasks...")
                    stop_event.set()
                    break
        except Exception:
            pass

    thread = threading.Thread(target=_watch, name="cancel-listener",
                              daemon=True)
    thread.start()
    return thread
