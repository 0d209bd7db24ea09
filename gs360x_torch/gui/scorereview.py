"""FrameSelector score-review session: chart render + keep/drop edits.

Rebuilds the reference GUI's score-review tool (``gs360_GUI.py:
15809-17790``): a per-frame score bar chart with log scale
and zoom, "suspect" navigation (dark or low-score frames), manual
keep/drop toggles, and confirm→apply back through the FrameSelector CSV
contract. All state and rendering are pure numpy (headless-testable);
the Tk tab only blits the chart image and forwards key events.
"""

from __future__ import annotations

import csv
import pathlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from gs360x_torch.kernels.sharpness import HYBRID_DARK_THRESHOLD

# reference score-review visual constants (gs360_GUI.py:15809-15900)
LOW_SCORE_PERCENTILE = 10.0
COLOR_BG = (24, 24, 28)
COLOR_KEEP = (90, 200, 120)
COLOR_DROP = (90, 90, 100)
COLOR_CURSOR = (255, 214, 64)
COLOR_SUSPECT = (255, 82, 82)
COLOR_AXIS = (140, 140, 150)


@dataclass
class ScoreEntry:
    index: int
    filename: str
    score: float
    brightness: float
    group_score: float
    flow: float
    keep: bool
    raw: Dict[str, str] = field(default_factory=dict)


class ReviewSession:
    """Editable view over a FrameSelector selection CSV.

    Loads every row (preserving unknown columns verbatim in ``raw``),
    exposes zoom/cursor/suspect navigation and keep/drop toggles, and
    writes the CSV back with only the ``selected(1=keep)`` column
    changed — so ``frameselector --apply_csv`` replays the edit.
    """

    def __init__(self, entries: List[ScoreEntry],
                 fieldnames: Optional[List[str]] = None):
        self.entries = entries
        self.fieldnames = fieldnames or list(
            entries[0].raw.keys()) if entries else []
        self.cursor = 0
        self.view_start = 0
        self.view_count = max(1, len(entries))
        self.log_scale = False

    # ---- IO ---------------------------------------------------------------

    @classmethod
    def load(cls, path) -> "ReviewSession":
        entries: List[ScoreEntry] = []
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            if reader.fieldnames is None or \
                    "filename" not in reader.fieldnames:
                raise ValueError("CSV missing header/filename column")
            for i, row in enumerate(reader):
                def num(key, default=0.0):
                    try:
                        return float(row.get(key, "") or default)
                    except ValueError:
                        return default
                entries.append(ScoreEntry(
                    index=i, filename=row.get("filename", ""),
                    score=num("score", -1.0), brightness=num("brightness_mean"),
                    group_score=num("group_score"), flow=num("flow_motion"),
                    keep=row.get("selected(1=keep)", "0").strip() == "1",
                    raw=dict(row)))
            return cls(entries, list(reader.fieldnames))

    def save(self, path) -> None:
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.fieldnames)
            w.writeheader()
            for e in self.entries:
                row = dict(e.raw)
                row["selected(1=keep)"] = "1" if e.keep else "0"
                w.writerow(row)

    # ---- edits ------------------------------------------------------------

    def toggle(self, i: Optional[int] = None) -> bool:
        i = self.cursor if i is None else i
        self.entries[i].keep = not self.entries[i].keep
        return self.entries[i].keep

    def kept_count(self) -> int:
        return sum(1 for e in self.entries if e.keep)

    # ---- navigation -------------------------------------------------------

    def move(self, delta: int) -> int:
        self.cursor = int(np.clip(self.cursor + delta, 0,
                                  max(0, len(self.entries) - 1)))
        self._follow_cursor()
        return self.cursor

    def zoom(self, factor: float) -> None:
        """Zoom the visible window around the cursor (factor<1 zooms in)."""
        n = len(self.entries)
        count = int(np.clip(round(self.view_count * factor), 8, max(8, n)))
        start = self.cursor - count // 2
        self.view_start = int(np.clip(start, 0, max(0, n - count)))
        self.view_count = min(count, n) if n else 1

    def pan(self, delta: int) -> None:
        n = len(self.entries)
        self.view_start = int(np.clip(self.view_start + delta, 0,
                                      max(0, n - self.view_count)))

    def _follow_cursor(self) -> None:
        if self.cursor < self.view_start:
            self.view_start = self.cursor
        elif self.cursor >= self.view_start + self.view_count:
            self.view_start = self.cursor - self.view_count + 1

    # ---- suspects ---------------------------------------------------------

    def suspects(self) -> List[int]:
        """Frames worth reviewing: dark (below the hybrid-metric dark
        threshold) or in the bottom score percentile (reference
        ``gs360_GUI.py:16498-16590``)."""
        scores = np.array([e.score for e in self.entries if e.score >= 0])
        low = (np.percentile(scores, LOW_SCORE_PERCENTILE)
               if len(scores) else 0.0)
        return [e.index for e in self.entries
                if e.brightness < HYBRID_DARK_THRESHOLD
                or (0 <= e.score <= low)]

    def next_suspect(self, backwards: bool = False) -> Optional[int]:
        sus = self.suspects()
        if not sus:
            return None
        if backwards:
            prior = [i for i in sus if i < self.cursor]
            self.cursor = prior[-1] if prior else sus[-1]
        else:
            later = [i for i in sus if i > self.cursor]
            self.cursor = later[0] if later else sus[0]
        self._follow_cursor()
        return self.cursor


def render_chart(session: ReviewSession, width: int, height: int,
                 *, margin: int = 18) -> np.ndarray:
    """Render the visible window as an (H, W, 3) uint8 bar chart.

    Kept frames draw in green, dropped in gray, the cursor bar in
    yellow; suspect frames get a red marker row along the top.
    """
    img = np.empty((height, width, 3), np.uint8)
    img[:] = COLOR_BG
    entries = session.entries
    if not entries:
        return img

    lo = session.view_start
    hi = min(len(entries), lo + session.view_count)
    view = entries[lo:hi]
    scores = np.array([max(e.score, 0.0) for e in view], np.float64)
    if session.log_scale:
        scores = np.log10(scores + 1.0)
    top = float(scores.max()) or 1.0

    plot_h = height - 2 * margin
    plot_w = width - 2 * margin
    n = len(view)
    suspects = set(session.suspects())

    # axis baseline
    img[height - margin, margin:width - margin] = COLOR_AXIS
    for k, e in enumerate(view):
        x0 = margin + (k * plot_w) // n
        x1 = margin + ((k + 1) * plot_w) // n
        x1 = max(x1, x0 + 1)
        bar_h = int(round(scores[k] / top * (plot_h - 6)))
        color = COLOR_CURSOR if e.index == session.cursor else \
            (COLOR_KEEP if e.keep else COLOR_DROP)
        y0 = height - margin - max(bar_h, 1)
        img[y0:height - margin, x0:x1] = color
        if e.index in suspects:
            img[margin // 2:margin // 2 + 4, x0:x1] = COLOR_SUSPECT
    return img


def summary_line(session: ReviewSession) -> str:
    e = session.entries[session.cursor] if session.entries else None
    head = (f"frame {e.index} {e.filename}  score={e.score:.2f}  "
            f"bright={e.brightness:.1f}  flow={e.flow:.2f}  "
            f"{'KEEP' if e.keep else 'drop'}  |  " if e else "")
    return (head + f"kept {session.kept_count()}/{len(session.entries)}  "
            f"suspects {len(session.suspects())}")


def apply_argv(csv_path, in_dir) -> List[str]:
    """Argv for replaying an edited CSV through the FrameSelector CLI
    (moves dropped frames to ``blur/`` — the confirm→apply step)."""
    return ["-i", str(pathlib.Path(in_dir)), "--apply_csv",
            str(pathlib.Path(csv_path))]


def frame_thumbnail(session: ReviewSession, in_dir, max_edge: int = 320):
    """Cursor frame's image as a thumbnail array (the reference review
    window shows the frame beside the chart, gs360_GUI.py:15809-17790).

    Returns ``(thumb_u8 | None, caption)``; pair-mode rows fall back to
    the X-lens filename. Pure numpy decimation — no Tk here.
    """
    if not session.entries:
        return None, "no entries"
    e = session.entries[session.cursor]
    base = pathlib.Path(in_dir)
    names = [e.filename, e.raw.get("x_filename", ""),
             e.raw.get("y_filename", "")]
    path = next((base / n for n in names if n and (base / n).exists()),
                None)
    if path is None:
        return None, f"{e.filename}: file not found"
    try:
        from gs360x_torch.io.image import read_image, to_float01

        rgb = read_image(path)
        if rgb.dtype != np.uint8:
            rgb = (to_float01(rgb) * 255).astype(np.uint8)
    except Exception as exc:
        return None, f"{e.filename}: {exc}"
    h, w = rgb.shape[:2]
    step = max(1, int(np.ceil(max(h, w) / float(max_edge))))
    thumb = rgb[::step, ::step]
    return thumb, f"{path.name}  {w}x{h}"


def zoom_label(session: ReviewSession) -> str:
    pct = 100.0 * session.view_count / max(1, len(session.entries))
    return f"view {session.view_start}..{session.view_start + session.view_count - 1} ({pct:.0f}%)"


__all__ = ["ReviewSession", "ScoreEntry", "render_chart", "summary_line",
           "apply_argv", "zoom_label", "frame_thumbnail",
           "LOW_SCORE_PERCENTILE"]
