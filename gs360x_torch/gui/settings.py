"""GUI settings persistence (JSON), mirroring the reference's
``gs360_gui_settings.json`` policy (``gs360_GUI.py:50, 1333-1371``)."""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict

DEFAULT_PATH = pathlib.Path.home() / ".gs360x" / "gui_settings.json"


class Settings:
    def __init__(self, path=None):
        self.path = pathlib.Path(path) if path else DEFAULT_PATH
        self._data: Dict[str, Any] = {}
        self.load()

    def load(self) -> None:
        try:
            self._data = json.loads(self.path.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            self._data = {}

    def save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(self._data, indent=2),
                             encoding="utf-8")

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def set(self, key: str, value: Any) -> None:
        self._data[key] = value

    def update_tab(self, tab: str, values: Dict[str, Any]) -> None:
        tabs = self._data.setdefault("tabs", {})
        tabs[tab] = values

    def tab(self, tab: str) -> Dict[str, Any]:
        return dict(self._data.get("tabs", {}).get(tab, {}))
