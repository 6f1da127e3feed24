"""Persistent application settings — the sgl ``AppSettings`` analogue.

A copy of ``correrender_tpu/utils/app_settings.py`` (no JAX there): both
packages read and write the same file.

Reference: ``sgl::AppSettings`` loads/saves a key-value ``settings.txt``
in the per-user config directory (src/Main.cpp:162-195 — window size,
vsync, dock-space mode, ...). This framework keeps the same contract
with a JSON file: string keys, JSON-scalar values, loaded once at
startup and saved explicitly (or via context-manager exit).

The config directory is ``$CORRERENDER_CONFIG_DIR`` if set, else
``~/.config/correrender_tpu`` (the reference uses
``~/.config/correrender``; a distinct directory avoids clobbering a
reference install on the same machine).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any


def config_directory() -> str:
    """Per-user config dir (sgl FileUtils::getConfigDirectory role)."""
    base = os.environ.get("CORRERENDER_CONFIG_DIR")
    if not base:
        base = os.path.join(
            os.path.expanduser("~"), ".config", "correrender_tpu"
        )
    os.makedirs(base, exist_ok=True)
    return base


class AppSettings:
    """JSON-backed settings map (Main.cpp:160-195 addKeyValue/getValueOpt).

    >>> s = AppSettings()           # loads <config>/settings.json
    >>> s.get("window-vSync", True)
    >>> s.set("window-width", 1920)
    >>> s.save()
    """

    FILENAME = "settings.json"

    def __init__(self, path: str | None = None):
        self.path = path or os.path.join(config_directory(), self.FILENAME)
        self._map: dict[str, Any] = {}
        self.load()

    def load(self):
        try:
            with open(self.path) as f:
                doc = json.load(f)
            if isinstance(doc, dict):
                self._map = doc
        except (OSError, ValueError):
            self._map = {}

    def save(self):
        # Atomic write: a crash mid-save must not corrupt the settings
        # (the reference rewrites settings.txt on clean shutdown only).
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._map, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- map API (sgl SettingsMap addKeyValue / getValueOpt) -------------

    def get(self, key: str, default: Any = None) -> Any:
        return self._map.get(key, default)

    def set(self, key: str, value: Any):
        self._map[key] = value

    def setdefault(self, key: str, value: Any) -> Any:
        return self._map.setdefault(key, value)

    def __contains__(self, key: str) -> bool:
        return key in self._map

    def as_dict(self) -> dict:
        return dict(self._map)


_instance: AppSettings | None = None


def get_app_settings() -> AppSettings:
    """Process-wide singleton (sgl AppSettings::get())."""
    global _instance
    if _instance is None:
        _instance = AppSettings()
    return _instance
