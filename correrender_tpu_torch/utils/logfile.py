"""HTML logfile — the ``sgl::Logfile`` analogue.

A copy of ``correrender_tpu/utils/logfile.py`` (no JAX there): both
packages append to the same log in the same format.

Reference: sgl writes a colored HTML logfile to
``~/.config/correrender/Logfile.html`` (README.md:152-157; colored
writes e.g. src/Main.cpp:81-86), with ``writeInfo`` / ``writeWarning``
/ ``writeError`` severities and ``throwError`` (log + raise) vs
``writeError`` (log + continue) — the soft-vs-fatal split VolumeData
uses for load errors (VolumeData.cpp:1266-1268).

This module mirrors that: entries are appended + flushed immediately
(crash-robust), stderr mirroring is on for warnings/errors, and the
file lands in :func:`~correrender_tpu_torch.utils.app_settings.config_directory`.
"""

from __future__ import annotations

import datetime
import html
import os
import sys
import threading

_COLORS = {
    "info": "#2080ff",
    "warning": "#ffa000",
    "error": "#ff0000",
    "plain": "#000000",
}


class Logfile:
    """Append-only HTML log with severity colors (sgl::Logfile role)."""

    def __init__(self, path: str | None = None, mirror_stderr: bool = True):
        if path is None:
            from correrender_tpu_torch.utils.app_settings import config_directory

            path = os.path.join(config_directory(), "Logfile.html")
        self.path = path
        self.mirror_stderr = mirror_stderr
        self._lock = threading.Lock()
        self._opened = False

    def _ensure_header(self):
        if self._opened:
            return
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fresh = not os.path.exists(self.path)
        if fresh:
            with open(self.path, "w") as f:
                f.write(
                    "<html><head><title>correrender_tpu log</title>"
                    "</head><body><font face='courier new'>\n"
                )
        self._opened = True

    def _write(self, text: str, color: str, severity: str):
        stamp = datetime.datetime.now().strftime("%H:%M:%S")
        line = (
            f"<font color=\"{color}\">[{stamp}] "
            f"{html.escape(str(text))}</font><br>\n"
        )
        with self._lock:
            self._ensure_header()
            with open(self.path, "a") as f:
                f.write(line)
        if self.mirror_stderr and severity in ("warning", "error"):
            print(f"[{severity}] {text}", file=sys.stderr)

    # -- sgl::Logfile API ------------------------------------------------

    def write(self, text: str, color: str = _COLORS["plain"]):
        self._write(text, color, "plain")

    def write_info(self, text: str):
        self._write(text, _COLORS["info"], "info")

    def write_warning(self, text: str):
        self._write(text, _COLORS["warning"], "warning")

    def write_error(self, text: str):
        """Soft error: log + continue (sgl writeError)."""
        self._write(text, _COLORS["error"], "error")

    def throw_error(self, text: str, exc_type=RuntimeError):
        """Fatal error: log, then raise (sgl throwError)."""
        self._write(text, _COLORS["error"], "error")
        raise exc_type(text)


_instance: Logfile | None = None


def get_logfile() -> Logfile:
    """Process-wide singleton (sgl::Logfile::get())."""
    global _instance
    if _instance is None:
        _instance = Logfile()
    return _instance
