"""Filesystem change watching — the sgl ``PathWatch`` analogue.

A copy of ``correrender_tpu/utils/pathwatch.py`` (no JAX there); the
catalog is parsed by the port's ``io/catalog.py``.

Reference: ``sgl::PathWatch`` watches the dataset catalog so edits to
``datasets.json`` hot-reload the dataset list while the app runs
(src/MainApp.hpp:162 ``datasetsWatch``; set up at MainApp.cpp:252-253,
polled each frame at MainApp.cpp:1762). The reference uses inotify on
Linux; this framework is headless/portable, so the watch is a cheap
stat-based poll — callers invoke :meth:`update` from their frame or
event loop exactly like the reference does.
"""

from __future__ import annotations

import os
from typing import Callable, Optional


def _signature(path: str):
    """(exists, mtime_ns, size) — what "the file changed" means here."""
    try:
        st = os.stat(path)
    except OSError:
        return (False, 0, 0)
    return (True, st.st_mtime_ns, st.st_size)


class PathWatch:
    """Poll-based single-path watch (sgl PathWatch role).

    >>> watch = PathWatch("datasets.json")
    >>> watch.update(lambda: print("changed"))   # each frame / tick
    """

    def __init__(self, path: Optional[str] = None):
        self._path: Optional[str] = None
        self._sig = (False, 0, 0)
        if path is not None:
            self.set_path(path)

    def set_path(self, path: str):
        """Bind the watch to ``path`` and snapshot its current state
        (MainApp.cpp:252 ``datasetsWatch.setPath`` + ``initialize``)."""
        self._path = str(path)
        self._sig = _signature(self._path)

    @property
    def path(self) -> Optional[str]:
        return self._path

    def update(self, callback: Optional[Callable[[], None]] = None) -> bool:
        """Return True (and run ``callback``) if the file changed —
        created, deleted, or rewritten — since the last call
        (MainApp.cpp:1762 ``datasetsWatch.update([this]{...})``)."""
        if self._path is None:
            return False
        sig = _signature(self._path)
        if sig == self._sig:
            return False
        self._sig = sig
        if callback is not None:
            callback()
        return True


class CatalogWatch(PathWatch):
    """Watches a ``datasets.json`` catalog and reloads it on change.

    :meth:`poll` returns the freshly parsed entry list when the file
    changed (or None when unchanged) — the viewer/CLI equivalent of the
    reference's hot dataset-list refresh (MainApp.cpp:1762-1770).
    """

    def poll(self):
        from correrender_tpu_torch.io.catalog import load_catalog

        changed = self.update()
        if not changed or self._path is None or not self._sig[0]:
            return None
        return load_catalog(self._path)
