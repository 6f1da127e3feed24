"""Build and load the port's host-side C++ libraries with g++.

The port's counterpart of ``correrender_tpu/native/__init__.py``'s
loader. A source is compiled by ``g++ -O3 -march=native -std=c++17`` at
first use into a directory under ``build/`` at the root of the checkout.
The library's name holds a hash of the source, the flags and the host's
CPU model, so a library built for another machine (``-march=native``) is
never loaded. The build writes a process-unique temporary file and
renames it into place, so processes building at once (pytest-xdist
workers) never load a half-written library. There is no quiet fallback:
a missing ``g++`` or a failed build raises.
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

BUILD_ROOT = Path(__file__).resolve().parents[1] / "build"
FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]


def _host() -> str:
    """The CPU model the library is built for (``-march=native``)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    return line
    except OSError:
        pass
    return platform.machine() + platform.processor()


def library_path(source: Path, build_dir: Path) -> Path:
    """Where :func:`build_library` puts ``source``'s library."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(_host().encode())
    return build_dir / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def build_library(source: Path, build_dir: Path, what: str) -> Path:
    """Compile ``source`` into ``build_dir`` if needed; return the
    library's path. ``what`` names the library in errors."""
    lib = library_path(source, build_dir)
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {what} cannot be built")
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)
    return lib
