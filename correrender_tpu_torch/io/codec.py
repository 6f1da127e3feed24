"""Build and load the native bit-unpack codec of the GRIB2 decoder.

``io_codec.cpp`` (a copy of ``correrender_tpu/native/io_codec.cpp``) is
compiled by ``g++ -O3 -march=native`` at first use into ``build/codec/``
at the root of the checkout, and bound with ``ctypes``. The library's
name holds a hash of the source, the flags and the host's CPU model, so
a library built for another machine (``-march=native``) is never
loaded. The build writes a process-unique temporary file and renames it
into place, so processes building at once (pytest-xdist workers) never
load a half-written library.

There is no quiet fallback: a missing ``g++`` or a failed build raises.
The numpy unpack in ``io/grib.py`` is the codec's plain version, which
the tests hold it to.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

_SOURCE = Path(__file__).resolve().parent / "io_codec.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "codec"
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

#: Calls into the library (``unpack_bits_u64`` and ``unpack_groups_u64``)
#: since the process started: a run can show which decoder it used.
CALLS = {"unpack_bits": 0, "unpack_groups": 0}


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


def _library_path() -> Path:
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    h.update(_host().encode())
    return _BUILD_DIR / f"libio_codec_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the codec if needed; return the library's path."""
    lib = _library_path()
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the GRIB2 codec cannot be built")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *_FLAGS, "-o", str(tmp), str(_SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded codec (built on first use)."""
    dll = ctypes.CDLL(str(build()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    dll.unpack_bits_u64.restype = None
    dll.unpack_bits_u64.argtypes = [u8p, ctypes.c_int64, ctypes.c_int,
                                    ctypes.c_int64, i64p]
    dll.unpack_groups_u64.restype = ctypes.c_int64
    dll.unpack_groups_u64.argtypes = [u8p, ctypes.c_int64, i64p, i64p, i64p,
                                      ctypes.c_int64, i64p]
    return dll
