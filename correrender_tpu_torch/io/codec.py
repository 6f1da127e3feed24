"""Build and load the native bit-unpack codec of the GRIB2 decoder.

``io_codec.cpp`` (a copy of ``correrender_tpu/native/io_codec.cpp``) is
compiled by ``native.build_library`` (``g++ -O3 -march=native`` at first
use, into ``build/codec/`` at the root of the checkout, keyed by a hash
of the source, the flags and the host) and bound with ``ctypes``.

There is no quiet fallback: a missing ``g++`` or a failed build raises.
The numpy unpack in ``io/grib.py`` is the codec's plain version, which
the tests hold it to.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from correrender_tpu_torch.native import BUILD_ROOT, build_library

_SOURCE = Path(__file__).resolve().parent / "io_codec.cpp"
_BUILD_DIR = BUILD_ROOT / "codec"

#: Calls into the library (``unpack_bits_u64`` and ``unpack_groups_u64``)
#: since the process started: a run can show which decoder it used.
CALLS = {"unpack_bits": 0, "unpack_groups": 0}


def build() -> Path:
    """Compile the codec if needed; return the library's path."""
    return build_library(_SOURCE, _BUILD_DIR, "the GRIB2 codec")


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
