"""Build and load the port's host-side C++ libraries with g++.

The port's counterpart of ``correrender_tpu/native/__init__.py``: its
loader, and the CPU baseline (``cpu_baseline.cpp``, an OpenMP copy of
the JAX package's) with :func:`cpu_baseline`, :func:`pearson_field_cpu`
and :func:`ksg_field_cpu`. A source is compiled by ``g++ -O3
-march=native -std=c++17`` and a caller's extra flags at first use into a
directory under ``build/`` at the root of the checkout. The library's
name holds a hash of the source, the flags and the host's CPU model, so
a library built for another machine (``-march=native``) or with other
flags is never loaded. The build writes a process-unique temporary file and
renames it into place, so processes building at once (pytest-xdist
workers) never load a half-written library. There is no quiet fallback:
a missing ``g++`` or a failed build raises.
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

import numpy as np

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


def library_path(source: Path, build_dir: Path, extra_flags=()) -> Path:
    """Where :func:`build_library` puts ``source``'s library."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join([*FLAGS, *extra_flags]).encode())
    h.update(_host().encode())
    return build_dir / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def build_library(source: Path, build_dir: Path, what: str,
                  extra_flags=()) -> Path:
    """Compile ``source`` into ``build_dir`` if needed, with ``g++``'s
    :data:`FLAGS` and ``extra_flags``; return the library's path.
    ``what`` names the library in errors."""
    lib = library_path(source, build_dir, extra_flags)
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {what} cannot be built")
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *FLAGS, *extra_flags, "-o", str(tmp),
                           str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)
    return lib


_BASELINE_SOURCE = Path(__file__).with_name("cpu_baseline.cpp")
_F32P = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=None)
def cpu_baseline() -> ctypes.CDLL:
    """The CPU baseline library (``cpu_baseline.cpp``), built with
    ``-fopenmp`` into ``build/cpu_baseline/`` at first use.

    Its voxel loops run in parallel like the reference's CPU path
    (CorrelationCalculator.cpp:878-1100): ``pearson_throughput_cpu_t``
    measures the single-core (``threads=1``) and the all-core
    (``threads=0``) voxels/s, ``ksg_throughput_cpu`` the KSG's,
    ``ddr_bandwidth_gbs`` the host's memory rate and ``cpu_core_count``
    its hardware threads; ``pearson_field_cpu`` and ``ksg_field_cpu``
    compute fields of member-major series. The argument types are the
    JAX package's (``native/__init__.py:52-84``).
    """
    dll = ctypes.CDLL(str(build_library(
        _BASELINE_SOURCE, BUILD_ROOT / "cpu_baseline", "the CPU baseline",
        extra_flags=("-fopenmp",))))
    i64, c_int = ctypes.c_int64, ctypes.c_int
    for entry, restype, argtypes in (
        ("pearson_throughput_cpu", ctypes.c_double, [i64, c_int]),
        ("pearson_throughput_cpu_t", ctypes.c_double, [i64, c_int, c_int]),
        ("cpu_core_count", c_int, []),
        ("ddr_bandwidth_gbs", ctypes.c_double, [i64, c_int]),
        ("pearson_field_cpu", None, [_F32P, _F32P, i64, c_int, _F32P]),
        ("ksg_throughput_cpu", ctypes.c_double, [i64, c_int, c_int, c_int]),
        ("ksg_field_cpu", None,
         [_F32P, _F32P, i64, c_int, c_int, c_int, _F32P]),
    ):
        fn = getattr(dll, entry)
        fn.restype, fn.argtypes = restype, argtypes
    return dll


def _field_cpu(entry: str, reference, fields, *args) -> np.ndarray:
    """Run the baseline's field ``entry`` on ``fields`` ``(members,
    voxels)``, member-major, against ``reference`` ``(members,)``."""
    reference = np.ascontiguousarray(reference, np.float32)
    fields = np.ascontiguousarray(fields, np.float32)
    es, num_voxels = fields.shape
    if reference.shape != (es,):
        raise ValueError(f"reference of shape {reference.shape} for "
                         f"{es} members")
    out = np.empty(num_voxels, np.float32)
    getattr(cpu_baseline(), entry)(
        reference.ctypes.data_as(_F32P), fields.ctypes.data_as(_F32P),
        num_voxels, es, *args, out.ctypes.data_as(_F32P))
    return out


def pearson_field_cpu(reference, fields) -> np.ndarray:
    """Pearson r of every voxel series of ``fields`` ``(members,
    voxels)`` against ``reference``, on every core of the host (sums in
    double)."""
    return _field_cpu("pearson_field_cpu", reference, fields)


def ksg_field_cpu(reference, fields, k: int = 3,
                  estimator: int = 1) -> np.ndarray:
    """KSG mutual information of every voxel series of ``fields``
    ``(members, voxels)`` against ``reference``, without noise: a k-d
    tree's (k + 1) nearest neighbours under the Chebyshev metric, then
    binary searches in the sorted marginals (JAX's
    ``native.ksg_field_cpu``)."""
    return _field_cpu("ksg_field_cpu", reference, fields, k, estimator)
