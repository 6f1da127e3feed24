"""Build, load and count the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ONE ``nvcc`` call for ``sm_90a``
into a shared library with a plain C interface, at first use, under
``build/kernels/`` at the root of the checkout. The library name holds
a hash of the sources, so an edited kernel is rebuilt and a stale one is
never loaded. The library is bound with ``ctypes``; every C entry takes
the launching stream and returns ``cudaGetLastError()``, which
:func:`check` turns into an exception.

``LAUNCHES`` holds one launch counter per kernel wrapper. A wrapper adds
one exactly where it launches its kernel, so a run can show that its
path went through the kernels (the plain versions never count).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
_ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

LAUNCHES = {"pearson": 0, "classify_to_cf": 0, "shearwarp_composite": 0,
            "raymarch_dvr": 0, "classify_volume": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the entries in csrc/ (device index and stream last).
_SIGNATURES = {
    # series, ref, stats, out, v, n
    "correrender_pearson": [_P, _P, _P, _P, _L, _I, _I, _P],
    # field, offset, st_s, st_v, st_u, S, Yv, Xv, lutp, R, lo, hi, out
    "correrender_classify_cf": [
        _P, _L, _L, _L, _L, _I, _I, _I, _P, _I, _F, _F, _P, _I, _P,
    ],
    # cf, S, Yv, Xv, g, coords_y, coords_x, grid_v, grid_u, len_factor,
    # kstop, hi, wi, e_u, e_v, slab_thickness, attenuation, rgb, alpha
    "correrender_shearwarp_composite": [
        _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
        _F, _F, _F, _F, _P, _P, _I, _P,
    ],
    # field, n, lutp, R, lo, hi, out
    "correrender_classify_volume": [_P, _L, _P, _I, _F, _F, _P, _I, _P],
    # vol, planes, sub_extent, lane_extent, fields, width, height,
    # params (host), tfp (host), k, q, nan_mode, restriction, rgb, alpha
    "correrender_raymarch_dvr": [
        _P, _I, _I, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P,
    ],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(_ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> tuple[Path, str]:
    """Compile the kernels if needed; return (library path, ptxas log).

    The log holds ``-Xptxas -v``'s register and shared-memory report
    of the build that made the library (empty when it was already
    built).
    """
    lib = _BUILD_DIR / f"libcorrerender_kernels_{_source_hash()}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, log_path.read_text() if log_path.exists() else ""
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [
        nvcc, *_ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
        "-o", str(tmp), *(str(p) for p in _sources()),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    log_path.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads half a file
    return lib, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.correrender_error_string.argtypes = [ctypes.c_int]
    lib.correrender_error_string.restype = ctypes.c_char_p
    return lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, kernel: str) -> None:
    """Raise when a C entry reported a CUDA error for its launch."""
    if err != 0:
        msg = library().correrender_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err}: {msg}")


def require_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                        device: torch.device) -> None:
    """The wrappers' input checks for a kernel launch."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
