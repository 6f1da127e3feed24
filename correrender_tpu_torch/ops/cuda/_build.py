"""Build, load and count the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` by its own ``nvcc``
call, all of them at once, and linked into one shared library with a
plain C interface, at first use, under ``build/kernels/`` at the root
of the checkout. The library name holds a hash of the sources and
headers, so an edited kernel is rebuilt and a stale one is never
loaded. The library is bound with ``ctypes``; every C entry takes
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
            "raymarch_dvr": 0, "classify_volume": 0, "spearman": 0,
            "kendall": 0, "mi_ksg": 0, "mi_ksg_banded": 0,
            "chunk_moments": 0, "raymarch_iso": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the entries in csrc/ (device index and stream last).
_SIGNATURES = {
    # series, ref, out, v, n
    "correrender_pearson": [_P, _P, _P, _L, _I, _I, _P],
    # the same, then lanes, stages, tile_bytes (ablate_fast_path.py only)
    "correrender_pearson_probe": [_P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    # field, offset, st_s, st_v, st_u, S, Yv, Xv, lutp, R, lo, hi, out
    "correrender_classify_cf": [
        _P, _L, _L, _L, _L, _I, _I, _I, _P, _I, _F, _F, _P, _I, _P,
    ],
    # cf, S, Yv, Xv, g, coords_y, coords_x, grid_v, grid_u, len_factor,
    # kstop, hi, wi, e_u, e_v, slab_thickness, attenuation, taps, rgb,
    # alpha
    "correrender_shearwarp_composite": [
        _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
        _F, _F, _F, _F, _P, _P, _P, _I, _P,
    ],
    # the same, then probe (ablate_fast_path.py and chip_smoke.py only)
    "correrender_shearwarp_composite_probe": [
        _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
        _F, _F, _F, _F, _P, _P, _P, _I, _I, _P,
    ],
    # field, n, lutp, R, lo, hi, out
    "correrender_classify_volume": [_P, _L, _P, _I, _F, _F, _P, _I, _P],
    # the same, then layout (chip_smoke.py only)
    "correrender_classify_volume_probe": [
        _P, _L, _P, _I, _F, _F, _P, _I, _I, _P,
    ],
    # vol, planes, sub_extent, lane_extent, fields, width, height,
    # params (host), TF segment table (host), k, q, nan_mode,
    # restriction, rgb, alpha
    "correrender_raymarch_dvr": [
        _P, _I, _I, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P,
    ],
    # the same, then tile_width, probe, samples (ablate_raymarch.py only)
    "correrender_raymarch_dvr_probe": [
        _P, _I, _I, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _I, _I,
        _P, _I, _P,
    ],
    # vol, planes, sub_extent, lane_extent, width, height, params (host),
    # axis_world, sub_axis, lane_axis, q, refine_steps, out, dirs
    "correrender_raymarch_iso": [
        _P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P,
    ],
    # vol, planes, sub_extent, lane_extent, fields, width, height, params,
    # axis_world, sub_axis, lane_axis, q, refine_steps, out, dirs,
    # tile_width, cache, compact, setup, probe, samples (ablate_iso.py
    # only)
    "correrender_raymarch_iso_probe": [
        _P, _I, _I, _I, _P, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I,
        _I, _I, _I, _P, _I, _P,
    ],
    # chunk, bf16, ref, acc, out, v, e
    "correrender_chunk_moments": [_P, _I, _P, _P, _P, _L, _I, _I, _P],
    # series, xrank2, sums, v, n
    "correrender_spearman": [_P, _P, _P, _L, _I, _I, _P],
    # series, xrank2, sums, v, n, lanes, probe (ablate_spearman.py only)
    "correrender_spearman_probe": [_P, _P, _P, _L, _I, _I, _I, _I, _P],
    # series, perm, gstart, counts, v, n
    "correrender_kendall": [_P, _P, _P, _P, _L, _I, _I, _P],
    # series, perm, xs_sorted, y_noise, psi_sum, counts, v, n, k,
    # estimator
    "correrender_mi_ksg": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    # series, perm, xs_sorted, y_noise, psi_sum, counts, repaired, v, n,
    # w_band, k, estimator
    "correrender_mi_ksg_banded": [
        _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P,
    ],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(_CSRC.glob("*.cu*")):  # the .cuh headers too
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
    tag = f"{lib.stem}.{os.getpid()}"
    # One nvcc per source, all started together, then one link.
    objects, procs = [], []
    for src in _sources():
        obj = _BUILD_DIR / f"{tag}.{src.stem}.o"
        objects.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *_ARCH_FLAGS, "-std=c++17", "-O3", "-c",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
             "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log = ""
    failed = []
    for src, proc in zip(_sources(), procs):
        out, _ = proc.communicate()
        log += out
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out}")
    tmp = lib.with_name(f"{tag}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, *_ARCH_FLAGS, "-shared", "-o", str(tmp),
             *(str(o) for o in objects)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stdout}")
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads half a file
    return lib, log


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


#: The rank and MI kernels hold the reference series and each warp's
#: member series in shared memory (ksg_common.cuh); B9 and B10 also a
#: ψ table and a sorted copy, B8 a second buffer, which fit one warp's
#: block up to n = 12288.
MAX_MEMBERS = 12288


def check_members(kernel: str, n: int, device) -> None:
    """The kernels' shared-memory limit on a CUDA device (``device`` a
    string or a ``torch.device``); the plain versions take any n."""
    if torch.device(device).type == "cuda" and n > MAX_MEMBERS:
        raise ValueError(f"{kernel}: n={n} members exceed the kernel's "
                         f"shared-memory limit of {MAX_MEMBERS}")


def member_series(kernel: str, stack: torch.Tensor, ref: torch.Tensor):
    """Check a ``(..., n)`` float32 stack against an ``(n,)`` float32
    reference on one device; return the ``(V, n)`` view and the leading
    shape. On a CUDA device, also the kernels' own limits."""
    n = stack.shape[-1]
    if stack.dtype != torch.float32 or ref.dtype != torch.float32:
        raise TypeError(f"{kernel} takes float32 stack and ref")
    if tuple(ref.shape) != (n,):
        raise ValueError(f"ref has shape {tuple(ref.shape)}, expected ({n},)")
    if ref.device != stack.device:
        raise ValueError("stack and ref must lie on one device")
    if stack.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {kernel} kernel for device {stack.device}")
    if stack.device.type == "cuda":
        require_cuda_tensor(stack, "stack", torch.float32, stack.device)
        require_cuda_tensor(ref, "ref", torch.float32, stack.device)
        check_members(kernel, n, stack.device)
    return stack.reshape(-1, n), stack.shape[:-1]


#: Working-set budget of the plain versions' voxel chunks.
PLAIN_BUDGET_BYTES = 256 << 20


def voxel_chunks(v: int, per_voxel_bytes: int,
                 budget: int = PLAIN_BUDGET_BYTES):
    """Slices of ``range(v)`` whose working sets fit ``budget``."""
    step = max(budget // max(per_voxel_bytes, 1), 1)
    return [slice(s, min(s + step, v)) for s in range(0, v, step)]
