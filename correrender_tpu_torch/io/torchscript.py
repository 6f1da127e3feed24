"""Weights-only reader for PyTorch / TorchScript archives.

A copy of ``correrender_tpu/io/torchscript.py``. The reference loads the
published VMV'23 / SSDBM'24 correlation networks as TorchScript modules
(reference src/Calculators/PyTorchCorrelationCalculator.cpp:261-277).
This module extracts the *weights* from those archives — both
``torch.save`` state-dict zips and ``torch.jit.save`` module archives —
without unpickling anything torch would execute, so published
checkpoints map onto the port's calculators by name.

How: a PyTorch zip archive holds ``<root>/data.pkl`` (the pickled
object graph) plus raw storage blobs under ``<root>/data/<key>``.
The pickle stream references only a handful of constructors —
``torch._utils._rebuild_tensor_v2``, storage classes as persistent
ids, ``collections.OrderedDict``, and (for TorchScript) module types
under ``__torch__.*`` built with NEWOBJ + BUILD. A restricted
Unpickler maps each of those onto inert stubs: storages resolve to
archive blobs, tensors to (storage, offset, shape, stride) records,
and script-module types to attribute bags. Walking the resulting
graph yields ``{dotted.name: array}``. Nothing is ever executed from
the archive (no REDUCE outside the allow-list), which also makes this
safe on untrusted files — unlike ``torch.load`` without
``weights_only``.

Weights come back as numpy arrays, as in the JAX package, except
bfloat16 storages: numpy has no bfloat16 without ``ml_dtypes``, so those
come back as CPU ``torch.bfloat16`` tensors of the same bits.
"""

from __future__ import annotations

import io
import pickle
import zipfile

import numpy as np
import torch

_DTYPES = {
    "FloatStorage": np.dtype("<f4"),
    "DoubleStorage": np.dtype("<f8"),
    "HalfStorage": np.dtype("<f2"),
    "LongStorage": np.dtype("<i8"),
    "IntStorage": np.dtype("<i4"),
    "ShortStorage": np.dtype("<i2"),
    "CharStorage": np.dtype("i1"),
    "ByteStorage": np.dtype("u1"),
    "BoolStorage": np.dtype("?"),
}


#: The storage read through torch: numpy has no bfloat16.
_BFLOAT16 = "BFloat16Storage"


class _Storage:
    def __init__(self, dtype, key):
        self.dtype = dtype
        self.key = key


class _Tensor:
    def __init__(self, storage, offset, size, stride):
        self.storage = storage
        self.offset = offset
        self.size = tuple(size)
        self.stride = tuple(stride)

    def materialize(self, blobs):
        blob = blobs[self.storage.key]
        dtype = self.storage.dtype
        if dtype == _BFLOAT16:  # the same view of the bits, through torch
            bits = _Tensor(_Storage(np.dtype("<u2"), self.storage.key),
                           self.offset, self.size, self.stride)
            raw = np.array(bits.materialize(blobs), copy=True)
            return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
        flat = np.frombuffer(blob, dtype=dtype)
        if not self.size:
            if not 0 <= self.offset < flat.size:
                raise ValueError("tensor offset outside storage blob")
            return flat[self.offset].copy()
        # Bounds-check BEFORE as_strided: a crafted/truncated archive
        # declaring size/stride past the storage blob would otherwise
        # read arbitrary process memory (the module advertises itself
        # as safe on untrusted files).
        max_index = self.offset
        for n, st in zip(self.size, self.stride):
            if n < 0:
                raise ValueError("negative tensor dimension")
            if n > 0:
                if st < 0:
                    raise ValueError("negative stride unsupported")
                max_index += (n - 1) * st
        numel = int(np.prod(self.size))
        if numel > 0 and max_index >= flat.size:
            raise ValueError(
                f"tensor view (offset {self.offset}, size {self.size}, "
                f"stride {self.stride}) exceeds storage of {flat.size} "
                "elements"
            )
        item = dtype.itemsize
        arr = np.lib.stride_tricks.as_strided(
            flat[self.offset:],
            shape=self.size,
            strides=tuple(s * item for s in self.stride),
        )
        return np.ascontiguousarray(arr)


class _StorageType:
    """Stub for ``torch.FloatStorage`` etc. appearing in persistent ids."""

    def __init__(self, name):
        self.name = name


class _ScriptObject:
    """Attribute bag standing in for any ``__torch__.*`` module type."""

    def __new__(cls, *args, **kw):
        # NEWOBJ bypasses __init__, so the bag is attached here.
        obj = object.__new__(cls)
        object.__setattr__(obj, "_attrs", {})
        return obj

    def __setstate__(self, state):
        if isinstance(state, dict):
            self._attrs.update(state)
        else:
            self._attrs["__state__"] = state

    def __setattr__(self, name, value):
        if name == "_attrs":
            object.__setattr__(self, name, value)
        else:
            self._attrs[name] = value


def _rebuild_tensor_v2(storage, offset, size, stride,
                       requires_grad=None, backward_hooks=None,
                       metadata=None):
    return _Tensor(storage, offset, size, stride)


def _rebuild_parameter(tensor, requires_grad=None, hooks=None):
    return tensor


def _identity(x, *a, **kw):
    return x


class _ODict(dict):
    """OrderedDict stub; state-dict zips BUILD it with `_metadata`."""

    def __setstate__(self, state):
        pass


_ALLOWED = {
    ("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor_v2,
    ("torch._utils", "_rebuild_tensor"): _rebuild_tensor_v2,
    ("torch._utils", "_rebuild_parameter"): _rebuild_parameter,
    ("torch.serialization", "_get_layout"): _identity,
    ("torch.jit._pickle", "restore_type_tag"): _identity,
    ("torch.jit._pickle", "build_tensorlist"): list,
    ("torch.jit._pickle", "build_intlist"): list,
    ("torch.jit._pickle", "build_doublelist"): list,
    ("torch.jit._pickle", "build_boollist"): list,
}


class _WeightsUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        fn = _ALLOWED.get((module, name))
        if fn is not None:
            return fn
        if (module, name) == ("collections", "OrderedDict"):
            return _ODict
        if module == "torch" and name in _DTYPES:
            return _StorageType(name)
        if module == "torch" and name == "BFloat16Storage":
            return _StorageType(name)
        if module == "torch" and name.endswith("dtype"):
            return _identity
        if module.startswith("__torch__"):
            return type(f"{module}.{name}", (_ScriptObject,), {})
        if module == "torch.nn.parameter" and name == "Parameter":
            return _rebuild_parameter
        raise pickle.UnpicklingError(
            f"weights-only torch reader: refusing {module}.{name}"
        )

    def persistent_load(self, pid):
        # ('storage', StorageTypeStub, key, location, numel)
        if not (isinstance(pid, tuple) and pid and pid[0] == "storage"):
            raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")
        _, stype, key, _location, _numel = pid
        name = stype.name if isinstance(stype, _StorageType) else str(stype)
        if name == _BFLOAT16:
            dtype = _BFLOAT16
        else:
            dtype = _DTYPES.get(name)
        if dtype is None:
            raise pickle.UnpicklingError(f"unsupported storage {name}")
        return _Storage(dtype, str(key))


def _walk(obj, prefix, blobs, out):
    if isinstance(obj, _Tensor):
        out[prefix] = obj.materialize(blobs)
        return
    if isinstance(obj, _ScriptObject):
        for name, val in obj._attrs.items():
            if name in ("training", "_is_full_backward_hook",
                        "__state__"):
                if name == "__state__":
                    _walk(val, prefix, blobs, out)
                continue
            _walk(val, f"{prefix}.{name}" if prefix else name, blobs, out)
        return
    if isinstance(obj, dict):
        for name, val in obj.items():
            key = str(name)
            _walk(val, f"{prefix}.{key}" if prefix else key, blobs, out)
        return
    if isinstance(obj, (list, tuple)):
        for i, val in enumerate(obj):
            _walk(val, f"{prefix}.{i}" if prefix else str(i), blobs, out)
        return
    # plain hyperparameters (ints/floats/strings) are kept for presets
    if isinstance(obj, (int, float, bool, str)) and prefix:
        out.setdefault("__meta__", {})[prefix] = obj


def read_torch_weights(path: str) -> dict:
    """Extract ``{dotted.name: np.ndarray}`` from a PyTorch archive.

    Accepts both ``torch.save(state_dict)`` zips and ``torch.jit.save``
    TorchScript archives (parameters from ``data.pkl``; tensor
    constants from ``constants.pkl`` appear under ``__constants__.i``).
    Scalar attributes are collected under the ``"__meta__"`` key.
    """
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        pkls = [n for n in names if n.endswith("/data.pkl")
                or n == "data.pkl"]
        if not pkls:
            raise ValueError(f"{path}: no data.pkl — not a PyTorch zip "
                             "archive (legacy tar format unsupported)")
        root = pkls[0][: -len("data.pkl")]
        blobs = {}
        for n in names:
            if n.startswith(f"{root}data/"):
                blobs[n[len(root) + len("data/"):]] = z.read(n)
        out: dict = {}
        for pkl_name, prefix in ((f"{root}data.pkl", ""),
                                 (f"{root}constants.pkl",
                                  "__constants__")):
            if pkl_name not in names:
                continue
            obj = _WeightsUnpickler(
                io.BytesIO(z.read(pkl_name))
            ).load()
            _walk(obj, prefix, blobs, out)
    return out


def torch_weights_to_npz(src: str, dst: str) -> dict:
    """Convert a PyTorch/TorchScript archive to a plain ``.npz``
    (bfloat16 weights widened to float32, exactly: an ``.npz`` holds no
    bfloat16)."""
    weights = read_torch_weights(src)
    arrays = {k: v.float().numpy() if torch.is_tensor(v) else v
              for k, v in weights.items() if k != "__meta__"}
    np.savez(dst, **arrays)
    return arrays
