"""NetCDF loader — the reference's primary format.

A copy of ``correrender_tpu/io/netcdf.py``.

Replicates the dimension sniffing of the reference's NetCdfLoader
(src/Loaders/NetCdfLoader.cpp:344-482): variables of rank 3 (z,y,x),
4 (t,z,y,x or e,z,y,x) or 5 (e,t,z,y,x); lat/lon/lev coordinate
detection by dimension name.

Backends: NetCDF3 (classic) via scipy.io.netcdf_file; NetCDF4 (HDF5
container) via h5py. No netCDF4 package is needed.
"""

from __future__ import annotations

import numpy as np

from correrender_tpu_torch.io.base import VolumeLoader, register_loader

_TIME_NAMES = {"time", "t", "times"}
_MEMBER_NAMES = {"member", "members", "ens", "ensemble", "emem", "e"}
_Z_NAMES = {"lev", "level", "levels", "z", "zdim", "height", "altitude",
            "plev", "depth"}
_Y_NAMES = {"lat", "latitude", "y", "ydim", "yc"}
_X_NAMES = {"lon", "longitude", "x", "xdim", "xc"}


def _classify_dim(name: str) -> str:
    n = name.lower()
    if n in _TIME_NAMES:
        return "t"
    if n in _MEMBER_NAMES:
        return "e"
    if n in _Z_NAMES:
        return "z"
    if n in _Y_NAMES:
        return "y"
    if n in _X_NAMES:
        return "x"
    return "?"


def _axis_order(dim_names):
    """Map variable dims to (e, t, z, y, x) roles, positional fallback."""
    roles = [_classify_dim(d) for d in dim_names]
    unknown = [i for i, r in enumerate(roles) if r == "?"]
    needed = [r for r in ("e", "t", "z", "y", "x")[-len(dim_names):]
              if r not in roles]
    # A volume NEEDS a z role, t is optional: when there are fewer
    # unknown dims than missing roles, fill z before t, or an
    # unrecognized vertical dim name (sigma, isobaric, ...) would be
    # labeled 't' and the variable dropped as z-less.
    if len(unknown) < len(needed) and "z" in needed:
        needed.remove("z")
        needed.insert(0, "z")
    # Positional fallback: unknown dims fill remaining roles in order.
    for i, r in zip(unknown, needed):
        roles[i] = r
    return roles


_OPEN_NC3_LOADERS: "weakref.WeakSet" = None  # initialized below


def _close_open_nc3_loaders():
    for loader in list(_OPEN_NC3_LOADERS):
        try:
            loader.close()
        except Exception:
            pass


def _init_nc3_registry():
    global _OPEN_NC3_LOADERS
    import atexit
    import weakref

    _OPEN_NC3_LOADERS = weakref.WeakSet()
    atexit.register(_close_open_nc3_loaders)


_init_nc3_registry()


@register_loader
class NetCdfLoader(VolumeLoader):
    extensions = ("nc", "nc4", "cdf")

    def open(self, path, dataset_info=None):
        self.path = path
        self._h5 = None
        self._nc = None
        with open(path, "rb") as f:
            magic = f.read(8)
        if magic[:3] == b"CDF":
            import scipy.io

            # mmap=True keeps open() cheap on multi-GB files (no
            # whole-file read); load_field copies each slab out of the
            # map immediately, so no array outlives it (scipy's
            # destructor warns loudly if one does).
            self._nc = scipy.io.netcdf_file(path, "r", mmap=True)
            # Close before interpreter teardown: scipy's destructor
            # references module globals that are already gone by then
            # and spews "Exception ignored" TypeErrors otherwise. One
            # process-wide hook over a WeakSet — per-loader
            # atexit.register would pin every loader (and its mmap)
            # for the process lifetime.
            _OPEN_NC3_LOADERS.add(self)
            variables = {
                k: (v.dimensions, v.shape)
                for k, v in self._nc.variables.items()
            }
        elif magic[:8] == b"\x89HDF\r\n\x1a\n":
            import h5py

            self._h5 = h5py.File(path, "r")
            variables = {}

            def visit(name, obj):
                if isinstance(obj, h5py.Dataset) and obj.ndim >= 1:
                    dims = []
                    for i, d in enumerate(obj.dims):
                        label = d.label or (
                            d[0].name.split("/")[-1] if len(d) else f"dim{i}"
                        )
                        dims.append(label)
                    variables[name] = (tuple(dims), obj.shape)

            self._h5.visititems(visit)
        else:
            raise ValueError(f"{path}: not a NetCDF3 or NetCDF4/HDF5 file")

        self._vars = {}
        coord_names = _TIME_NAMES | _MEMBER_NAMES | _Z_NAMES | _Y_NAMES | _X_NAMES
        for name, (dims, shape) in variables.items():
            short = name.split("/")[-1].lower()
            if short in coord_names or len(shape) < 3 or len(shape) > 5:
                continue
            roles = _axis_order(dims)
            idx = {r: shape[i] for i, r in enumerate(roles)}
            if not {"z", "y", "x"} <= idx.keys():
                # Fully-classified without a z role — a 2D surface
                # series like t2m(time, lat, lon). Skip it instead of
                # KeyError-ing the whole file unloadable; the volume
                # model is (Z, Y, X) per field.
                continue
            self._vars[name] = (roles, shape)
            self.zs, self.ys, self.xs = idx["z"], idx["y"], idx["x"]
            self.ts = max(self.ts, idx.get("t", 1))
            self.es = max(self.es, idx.get("e", 1))

        if not self._vars:
            raise ValueError(f"{path}: no 3D+ scalar variables found")
        self.field_names = list(self._vars)
        self._read_coords(variables)
        return self

    def _read_coords(self, variables):
        for name in variables:
            short = name.split("/")[-1].lower()
            src = self._h5 if self._h5 is not None else self._nc.variables
            try:
                # copy=True: np.asarray on an already-float64 NC3 var
                # keeps a live VIEW into the mmap, which then blocks
                # close() (no array may outlive the map).
                data = np.array(src[name][...], np.float64, copy=True)
            except Exception:
                continue
            if data.ndim != 1:
                continue
            if short in _Y_NAMES and len(data) == self.ys:
                self.lat = data
            elif short in _X_NAMES and len(data) == self.xs:
                self.lon = data
            elif short in _Z_NAMES and len(data) == self.zs:
                self.height = data

    def load_field(self, name, time=0, member=0):
        roles, shape = self._vars[name]
        index = []
        for r in roles:
            if r == "t":
                index.append(time)
            elif r == "e":
                index.append(member)
            else:
                index.append(slice(None))
        src = self._h5[name] if self._h5 is not None else self._nc.variables[name]
        # copy=True detaches the slab from scipy's mmap (see open()).
        arr = np.array(src[tuple(index)], np.float32, copy=True)
        # Remaining axes are (z, y, x) in role order; transpose if needed.
        spatial_roles = [r for r in roles if r in "zyx"]
        perm = [spatial_roles.index(a) for a in "zyx"]
        arr = np.transpose(arr, perm)
        # Fill values → NaN (the reference maps _FillValue to NaN).
        fill = self._fill_value(name)
        if fill is not None and np.isfinite(fill):
            arr = np.where(np.isclose(arr, np.float32(fill)), np.nan, arr)
        return arr

    def _fill_value(self, name):
        try:
            if self._h5 is not None:
                fv = self._h5[name].attrs.get("_FillValue")
                if fv is None:
                    return None
                # Writers store _FillValue as a 1-element array OR a
                # scalar (h5netcdf/xarray); [0] on a scalar raised
                # IndexError, silently disabling NaN masking via the
                # except below.
                return float(np.asarray(fv).reshape(-1)[0])
            v = self._nc.variables[name]
            return getattr(v, "_FillValue", None)
        except Exception:
            return None

    def close(self):
        _OPEN_NC3_LOADERS.discard(self)
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None
        if self._nc is not None:
            self._nc.close()
            self._nc = None
