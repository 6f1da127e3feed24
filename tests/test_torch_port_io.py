"""PyTorch port (correrender_tpu_torch) vs the JAX package: the data
model and loading.

The same files, written here from numpy draws with fixed seeds, are
opened by both packages' ``load_volume``; every slab, stack and min/max
must agree exactly (bar 0.0: both read the same bytes and upload float32
or bfloat16 values unchanged). The port's ``VolumeData`` lives on the
CPU in these tests; on a CUDA device the same code uploads there.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from correrender_tpu.core.fields import GridMetadata as JaxGrid
from correrender_tpu.core.fields import VolumeData as JaxVolumeData
from correrender_tpu.io import load_volume as jax_load_volume
from correrender_tpu.io.blosc import blosc_compress as jax_blosc_compress
from correrender_tpu.io.catalog import load_catalog as jax_load_catalog
from correrender_tpu.io.catalog import open_dataset as jax_open_dataset

from correrender_tpu_torch.app.baseline_configs import write_zarr_array
from correrender_tpu_torch.calculators.base import Calculator
from correrender_tpu_torch.core.cache import (
    CPU_BUDGET_BYTES,
    LRUFieldCache,
    default_budget,
)
from correrender_tpu_torch.core.fields import GridMetadata, VolumeData
from correrender_tpu_torch.io import load_catalog, load_volume, open_dataset
from correrender_tpu_torch.io.blosc import blosc_compress, blosc_decompress
from correrender_tpu_torch.io.zarr_lite import ZarrArray

SHAPE = (3, 4, 5, 6, 7)  # (E, T, Z, Y, X)


def _data(seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=shape).astype(np.float32)
    data.reshape(-1)[::97] = np.nan  # fill values and gaps
    return data


def _write_zarr(path, data, chunks, compressor):
    """A Zarr v2 array with raw, zlib, gzip or blosc chunks."""
    import gzip
    import itertools
    import zlib

    os.makedirs(path, exist_ok=True)
    comp = None if compressor == "raw" else {"id": compressor}
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump({"zarr_format": 2, "shape": list(data.shape),
                   "chunks": list(chunks), "dtype": data.dtype.str,
                   "compressor": comp, "fill_value": None, "order": "C",
                   "filters": None}, f)
    grids = [range(-(-s // c)) for s, c in zip(data.shape, chunks)]
    for idx in itertools.product(*grids):
        sl = tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, chunks))
        chunk = data[sl]
        chunk = np.pad(chunk, [(0, c - s) for c, s in zip(chunks,
                                                           chunk.shape)])
        raw = chunk.tobytes()
        if compressor == "zlib":
            raw = zlib.compress(raw)
        elif compressor == "gzip":
            raw = gzip.compress(raw)
        elif compressor == "blosc":
            raw = jax_blosc_compress(raw, typesize=4, cname="zlib",
                                     blocksize=1 << 10, shuffle=True)
        with open(os.path.join(path, ".".join(map(str, idx))), "wb") as f:
            f.write(raw)


def _assert_same_volume(jvd, tvd):
    """Every slab, both stacks and every min/max equal (bar 0.0)."""
    g, tg = jvd.grid, tvd.grid
    assert (g.xs, g.ys, g.zs, g.ts, g.es) == (tg.xs, tg.ys, tg.zs, tg.ts,
                                               tg.es)
    for a, b in zip(g.render_box(), tg.render_box()):
        np.testing.assert_array_equal(a, b)
    assert jvd.field_names == tvd.field_names
    for name in jvd.field_names:
        for t in range(g.ts):
            for e in range(g.es):
                want = np.asarray(jvd.get_field(name, t, e))
                got = tvd.get_field(name, t, e)
                assert got.dtype == torch.float32 and got.is_contiguous()
                np.testing.assert_array_equal(got.numpy(), want)
                np.testing.assert_array_equal(
                    np.asarray(tvd.get_min_max(name, t, e)),
                    np.asarray(jvd.get_min_max(name, t, e)))
            np.testing.assert_array_equal(
                tvd.get_member_stack(name, t).float().numpy(),
                np.asarray(jvd.get_member_stack(name, t), np.float32))
        for e in range(g.es):
            np.testing.assert_array_equal(
                tvd.get_time_stack(name, e).float().numpy(),
                np.asarray(jvd.get_time_stack(name, e), np.float32))
        for mode in (True, False):
            np.testing.assert_array_equal(
                np.asarray(tvd.get_global_min_max(name, mode, 1, 2)),
                np.asarray(jvd.get_global_min_max(name, mode, 1, 2)))


@pytest.mark.parametrize("compressor", ["raw", "zlib", "gzip", "blosc"])
@pytest.mark.parametrize("chunks", [(1, 1, 5, 6, 7), (2, 3, 4, 4, 4)])
def test_zarr_store_loads_as_jax(tmp_path, compressor, chunks):
    store = tmp_path / "ens.zarr"
    _write_zarr(str(store / "q"), _data(), chunks, compressor)
    _write_zarr(str(store / "r"), _data(1)[0], chunks[1:], compressor)
    _assert_same_volume(jax_load_volume(str(store)),
                        load_volume(str(store), device="cpu"))


def test_config4_store_loads_as_jax(tmp_path):
    from correrender_tpu.app.baseline_configs import (
        _write_zarr_array as jax_write_zarr_array,
    )

    data = _data(2, (2, 3, 4, 6, 6))
    write_zarr_array(str(tmp_path / "a.zarr" / "q"), data, (1, 2, 4, 6, 6))
    jax_write_zarr_array(str(tmp_path / "b.zarr" / "q"), data,
                         (1, 2, 4, 6, 6))
    for name in os.listdir(tmp_path / "a.zarr" / "q"):
        assert ((tmp_path / "a.zarr" / "q" / name).read_bytes()
                == (tmp_path / "b.zarr" / "q" / name).read_bytes())
    raw = tmp_path / "c.zarr" / "q"
    write_zarr_array(str(raw), data, (1, 1, 4, 6, 6), compressor=None)
    np.testing.assert_array_equal(ZarrArray(str(raw))[:], data)
    _assert_same_volume(jax_load_volume(str(tmp_path / "b.zarr")),
                        load_volume(str(tmp_path / "a.zarr"), device="cpu"))


@pytest.mark.parametrize("shuffle", [False, True, "bit"])
@pytest.mark.parametrize("nbytes", [0, 7, 4096, 10_000])
def test_blosc_frames_equal_jax(shuffle, nbytes):
    data = np.random.default_rng(nbytes).integers(
        0, 4, nbytes, dtype=np.uint8).tobytes()
    frame = blosc_compress(data, typesize=4, cname="zlib", blocksize=1024,
                           shuffle=shuffle)
    assert frame == jax_blosc_compress(data, typesize=4, cname="zlib",
                                       blocksize=1024, shuffle=shuffle)
    assert blosc_decompress(frame) == data


@pytest.mark.parametrize("fmt", ["float", "uchar", "ushort"])
def test_dat_raw_loads_as_jax(tmp_path, fmt):
    dtype = {"float": np.float32, "uchar": np.uint8, "ushort": np.uint16}[fmt]
    rng = np.random.default_rng(3)
    steps = [(rng.random((5, 6, 7)) * 200).astype(dtype) for _ in range(3)]
    for i, s in enumerate(steps):
        s.tofile(tmp_path / f"vol_{i}.raw")
    (tmp_path / "vol.dat").write_text(
        "ObjectFileName: vol_0.raw vol_1.raw vol_2.raw\n"
        "Resolution: 7 6 5\nSliceThickness: 1 2 0.5\n"
        f"Format: {fmt}\n")
    path = str(tmp_path / "vol.dat")
    _assert_same_volume(jax_load_volume(path),
                        load_volume(path, device="cpu"))
    named = tmp_path / f"box_7x6x5_{fmt}.raw"
    steps[1].tofile(named)
    _assert_same_volume(jax_load_volume(str(named)),
                        load_volume(str(named), device="cpu"))


@pytest.mark.parametrize("layout", ["ezyx", "tzyx", "etzyx", "zyx"])
def test_netcdf3_loads_as_jax(tmp_path, layout):
    import scipy.io

    data = _data(4)
    dims = {"ezyx": ("member", "lev", "lat", "lon"),
            "tzyx": ("time", "lev", "lat", "lon"),
            "etzyx": ("member", "time", "lev", "lat", "lon"),
            "zyx": ("lev", "lat", "lon")}[layout]
    arr = {"ezyx": data[:, 0], "tzyx": data[0], "etzyx": data,
           "zyx": data[0, 0]}[layout]
    path = str(tmp_path / "d.nc")
    nc = scipy.io.netcdf_file(path, "w")
    for d, n in zip(dims, arr.shape):
        nc.createDimension(d, n)
    var = nc.createVariable("q", "f", dims)
    var[:] = np.nan_to_num(arr, nan=-999.0)
    var._FillValue = np.float32(-999.0)
    lat = nc.createVariable("lat", "d", ("lat",))
    lat[:] = np.linspace(-10, 10, arr.shape[-2])
    nc.close()
    jvd = jax_load_volume(path)
    tvd = load_volume(path, device="cpu")
    _assert_same_volume(jvd, tvd)
    np.testing.assert_array_equal(tvd.lat, jvd.lat)
    for ld in jvd.loaders + tvd.loaders:
        ld.close()


def _catalog(tmp_path, **entry):
    store = tmp_path / "ens.zarr"
    _write_zarr(str(store / "q"), _data(5), (1, 2, 5, 6, 7), "zlib")
    (tmp_path / "datasets.json").write_text(json.dumps({"datasets": [
        {"type": "node", "name": "group", "children": [
            {"name": "set", "filename": "ens.zarr", **entry}]}]}))
    return str(tmp_path / "datasets.json")


@pytest.mark.parametrize("entry", [
    {},
    {"format_cast": "float16"},
    {"format_cast": "ushort"},
    {"scale": [2.0, 1.0, 0.5], "heightscale": 3.0},
    {"subsampling_factor": 2},
    {"domain_subselection_min": "1 0 1", "domain_subselection_max": "5 4 3"},
    {"axes": [0, 2, 1]},
    {"transform": "1 0 0 0.1 0 0 -1 0 0 1 0 0 0 0 0 1"},
], ids=["plain", "float16", "ushort", "scale", "subsample", "subselect",
        "axes", "transform"])
def test_catalog_opens_as_jax(tmp_path, entry):
    path = _catalog(tmp_path, **entry)
    (jinfo,) = jax_load_catalog(path)
    (tinfo,) = load_catalog(path)
    assert tinfo.name == jinfo.name == "group/set"
    jvd = jax_open_dataset(jinfo)
    tvd = open_dataset(tinfo, device="cpu")
    _assert_same_volume(jvd, tvd)
    want = (torch.bfloat16 if entry.get("format_cast") == "float16"
            else torch.float32)
    assert tvd.member_stack_dtype == want
    assert (jvd.member_stack_dtype == jnp.bfloat16) == (want
                                                        == torch.bfloat16)
    jm = getattr(jvd, "model_matrix", None)
    if jm is None:
        assert tvd.model_matrix is None
    else:
        np.testing.assert_array_equal(tvd.model_matrix, jm)


@pytest.mark.parametrize("name", ["a.vtk", "b.nii", "c.xyz", "d.mhd"])
def test_unported_extension_lists_the_ported(name):
    # Every extension of the JAX package's registry is ported: a known
    # one opens with the loader JAX picks (a missing file then raises on
    # reading), an unknown one raises listing the registry, as in JAX.
    from correrender_tpu.io.base import _LOADER_REGISTRY as jax_registry
    from correrender_tpu.io.base import loader_for_path as jax_loader_for

    from correrender_tpu_torch.io.base import loader_for_path

    if name == "c.xyz":
        with pytest.raises(ValueError) as want:
            jax_loader_for(name)
        with pytest.raises(ValueError) as got:
            load_volume(name, device="cpu")
        assert str(got.value) == str(want.value)
        assert str(sorted(jax_registry)) in str(got.value)
        return
    assert type(loader_for_path(name)).__name__ == \
        type(jax_loader_for(name)).__name__
    with pytest.raises(OSError):
        load_volume(name, device="cpu")


def test_cuda_volume_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VolumeData(GridMetadata(xs=2, ys=2, zs=2))
    store = tmp_path / "s.zarr"
    _write_zarr(str(store / "q"), _data(8)[0, 0], (5, 6, 7), "raw")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_volume(str(store))


@pytest.mark.parametrize("spacing", [(1, 1, 1), (1.0, 2.0, 0.5),
                                     (0.3, 1.0, 3.0)])
@pytest.mark.parametrize("dims", [(7, 6, 5), (20, 3, 9)])
def test_render_box_honours_spacing(spacing, dims):
    kw = dict(xs=dims[0], ys=dims[1], zs=dims[2], dx=spacing[0],
              dy=spacing[1], dz=spacing[2], render_height_scale=1.5)
    for a, b in zip(JaxGrid(**kw).render_box(), GridMetadata(**kw)
                    .render_box()):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


class _Derived(Calculator):
    """A calculator that reads one field (for the dirty propagation)."""

    type_id = "derived"

    def __init__(self, field_name, output_name):
        super().__init__(output_name)
        self.field_name = field_name

    def compute(self, time, member):
        return self.volume_data.get_field(self.field_name, time, member) * 2


def _jax_derived(field_name, output_name):
    from correrender_tpu.calculators.base import Calculator as JaxCalculator

    class JaxDerived(JaxCalculator):
        type_id = "derived"

        def __init__(self):
            super().__init__(output_name)
            self.field_name = field_name

        def compute(self, time, member):
            return self.volume_data.get_field(self.field_name, time,
                                              member) * 2

    return JaxDerived()


def _chain(jax_side: bool):
    """a → b → c, and an independent d on a second field."""
    data = _data(7, (2, 1, 3, 4, 5))
    grid = dict(xs=5, ys=4, zs=3, ts=1, es=2)
    vd = (JaxVolumeData(JaxGrid(**grid)) if jax_side
          else VolumeData(GridMetadata(**grid), device="cpu"))
    vd.add_field("a", lambda t, e: data[e, t])
    vd.add_field("z", lambda t, e: data[e, t] + 1)
    make = _jax_derived if jax_side else _Derived
    vd.add_calculator(make("a", "b"))
    vd.add_calculator(make("b", "c"))
    vd.add_calculator(make("z", "d"))
    return vd


def test_dirty_propagation_matches_jax():
    jvd, tvd = _chain(True), _chain(False)
    names = ("a", "z", "b", "c", "d")
    for vd in (jvd, tvd):
        for n in names:
            vd.get_field(n, 0, 1)
    for step in (lambda vd: vd.mark_dirty("a"),
                 lambda vd: vd.mark_dirty("z"),
                 lambda vd: vd.mark_dirty("c"),
                 lambda vd: vd.add_field("a", lambda t, e: np.zeros(
                     (3, 4, 5), np.float32)),
                 lambda vd: vd.rename_field("c", "c2"),
                 lambda vd: vd.remove_calculator("d")):
        step(jvd)
        step(tvd)
        assert tvd.field_names == jvd.field_names
        for n in set(names) | {"c2"}:
            assert tvd.dirty_epoch(n) == jvd.dirty_epoch(n), n
            assert (((n, 0, 1) in tvd.cache)
                    == ((n, 0, 1) in jvd.cache)), n
        for n in tvd.field_names:
            np.testing.assert_array_equal(
                tvd.get_field(n, 0, 1).numpy(),
                np.asarray(jvd.get_field(n, 0, 1)))


def test_cache_counts_tensor_bytes_and_evicts_lru():
    cache = LRUFieldCache(max_bytes=3 * 400)
    for i in range(3):
        cache.put(("f", i, 0), torch.zeros(100))  # 400 bytes each
    assert cache.used_bytes == 1200 and len(cache) == 3
    cache.get(("f", 0, 0))  # now the most recent
    cache.put(("f", 3, 0), torch.zeros(50, dtype=torch.float64))
    assert ("f", 1, 0) not in cache and ("f", 0, 0) in cache
    assert cache.used_bytes == 1200
    cache.put_min_max(("f", 2, 0), (0.0, 1.0))
    cache.put(("g", 0, 0), torch.zeros(200))  # 800 bytes: two evicted
    assert len(cache) == 2 and ("f", 3, 0) in cache
    cache.put(("big", 0, 0), torch.zeros(1000))  # over the budget: kept
    assert list(cache._entries) == [("big", 0, 0)]
    cache.invalidate_field("f")
    assert cache.get_min_max(("f", 2, 0)) is None  # the data changed
    cache.invalidate_field("big")
    assert len(cache) == 0 and cache.used_bytes == 0
    assert default_budget("cpu") == CPU_BUDGET_BYTES
    vd = VolumeData(GridMetadata(xs=2, ys=2, zs=2), device="cpu")
    assert vd.cache.max_bytes == CPU_BUDGET_BYTES


CACHE_SCRIPTS = {
    # (op, key or size): puts of float32 slabs of n values, gets,
    # reservations by bytes, releases by the reservation's index, clear.
    "reserve_evicts_lru": [("put", 100), ("put", 100), ("put", 100),
                           ("get", 0), ("reserve", 500), ("put", 50),
                           ("release", 0), ("put", 200)],
    "reserved_budget_holds": [("reserve", 800), ("put", 100),
                              ("put", 100), ("put", 100), ("reserve", 0),
                              ("release", 0), ("release", 0),
                              ("put", 100), ("put", 100)],
    "clear_keeps_reservations": [("put", 100), ("reserve", 400),
                                 ("put", 100), ("clear", None),
                                 ("put", 200), ("put", 100),
                                 ("release", 0), ("put", 150)],
    "over_budget": [("reserve", 1400), ("put", 10), ("put", 300),
                    ("with", 200), ("put", 100), ("release", 0)],
}


@pytest.mark.parametrize("script", list(CACHE_SCRIPTS))
def test_cache_reservations_match_jax(script):
    from correrender_tpu.core.cache import LRUFieldCache as JaxCache

    caches = {"jax": JaxCache(max_bytes=1200),
              "port": LRUFieldCache(max_bytes=1200)}
    tokens = {side: [] for side in caches}
    for step, (op, arg) in enumerate(CACHE_SCRIPTS[script]):
        for side, cache in caches.items():
            key = ("f", step, 0)
            if op == "put":
                cache.put(key, np.zeros(arg, np.float32) if side == "jax"
                          else torch.zeros(arg))
                cache.put_min_max(key, (0.0, float(step)))
            elif op == "get":
                cache.get(("f", arg, 0))
            elif op == "reserve":
                tokens[side].append(cache.reserve_auxiliary(arg * 4))
            elif op == "release":
                tokens[side][arg].release()
            elif op == "with":
                with cache.reserve_auxiliary(arg * 4):
                    cache.put(key, np.zeros(arg, np.float32)
                              if side == "jax" else torch.zeros(arg))
            else:
                cache.clear()
        jc, pc = caches["jax"], caches["port"]
        assert list(pc._entries) == list(jc._entries), (script, step)
        assert (pc.used_bytes, pc._aux_reserved) == (
            jc.used_bytes, jc._aux_reserved), (script, step)
        assert pc._min_max == jc._min_max, (script, step)


@pytest.mark.parametrize("dims", [(1, 1, 1), (7, 6, 5), (250, 250, 250),
                                  (720, 361, 37)])
def test_num_voxels_and_field_exists_match_jax(dims):
    grid = dict(xs=dims[0], ys=dims[1], zs=dims[2], es=2)
    assert GridMetadata(**grid).num_voxels == JaxGrid(**grid).num_voxels
    assert GridMetadata(**grid).num_voxels == int(np.prod(dims))
    small = dict(xs=3, ys=2, zs=2, es=2)
    vds = (VolumeData(GridMetadata(**small), device="cpu"),
           JaxVolumeData(JaxGrid(**small)))
    for vd in vds:
        vd.add_field("a", lambda t, e: np.zeros((2, 2, 3), np.float32))
        vd.add_calculator(_Derived("a", "b") if isinstance(vd, VolumeData)
                          else _jax_derived("a", "b"))
    for name in ("a", "b", "c"):
        assert vds[0].field_exists(name) == vds[1].field_exists(name)
    for vd in vds:
        vd.remove_calculator("b")
        vd.rename_field("a", "c")
    for name in ("a", "b", "c"):
        assert vds[0].field_exists(name) == vds[1].field_exists(name)
    assert vds[0].field_exists("c") and not vds[0].field_exists("a")


def test_all_nan_slab_min_max_is_nan():
    vd = VolumeData(GridMetadata(xs=2, ys=2, zs=2), device="cpu")
    vd.add_field("n", lambda t, e: np.full((2, 2, 2), np.nan, np.float32))
    jvd = JaxVolumeData(JaxGrid(xs=2, ys=2, zs=2))
    jvd.add_field("n", lambda t, e: np.full((2, 2, 2), np.nan, np.float32))
    assert all(np.isnan(vd.get_min_max("n")))
    assert all(np.isnan(jvd.get_min_max("n")))
