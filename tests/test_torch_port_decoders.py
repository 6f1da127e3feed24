"""PyTorch port (correrender_tpu_torch.io) vs the JAX package: the
decoders of GRIB2, VTK, AmiraMesh, NIfTI, HDF5, RBC .bin, .field, .mhd,
.cvol and GrADS .ctl, the GRIB2 writer, the native bit-unpack codec and
the TorchScript weights reader.

The port's decoders are copies of the JAX package's numpy modules, so
the bar is 0.0 throughout: the same files, written here from numpy draws
with fixed seeds, are opened by both packages' ``load_volume`` (the
port's on the CPU) and every field of every time step and member must be
equal to the bit, with the same metadata. A damaged file raises in the
port where it raises in JAX. The port's GRIB2 bit unpacking runs in its
native codec (``io/codec.py``); the numpy unpack is its plain version
and must decode every message alike.
"""

import base64
import gzip
import io
import pickle
import struct
import zipfile
import zlib

import numpy as np
import pytest
import torch

from correrender_tpu.io import base as jax_base
from correrender_tpu.io import grib as jax_grib
from correrender_tpu.io import load_volume as jax_load_volume
from correrender_tpu.io import rbc as jax_rbc
from correrender_tpu.io.catalog import DataSetInformation as JaxInfo
from correrender_tpu.io.torchscript import (
    read_torch_weights as jax_read_weights,
)

from correrender_tpu_torch import native
from correrender_tpu_torch.io import base, codec, grib, load_volume, rbc
from correrender_tpu_torch.io import writers
from correrender_tpu_torch.io.catalog import DataSetInformation
from correrender_tpu_torch.io.torchscript import (
    read_torch_weights,
    torch_weights_to_npz,
)


def _vol(seed=0, shape=(4, 6, 8)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- file writers, one a case ------------------------------------------------
# Each returns the path (or list of paths) to load and the catalog
# entry's keyword arguments (or None).

def _cvol(tmp, dtype):
    if dtype == np.float32:
        data = _vol()
    else:
        data = (np.arange(4 * 6 * 8) * 37 % np.iinfo(dtype).max).astype(
            dtype).reshape(4, 6, 8)
    path = str(tmp / f"v_{np.dtype(dtype).name}.cvol")
    writers.write_cvol(path, data, (0.5, 1.0, 2.0))
    return path, None


def _mhd(tmp, met, dtype):
    data = (_vol() * 40).astype(dtype)
    data.tofile(str(tmp / "m.raw"))
    (tmp / "m.mhd").write_text(
        "ObjectType = Image\nNDims = 3\nDimSize = 8 6 4\n"
        f"ElementType = {met}\nElementSpacing = 0.5 1 2\n"
        "ElementDataFile = m.raw\n")
    return str(tmp / "m.mhd"), None


def _ctl(tmp, big_endian):
    # Two time steps of a 3-level and a 1-level variable, sequential.
    rng = np.random.default_rng(2)
    blocks = rng.normal(size=(2, 4, 6, 8)).astype(
        ">f4" if big_endian else "<f4")
    blocks.tofile(str(tmp / "g.bin"))
    options = "OPTIONS big_endian\n" if big_endian else ""
    (tmp / "g.ctl").write_text(
        f"DSET ^g.bin\n{options}XDEF 8 LINEAR 0 1\nYDEF 6 LINEAR 0 1\n"
        "ZDEF 3 LEVELS 1000 900 800\nTDEF 2 LINEAR 00z01jan2020 1dy\n"
        "VARS 2\nt 3 99 temperature\nps 1 99 surface pressure\nENDVARS\n")
    return str(tmp / "g.ctl"), None


def _vti_ascii(tmp):
    flat = " ".join(str(v) for v in _vol().ravel())
    path = tmp / "f.vti"
    path.write_text(
        '<VTKFile type="ImageData" version="1.0">'
        '<ImageData WholeExtent="0 7 0 5 0 3" Spacing="1 0.5 2">'
        "<Piece><PointData>"
        f'<DataArray type="Float32" Name="s" format="ascii">{flat}'
        "</DataArray></PointData></Piece></ImageData></VTKFile>")
    return str(path), None


def _zlib_blocks(raw, block_size=256):
    blocks = [zlib.compress(raw[i:i + block_size])
              for i in range(0, len(raw), block_size)]
    last = len(raw) - (len(blocks) - 1) * block_size
    header = np.array([len(blocks), block_size, last]
                      + [len(b) for b in blocks], np.uint32).tobytes()
    return header, b"".join(blocks)


def _vti_inline_zlib(tmp):
    header, blocks = _zlib_blocks(_vol().astype("<f4").tobytes())
    text = (base64.b64encode(header).decode()
            + base64.b64encode(blocks).decode())
    path = tmp / "c.vti"
    path.write_text(
        '<VTKFile type="ImageData" version="1.0"'
        ' compressor="vtkZLibDataCompressor">'
        '<ImageData WholeExtent="0 7 0 5 0 3" Spacing="1 1 1">'
        "<Piece><PointData>"
        f'<DataArray type="Float32" Name="s" format="binary">{text}'
        "</DataArray></PointData></Piece></ImageData></VTKFile>")
    return str(path), None


def _vti_appended(tmp, encoding, compressed):
    data = [_vol(1), _vol(2) * 3]
    if compressed:
        payloads = [b"".join(_zlib_blocks(d.astype("<f4").tobytes()))
                    for d in data]
    else:
        payloads = [struct.pack("<I", d.nbytes) + d.astype("<f4").tobytes()
                    for d in data]
    if encoding == "base64":
        payloads = [base64.b64encode(p) for p in payloads]
    offsets = np.cumsum([0] + [len(p) for p in payloads[:-1]])
    arrays = "".join(
        f'<DataArray type="Float32" Name="{n}" format="appended" '
        f'offset="{o}"/>' for n, o in zip(("a", "b"), offsets))
    comp = ' compressor="vtkZLibDataCompressor"' if compressed else ""
    head = (
        f'<?xml version="1.0"?>\n<VTKFile type="ImageData" version="0.1" '
        f'byte_order="LittleEndian"{comp}>\n'
        '<ImageData WholeExtent="0 7 0 5 0 3" Spacing="2 1 0.5">'
        f'<Piece Extent="0 7 0 5 0 3"><PointData>{arrays}</PointData>'
        "</Piece></ImageData>\n"
        f'<AppendedData encoding="{encoding}">_').encode()
    path = tmp / f"app_{encoding}_{int(compressed)}.vti"
    path.write_bytes(head + b"".join(payloads)
                     + b"</AppendedData>\n</VTKFile>")
    return str(path), None


def _vts(tmp):
    vol = _vol()
    zs, ys, xs = vol.shape
    z, y, x = np.meshgrid(np.arange(zs) * 2.0, np.arange(ys) * 1.0,
                          np.arange(xs) * 0.5, indexing="ij")
    pts = " ".join(str(v) for v in np.stack([x, y, z], -1).ravel())
    flat = " ".join(str(v) for v in vol.ravel())
    path = tmp / "g.vts"
    path.write_text(
        '<VTKFile type="StructuredGrid" version="1.0">'
        f'<StructuredGrid WholeExtent="0 {xs-1} 0 {ys-1} 0 {zs-1}">'
        "<Piece><Points>"
        '<DataArray type="Float32" NumberOfComponents="3"'
        f' format="ascii">{pts}</DataArray>'
        "</Points><PointData>"
        f'<DataArray type="Float32" Name="s" format="ascii">{flat}'
        "</DataArray></PointData></Piece></StructuredGrid></VTKFile>")
    return str(path), None


def _legacy_vtk(tmp, binary):
    vol = _vol()
    header = (
        "# vtk DataFile Version 3.0\ntest\n"
        + ("BINARY" if binary else "ASCII")
        + "\nDATASET STRUCTURED_POINTS\nDIMENSIONS 8 6 4\n"
        "SPACING 0.5 1 2\nORIGIN 0 0 0\n"
        "POINT_DATA 192\nSCALARS s float 1\nLOOKUP_TABLE default\n")
    path = tmp / f"l{int(binary)}.vtk"
    body = (vol.astype(">f4").tobytes() if binary
            else " ".join(str(v) for v in vol.ravel()).encode())
    path.write_bytes(header.encode() + body)
    return str(path), None


def _nifti(tmp, gz, datatype, dtype, slope):
    vol = (_vol(3) * 100).astype(dtype)
    header = bytearray(352)
    struct.pack_into("<i", header, 0, 348)
    struct.pack_into("<8h", header, 40, 3, 8, 6, 4, 1, 1, 1, 1)
    struct.pack_into("<h", header, 70, datatype)
    struct.pack_into("<8f", header, 76, 1, 0.5, 1, 2, 1, 1, 1, 1)
    struct.pack_into("<f", header, 108, 352.0)  # vox_offset
    struct.pack_into("<f", header, 112, slope)  # scl_slope
    struct.pack_into("<f", header, 116, 0.25)  # scl_inter
    blob = bytes(header) + vol.tobytes()
    path = tmp / ("t.nii.gz" if gz else "t.nii")
    path.write_bytes(gzip.compress(blob) if gz else blob)
    return str(path), None


def _amira(tmp, little):
    vol = _vol(4)
    header = (
        "# AmiraMesh BINARY-LITTLE-ENDIAN 2.1\n" if little
        else "# AmiraMesh BINARY 2.1\n") + (
        "define Lattice 8 6 4\n"
        "Parameters {\n  BoundingBox 0 3.5 0 2.5 0 6,\n"
        "  CoordType \"uniform\"\n}\n"
        "Lattice { float Density } @1\n\n# Data section follows\n@1\n")
    path = tmp / f"a{int(little)}.am"
    path.write_bytes(header.encode()
                     + vol.astype("<f4" if little else ">f4").tobytes())
    return str(path), None


def _hdf5(tmp, ndim):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(5)
    shape = {3: (4, 6, 8), 4: (2, 4, 6, 8), 5: (3, 2, 4, 6, 8)}[ndim]
    path = str(tmp / f"d{ndim}.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("grp/q", data=rng.normal(size=shape).astype(
            np.float32))
    return path, None


def _field_file(tmp, ftype, ncomp):
    dtype = np.float32 if ftype == 0 else np.float16
    rng = np.random.default_rng(6)
    data = rng.normal(size=(4, 6, 8, ncomp)).astype(dtype)
    path = tmp / f"f{ftype}{ncomp}.field"
    path.write_bytes(struct.pack("<3I3I", 8, 6, 4, 3, 1, ftype)
                     + data.tobytes())
    return str(path), None


def _grib(tmp, name="f.grb2", **kw):
    rng = np.random.default_rng(0)
    t_f = (250 + 30 * rng.random(size=(3, 10, 16))).astype(np.float32)
    u_f = (rng.normal(size=(3, 10, 16)) * 10).astype(np.float32)
    path = str(tmp / name)
    grib.write_grib2(path, {"t": t_f, "u": u_f}, lat=(-30.0, 60.0),
                     lon=(0.0, 150.0), **kw)
    return path, None


def _grib_complex(tmp, packing, group_len=32, nbits=18):
    rng = np.random.default_rng(3)
    base_f = np.cumsum(rng.normal(size=(2, 12, 37)), axis=-1)
    t_f = (250 + base_f + 0.1 * rng.random((2, 12, 37))).astype(np.float32)
    t_f[1, 3, 5:9] = np.nan  # a bitmap
    path = str(tmp / f"{packing}_{group_len}.grb2")
    grib.write_grib2(path, {"t": t_f}, nbits=nbits, packing=packing,
                     group_len=group_len)
    return path, None


def _grib_constant(tmp):
    path = str(tmp / "c.grib")
    grib.write_grib2(path, {"t": np.full((1, 4, 5), 7.25, np.float32)})
    return path, None


def _grib_degenerate(tmp, n):
    f = (np.arange(n, dtype=np.float32).reshape(1, 1, n) + 3.5)
    path = str(tmp / f"deg{n}.grb2")
    grib.write_grib2(path, {"t": f}, nbits=12, packing="complex_diff2")
    return path, None


def _grib_merged_sections(tmp):
    # GRIB2 allows several (4,5,6,7) groups a message: each is a field.
    pa, pb = str(tmp / "a.grb2"), str(tmp / "b.grb2")
    grib.write_grib2(pa, {"t": np.full((1, 4, 5), 280.0, np.float32)})
    grib.write_grib2(pb, {"u": np.full((1, 4, 5), -5.0, np.float32)})
    a, b = open(pa, "rb").read(), open(pb, "rb").read()
    out, pos = [], 16
    while pos < len(b) - 4:
        ln, num = struct.unpack(">IB", b[pos:pos + 5])
        if num in (4, 5, 6, 7):
            out.append(b[pos:pos + ln])
        pos += ln
    body = a[16:-4] + b"".join(out)
    path = str(tmp / "m.grb2")
    open(path, "wb").write(a[:8] + struct.pack(">Q", 16 + len(body) + 4)
                           + body + b"7777")
    return path, None


def _grib_two_dates(tmp, filtered):
    pa, pb = str(tmp / "a.grb2"), str(tmp / "b.grb2")
    grib.write_grib2(pa, {"t": np.full((1, 4, 5), 1.0, np.float32)},
                     date=20200101, time=0)
    grib.write_grib2(pb, {"t": np.full((1, 4, 5), 2.0, np.float32)},
                     date=20200102, time=1200)
    path = str(tmp / "dates.grb2")
    open(path, "wb").write(open(pa, "rb").read() + open(pb, "rb").read())
    return path, ({"date": "20200102", "data_time": "1200"} if filtered
                  else None)


def _grib_custom_names(tmp, n):
    rng = np.random.default_rng(7)
    fields = {f"zz_custom_{i}": rng.normal(size=(1, 4, 6)).astype(
        np.float32) for i in range(n)}
    path = str(tmp / f"many{n}.grb2")
    grib.write_grib2(path, fields)
    return path, None


def _grib_member_series(tmp):
    # One file a member (the ERA5 ensemble's layout at a toy grid).
    rng = np.random.default_rng(9)
    paths = []
    for m in range(3):
        path = str(tmp / f"member{m}.grib2")
        grib.write_grib2(path, {"t": (rng.normal(size=(4, 5, 9)) + m)
                                .astype(np.float32)},
                         levels=[1000.0, 850.0, 500.0, 250.0],
                         lat=(-90.0, 90.0), lon=(0.0, 359.5))
        paths.append(path)
    return paths, None


def _rbc(tmp):
    block = np.random.default_rng(0).normal(size=(8, 4, 8, 4)).astype("<f4")
    path = str(tmp / "snap.bin")
    block.tofile(path)
    return path, None


CASES = {
    "cvol_f32": lambda t: _cvol(t, np.float32),
    "cvol_u8": lambda t: _cvol(t, np.uint8),
    "cvol_u16": lambda t: _cvol(t, np.uint16),
    "mhd_float": lambda t: _mhd(t, "MET_FLOAT", np.float32),
    "mhd_uchar": lambda t: _mhd(t, "MET_UCHAR", np.uint8),
    "mhd_short": lambda t: _mhd(t, "MET_SHORT", np.int16),
    "mhd_double": lambda t: _mhd(t, "MET_DOUBLE", np.float64),
    "ctl_little": lambda t: _ctl(t, False),
    "ctl_big": lambda t: _ctl(t, True),
    "vti_ascii": _vti_ascii,
    "vti_inline_zlib": _vti_inline_zlib,
    "vti_appended_raw": lambda t: _vti_appended(t, "raw", False),
    "vti_appended_raw_zlib": lambda t: _vti_appended(t, "raw", True),
    "vti_appended_base64": lambda t: _vti_appended(t, "base64", False),
    "vts_ascii": _vts,
    "vtk_legacy_binary": lambda t: _legacy_vtk(t, True),
    "vtk_legacy_ascii": lambda t: _legacy_vtk(t, False),
    "nii_f32": lambda t: _nifti(t, False, 16, np.float32, 1.0),
    "nii_gz_i16": lambda t: _nifti(t, True, 4, np.int16, 0.5),
    "nii_gz_u8": lambda t: _nifti(t, True, 2, np.uint8, 2.0),
    "amira_little": lambda t: _amira(t, True),
    "amira_big": lambda t: _amira(t, False),
    "hdf5_3d": lambda t: _hdf5(t, 3),
    "hdf5_4d": lambda t: _hdf5(t, 4),
    "hdf5_5d": lambda t: _hdf5(t, 5),
    "field_f32_vec3": lambda t: _field_file(t, 0, 3),
    "field_f16_vec4": lambda t: _field_file(t, 1, 4),
    "rbc_bin": _rbc,
    "grib_simple": lambda t: _grib(t, nbits=20),
    "grib_simple_16": lambda t: _grib(t, name="s16.grib", nbits=16),
    "grib_complex": lambda t: _grib_complex(t, "complex"),
    "grib_complex_diff1": lambda t: _grib_complex(t, "complex_diff1"),
    "grib_complex_diff2": lambda t: _grib_complex(t, "complex_diff2"),
    "grib_complex_group20": lambda t: _grib_complex(t, "complex", 20, 17),
    "grib_diff2_group20": lambda t: _grib_complex(t, "complex_diff2", 20,
                                                  17),
    "grib_constant": _grib_constant,
    "grib_degenerate1": lambda t: _grib_degenerate(t, 1),
    "grib_degenerate2": lambda t: _grib_degenerate(t, 2),
    "grib_merged_sections": _grib_merged_sections,
    "grib_two_dates": lambda t: _grib_two_dates(t, False),
    "grib_date_filter": lambda t: _grib_two_dates(t, True),
    "grib_custom_names": lambda t: _grib_custom_names(t, 2),
    "grib_70_custom_names": lambda t: _grib_custom_names(t, 70),
    "grib_member_series": _grib_member_series,
}


@pytest.fixture
def small_rbc(monkeypatch):
    """The RBC grid is a fixed 1024x32x1024 block (512 MB): both
    packages' module constants shrink to 8x4x8 for the test."""
    for mod in (rbc, jax_rbc):
        monkeypatch.setattr(mod, "_XS", 8)
        monkeypatch.setattr(mod, "_YS", 4)
        monkeypatch.setattr(mod, "_ZS", 8)


def _load_both(paths, info_kw):
    info = JaxInfo(**info_kw) if info_kw else None
    tinfo = DataSetInformation(**info_kw) if info_kw else None
    return (jax_load_volume(paths, dataset_info=info),
            load_volume(paths, dataset_info=tinfo, device="cpu"))


def _assert_same_fields(jvd, tvd):
    """Metadata equal, and every loaded field of every time step and
    member equal to the bit (NaN where JAX has NaN)."""
    g, tg = jvd.grid, tvd.grid
    assert (g.xs, g.ys, g.zs, g.ts, g.es) == (tg.xs, tg.ys, tg.zs, tg.ts,
                                               tg.es)
    assert (g.dx, g.dy, g.dz) == (tg.dx, tg.dy, tg.dz)
    assert jvd.field_names == tvd.field_names
    for a, b in ((jvd.lat, tvd.lat), (jvd.lon, tvd.lon),
                 (jvd.height, tvd.height)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    for ld, tld in zip(jvd.loaders, tvd.loaders):
        assert type(ld).__name__ == type(tld).__name__
        for attr in ("levels", "time_steps"):
            assert getattr(ld, attr, None) == getattr(tld, attr, None)
    names = jvd.loaders[0].field_names
    assert names == tvd.loaders[0].field_names
    for name in names:
        for t in range(g.ts):
            for e in range(g.es):
                want = np.asarray(jvd.get_field(name, t, e))
                got = tvd.get_field(name, t, e)
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_decoder_loads_as_jax(tmp_path, small_rbc, case):
    paths, info_kw = CASES[case](tmp_path)
    jvd, tvd = _load_both(paths, info_kw)
    _assert_same_fields(jvd, tvd)


def test_registry_holds_every_jax_extension():
    assert sorted(base._LOADER_REGISTRY) == sorted(jax_base._LOADER_REGISTRY)
    for ext, cls in jax_base._LOADER_REGISTRY.items():
        assert base._LOADER_REGISTRY[ext].__name__ == cls.__name__, ext


def test_rbc_wrong_size_raises_like_jax(tmp_path):
    path = str(tmp_path / "bad.bin")
    np.zeros(10, np.float32).tofile(path)
    with pytest.raises(ValueError) as want:
        jax_load_volume(path)
    with pytest.raises(ValueError) as got:
        load_volume(path, device="cpu")
    assert str(got.value) == str(want.value)


def test_rbc_registers_the_velocity_fields(tmp_path, small_rbc):
    path, _ = _rbc(tmp_path)
    vd = load_volume(path, device="cpu")
    for name in ("Vector Magnitude", "Vorticity", "Helicity"):
        assert name in vd.field_names


# -- GRIB2: the writer, the codec and its plain version -----------------------

GRIB_WRITES = {
    "simple": dict(nbits=16),
    "simple_20": dict(nbits=20),
    "complex": dict(packing="complex", nbits=18),
    "complex_diff1": dict(packing="complex_diff1", nbits=15),
    "complex_diff2": dict(packing="complex_diff2", nbits=17,
                          group_len=20),
    "zero_bits": dict(nbits=0),
}


@pytest.mark.parametrize("name", sorted(GRIB_WRITES))
def test_write_grib2_bytes_equal_jax(tmp_path, name):
    rng = np.random.default_rng(11)
    f = np.cumsum(rng.normal(size=(3, 9, 31)), axis=-1).astype(np.float32)
    f[2, 4, 7:12] = np.nan
    fields = {"t": f, "custom": f[::-1] * 2.0}
    kw = dict(GRIB_WRITES[name], levels=[925.0, 500.0, 10.0],
              date=20240229, time=1800, lat=(89.5, -89.5), lon=(-180, 179))
    grib.write_grib2(str(tmp_path / "port.grb2"), fields, **kw)
    jax_grib.write_grib2(str(tmp_path / "jax.grb2"), fields, **kw)
    assert (tmp_path / "port.grb2").read_bytes() == \
        (tmp_path / "jax.grb2").read_bytes()


def _messages(path):
    loader = grib.GribLoader().open(path)
    return loader, [loader._index[k] for k in sorted(loader._index)]


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if c.startswith("grib")))
def test_codec_decodes_as_its_plain_version(tmp_path, case):
    paths, _ = CASES[case](tmp_path)
    packed = 0
    for path in [paths] if isinstance(paths, str) else paths:
        loader, msgs = _messages(path)
        for msg in msgs:
            before = sum(codec.CALLS.values())
            native = grib._decode_values(loader._buf, msg, codec.library())
            # A packed message (nbits > 0) goes through the codec.
            assert (sum(codec.CALLS.values()) > before) == (msg.nbits > 0)
            packed += msg.nbits > 0
            plain = grib._decode_values(loader._buf, msg, None)
            np.testing.assert_array_equal(native, plain)
        loader.close()
    assert packed or case in ("grib_constant", "grib_degenerate1",
                              "grib_merged_sections", "grib_two_dates",
                              "grib_date_filter")


@pytest.mark.parametrize("nbits", [1, 3, 7, 8, 9, 13, 16, 24, 31, 32, 33,
                                   48, 57])
def test_native_unpack_equals_numpy(nbits):
    rng = np.random.default_rng(nbits)
    buf = rng.integers(0, 256, size=512, dtype=np.uint8)
    count = (buf.size * 8 - 13) // nbits
    for offset in (0, 5, 13):
        n = (buf.size * 8 - offset) // nbits
        got = grib._unpack_bits_native(buf, offset, nbits, min(n, count),
                                       codec.library())
        bits = np.unpackbits(buf)[offset:]
        want = grib._unpack_bits_plain(bits, nbits, min(n, count))
        np.testing.assert_array_equal(got, want)


def test_codec_refuses_wide_and_exhausted_streams():
    with pytest.raises(ValueError, match="> 57 unsupported"):
        grib._unpack_bits(b"\0" * 16, 58, 1, codec.library())
    with pytest.raises(ValueError, match="exhausted"):
        grib._unpack_bits(b"\0" * 2, 9, 2, codec.library())


def test_codec_library_is_built_under_build(tmp_path):
    lib = codec.build()
    assert lib.parent.name == "codec" and lib.parent.parent.name == "build"
    assert lib.exists() and lib.suffix == ".so"


def test_missing_gxx_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(codec, "_BUILD_DIR", tmp_path / "codec")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        codec.build()


# -- damaged files -----------------------------------------------------------

def _write_damaged(fmt, path):
    field = np.random.default_rng(0).standard_normal((6, 5, 4)).astype(
        np.float32)
    if fmt == "cvol":
        writers.write_cvol(path, field)
    else:
        grib.write_grib2(path, {"t": field})


def _outcome(load, path):
    """The loaded first field, or the exception's type."""
    try:
        vd = load(path)
        return np.asarray(vd.get_field(vd.field_names[0], 0, 0))
    except Exception as exc:  # noqa: BLE001 - the type is compared
        return type(exc)


def _both_alike(path):
    want = _outcome(jax_load_volume, path)
    got = _outcome(lambda p: load_volume(p, device="cpu"), path)
    if isinstance(want, type):
        assert got is want, (path, got, want)
    else:
        assert not isinstance(got, type), (path, got)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt,ext", [("cvol", ".cvol"), ("grib", ".grib")])
def test_truncations_raise_where_jax_raises(tmp_path, fmt, ext):
    path = str(tmp_path / f"full{ext}")
    _write_damaged(fmt, path)
    blob = open(path, "rb").read()
    rng = np.random.default_rng(1)
    cuts = sorted(set([1, 3, len(blob) // 2, len(blob) - 1]
                      + [int(c) for c in rng.integers(4, len(blob) - 1,
                                                      6)]))
    for cut in cuts:
        tpath = str(tmp_path / f"cut{cut}{ext}")
        with open(tpath, "wb") as f:
            f.write(blob[:cut])
        _both_alike(tpath)


@pytest.mark.parametrize("fmt,ext", [("cvol", ".cvol"), ("grib", ".grib")])
def test_bitflips_decode_as_jax(tmp_path, fmt, ext):
    path = str(tmp_path / f"orig{ext}")
    _write_damaged(fmt, path)
    blob = bytearray(open(path, "rb").read())
    rng = np.random.default_rng(2)
    for trial in range(12):
        mutated = bytearray(blob)
        for pos in rng.integers(0, len(blob), 3):
            mutated[pos] ^= 1 << int(rng.integers(0, 8))
        mpath = str(tmp_path / f"mut{trial}{ext}")
        with open(mpath, "wb") as f:
            f.write(bytes(mutated))
        _both_alike(mpath)


def test_bare_grib_indicator_raises_like_jax(tmp_path):
    path = tmp_path / "x.grib"
    path.write_bytes(b"GRIB")
    _both_alike(str(path))


# -- TorchScript weights -----------------------------------------------------

def _srn(tmp_path):
    import torch.nn as nn

    class SRN(nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = nn.Sequential(nn.Linear(36, 16), nn.ReLU(),
                                         nn.Linear(16, 8))
            self.decoder = nn.Sequential(nn.Linear(16, 16), nn.ReLU(),
                                         nn.Linear(16, 1))

        def forward(self, a, b):
            ea, eb = self.encoder(a), self.encoder(b)
            return self.decoder(torch.cat([ea + eb, (ea - eb).abs()], -1))

    torch.manual_seed(0)
    m = SRN().eval()
    path = str(tmp_path / "srn.pt")
    torch.jit.script(m).save(path)
    return m, path


def _same_weights(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "__meta__":
            assert got[k] == want[k]
        else:
            assert isinstance(got[k], np.ndarray)
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_state_dict_weights_equal_jax(tmp_path):
    torch.manual_seed(1)
    lin = torch.nn.Linear(5, 3)
    path = str(tmp_path / "sd.pt")
    torch.save(lin.state_dict(), path)
    got = read_torch_weights(path)
    _same_weights(got, jax_read_weights(path))
    np.testing.assert_array_equal(got["weight"], lin.weight.detach().numpy())


@pytest.mark.filterwarnings("ignore:.*torch\\.jit\\.script.*:"
                            "DeprecationWarning")
def test_torchscript_weights_equal_jax(tmp_path):
    m, path = _srn(tmp_path)
    got = read_torch_weights(path)
    _same_weights(got, jax_read_weights(path))
    for name, want in m.state_dict().items():
        np.testing.assert_array_equal(got[name], want.numpy(), err_msg=name)


def test_refuses_arbitrary_globals_like_jax(tmp_path):
    evil = io.BytesIO()
    pickle.Pickler(evil, protocol=2).dump(eval)  # GLOBAL builtins.eval
    path = str(tmp_path / "evil.pt")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("m/data.pkl", evil.getvalue())
    with pytest.raises(pickle.UnpicklingError) as want:
        jax_read_weights(path)
    with pytest.raises(pickle.UnpicklingError) as got:
        read_torch_weights(path)
    assert str(got.value) == str(want.value)


def test_bfloat16_weights_come_through_torch(tmp_path):
    torch.manual_seed(2)
    lin = torch.nn.Linear(6, 4).to(torch.bfloat16)
    path = str(tmp_path / "bf16.pt")
    torch.save(lin.state_dict(), path)
    got = read_torch_weights(path)
    want = jax_read_weights(path)  # ml_dtypes.bfloat16 arrays
    for k in ("weight", "bias"):
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k], getattr(lin, k).detach())
        np.testing.assert_array_equal(got[k].view(torch.int16).numpy(),
                                      want[k].view(np.int16))
    out = str(tmp_path / "w.npz")
    arrays = torch_weights_to_npz(path, out)
    with np.load(out) as loaded:
        assert set(loaded.files) == set(arrays) == {"weight", "bias"}
        np.testing.assert_array_equal(loaded["weight"],
                                      lin.weight.detach().float().numpy())


@pytest.mark.filterwarnings("ignore:.*torch\\.jit\\.script.*:"
                            "DeprecationWarning")
def test_npz_conversion_equals_jax(tmp_path):
    from correrender_tpu.io.torchscript import (
        torch_weights_to_npz as jax_to_npz,
    )

    _, path = _srn(tmp_path)
    got = torch_weights_to_npz(path, str(tmp_path / "port.npz"))
    want = jax_to_npz(path, str(tmp_path / "jax.npz"))
    assert set(got) == set(want)
    with np.load(str(tmp_path / "port.npz")) as a, \
            np.load(str(tmp_path / "jax.npz")) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
