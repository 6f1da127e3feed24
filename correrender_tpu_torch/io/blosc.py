"""Native Blosc1 frame decoder (Zarr's default compressor family).

A copy of ``correrender_tpu/io/blosc.py``.

The reference reads blosc-compressed Zarr stores through z5 + c-blosc
(CMakeLists.txt:401-411). Neither python-blosc nor numcodecs is
required here: this module decodes the c-blosc1 container format
directly:

  16-byte header: version, versionlz, flags, typesize, nbytes,
  blocksize, cbytes (little-endian); then either the raw buffer
  (memcpy flag) or an int32 offset table addressing per-block streams,
  each ``[int32 csize][payload]`` — stored verbatim when csize equals
  the block's uncompressed size.

Inner codecs: zlib (stdlib), zstd (the ``zstandard`` wheel), lz4
(ctypes onto the system ``liblz4.so`` — ``LZ4_decompress_safe``; the
lz4hc encoder emits plain lz4 block streams). Byte-shuffle and
bitshuffle are undone per block with numpy transposes/bit unpacking;
snappy raises a clear error (not seen in practice for Zarr stores).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
import zlib

import numpy as np

_CODEC_NAMES = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}

_MEMCPYED = 0x2
_BYTE_SHUFFLE = 0x1
_BIT_SHUFFLE = 0x4

_lz4 = None


def _lz4_lib():
    global _lz4
    if _lz4 is None:
        name = ctypes.util.find_library("lz4") or "liblz4.so.1"
        lib = ctypes.CDLL(name)
        lib.LZ4_decompress_safe.restype = ctypes.c_int
        lib.LZ4_decompress_safe.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ]
        _lz4 = lib
    return _lz4


def _decompress_block(codec: int, payload: bytes, dst_size: int) -> bytes:
    if codec == 1:  # lz4 / lz4hc
        out = ctypes.create_string_buffer(dst_size)
        n = _lz4_lib().LZ4_decompress_safe(
            payload, out, len(payload), dst_size
        )
        if n != dst_size:
            raise ValueError(
                f"lz4 block decode failed (got {n}, want {dst_size})"
            )
        return out.raw
    if codec == 3:
        return zlib.decompress(payload)
    if codec == 4:
        import zstandard

        return zstandard.ZstdDecompressor().decompress(
            payload, max_output_size=dst_size
        )
    raise NotImplementedError(
        f"blosc inner codec {_CODEC_NAMES.get(codec, codec)!r} not "
        "supported (lz4/zlib/zstd only)"
    )


def _bit_unshuffle(block: bytes, typesize: int) -> bytes:
    """Inverse bitshuffle (kitaev/bitshuffle scalar semantics).

    Forward layout: for n elements of T bytes, the first n−n%8
    elements become T·8 bit planes of (n−n%8)/8 bytes — plane
    (b·8+k)'s byte j carries, as bit i (LSB-first), bit k of byte b
    of element 8j+i; the ≤7 remaining elements are stored unshuffled
    after the planes (bshuf_trans_bit_elem's remainder memcpy).
    Validated on hand-computed vectors + encode/decode round-trips.
    """
    if typesize < 1:
        return block
    n = len(block) // typesize
    nkeep = n - n % 8
    split = nkeep * typesize
    if nkeep == 0:
        return block
    planes = np.frombuffer(block[:split], np.uint8).reshape(
        typesize * 8, nkeep // 8
    )
    bits = np.unpackbits(planes, axis=1, bitorder="little")
    # bits[b*8+k, e] = bit k of byte b of element e
    bits = bits.reshape(typesize, 8, nkeep).transpose(2, 0, 1)
    arr = np.packbits(
        bits.reshape(nkeep, typesize, 8), axis=2, bitorder="little"
    )[..., 0]
    return arr.tobytes() + block[split:]


def _bit_shuffle(block: bytes, typesize: int) -> bytes:
    """Forward bitshuffle (see :func:`_bit_unshuffle`)."""
    if typesize < 1:
        return block
    n = len(block) // typesize
    nkeep = n - n % 8
    split = nkeep * typesize
    if nkeep == 0:
        return block
    arr = np.frombuffer(block[:split], np.uint8).reshape(
        nkeep, typesize
    )
    bits = np.unpackbits(
        arr[..., None], axis=2, bitorder="little"
    )  # (n, T, 8)
    planes = bits.transpose(1, 2, 0).reshape(typesize * 8, nkeep)
    out = np.packbits(planes, axis=1, bitorder="little")
    return out.tobytes() + block[split:]


def _unshuffle(block: bytes, typesize: int) -> bytes:
    """Inverse byte shuffle: c-blosc shuffles whole items only; any
    trailing remainder bytes are stored unshuffled."""
    if typesize <= 1:
        return block
    items = len(block) // typesize
    split = items * typesize
    body = np.frombuffer(block[:split], np.uint8)
    out = body.reshape(typesize, items).T.tobytes()
    return out + block[split:]


def blosc_decompress(frame: bytes) -> bytes:
    """Decode one Blosc1 frame to its raw bytes."""
    if len(frame) < 16:
        raise ValueError("blosc frame shorter than its header")
    _version, _versionlz, flags, typesize = frame[0], frame[1], frame[2], \
        frame[3]
    nbytes, blocksize, cbytes = struct.unpack("<III", frame[4:16])
    if cbytes != len(frame):
        # Tolerate trailing bytes (some writers pad) but not short reads.
        if cbytes > len(frame):
            raise ValueError("truncated blosc frame")
    if flags & _MEMCPYED:
        return frame[16:16 + nbytes]
    if nbytes == 0:
        return b""

    codec = (flags >> 5) & 0x7
    nblocks = -(-nbytes // blocksize)
    offsets = struct.unpack(
        f"<{nblocks}i", frame[16:16 + 4 * nblocks]
    )
    shuffle = bool(flags & _BYTE_SHUFFLE)
    bitshuffle = bool(flags & _BIT_SHUFFLE)
    out = bytearray()
    for b, off in enumerate(offsets):
        dst_size = min(blocksize, nbytes - b * blocksize)
        (csize,) = struct.unpack("<i", frame[off:off + 4])
        payload = frame[off + 4:off + 4 + csize]
        if csize == dst_size:  # stored verbatim
            block = payload
        else:
            block = _decompress_block(codec, payload, dst_size)
        if bitshuffle:
            block = _bit_unshuffle(block, typesize)
        elif shuffle:
            block = _unshuffle(block, typesize)
        out += block
    return bytes(out)


def blosc_compress(
    data: bytes,
    typesize: int = 4,
    cname: str = "lz4",
    blocksize: int = 1 << 18,
    shuffle: bool | str = True,
) -> bytes:
    """Encode a Blosc1 frame (round-trip/testing counterpart).

    ``shuffle`` accepts ``False``, ``True`` (byte shuffle), or
    ``"bit"`` (bitshuffle). Uses zlib or zstd encoders (lz4 encoding
    would need the system lib's compress entry points; decode-side
    lz4 support is what matters for reading real stores)."""
    codec = {"zlib": 3, "zstd": 4}.get(cname)
    if codec is None:
        raise NotImplementedError(
            f"blosc_compress supports zlib/zstd, not {cname!r}"
        )
    nbytes = len(data)
    nblocks = -(-nbytes // blocksize)
    bitshuffle = shuffle == "bit"
    flags = (codec << 5) | (
        _BIT_SHUFFLE if bitshuffle else (_BYTE_SHUFFLE if shuffle else 0)
    )
    blocks = []
    for b in range(nblocks):
        raw = data[b * blocksize:(b + 1) * blocksize]
        if bitshuffle:
            raw = _bit_shuffle(raw, typesize)
        elif shuffle and typesize > 1:
            items = len(raw) // typesize
            split = items * typesize
            body = np.frombuffer(raw[:split], np.uint8)
            raw = body.reshape(items, typesize).T.tobytes() + raw[split:]
        if codec == 3:
            comp = zlib.compress(raw)
        else:
            import zstandard

            comp = zstandard.ZstdCompressor().compress(raw)
        if len(comp) >= len(raw):
            comp = raw  # store verbatim
        blocks.append(comp)
    header_len = 16 + 4 * nblocks
    offsets = []
    pos = header_len
    for b, comp in enumerate(blocks):
        offsets.append(pos)
        pos += 4 + len(comp)
    frame = bytearray()
    frame += struct.pack(
        "<BBBB", 2, 0, flags, min(typesize, 255)
    )
    frame += struct.pack("<III", nbytes, blocksize, pos)
    frame += struct.pack(f"<{nblocks}i", *offsets)
    for b, comp in enumerate(blocks):
        frame += struct.pack("<i", len(comp))
        frame += comp
    return bytes(frame)
