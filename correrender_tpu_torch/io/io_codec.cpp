// Native IO codec hot loops of the GRIB2 decoder (loaded via ctypes by
// io/codec.py; the numpy unpack in io/grib.py is its plain version).
// A copy of correrender_tpu/native/io_codec.cpp.
//
// Role parity: the reference's loaders decode through C libraries
// (eccodes for GRIB — src/Loaders/GribLoader.cpp; netCDF; z5). The
// clean-room Python decoders in io/ keep a pure-numpy path, but the
// byte-level inner loop — unpacking big-endian n-bit-wide integers,
// the core of GRIB2 simple AND complex packing — pays an 8x
// bit-expansion plus a (count, nbits) matmul in numpy. This single
// pass allocates nothing.

#include <cstdint>

extern "C" {

// Unpack `count` big-endian `nbits`-wide unsigned integers starting
// `bit_offset` bits into `src`, writing int64 values to `out`.
// nbits in [0, 57]; callers bound-check src length.
void unpack_bits_u64(const uint8_t* src, int64_t bit_offset, int nbits,
                     int64_t count, int64_t* out) {
    if (nbits == 0) {
        for (int64_t i = 0; i < count; ++i) out[i] = 0;
        return;
    }
    int64_t pos = bit_offset;
    for (int64_t i = 0; i < count; ++i) {
        uint64_t v = 0;
        int need = nbits;
        while (need > 0) {
            const int64_t byte = pos >> 3;
            const int bit = pos & 7;
            int take = 8 - bit;
            if (take > need) take = need;
            const uint8_t chunk =
                (uint8_t)((uint8_t)(src[byte] << bit) >> (8 - take));
            v = (v << take) | chunk;
            pos += take;
            need -= take;
        }
        out[i] = (int64_t)v;
    }
}

// GRIB2 complex-packing group expansion: for each group g, unpack
// lens[g] values of widths[g] bits (one contiguous stream, no
// per-group alignment) and add refs[g]. Returns the total bit count
// consumed. Keeping the group loop native avoids `ng` Python-level
// reader calls per field (ng ~ npoints/32).
int64_t unpack_groups_u64(const uint8_t* src, int64_t bit_offset,
                          const int64_t* refs, const int64_t* widths,
                          const int64_t* lens, int64_t ng,
                          int64_t* out) {
    int64_t pos = bit_offset;
    int64_t o = 0;
    for (int64_t g = 0; g < ng; ++g) {
        const int w = (int)widths[g];
        const int64_t n = lens[g];
        const int64_t r = refs[g];
        if (w == 0) {
            for (int64_t i = 0; i < n; ++i) out[o + i] = r;
        } else {
            unpack_bits_u64(src, pos, w, n, out + o);
            for (int64_t i = 0; i < n; ++i) out[o + i] += r;
            pos += (int64_t)w * n;
        }
        o += n;
    }
    return pos - bit_offset;
}

}  // extern "C"
