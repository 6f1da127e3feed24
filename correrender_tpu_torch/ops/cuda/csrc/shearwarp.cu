// K3: fused perspective shear-warp compositor.
//
// Replaces correrender_tpu/ops/pallas/shearwarp_kernel.py::
// shearwarp_composite_pallas. For each intermediate pixel (i, j) and
// each slice k, near to far: resample slice k at the through-eye point
// q = e + (grid − e)·g[k] with the separable tent (bilinear) filter,
// take α = 1 − exp(−τ·Δz·len·atten) from the resampled opacity τ, the
// straight colour rgb/max(τ, ε), and accumulate front-to-back OVER in
// f32. A slice with g ≤ 1e-6 is inert. The optional kstop clips each
// slab's optical thickness by clip(kstop − k, 0, 1).
//
// Rounding follows the reference compositor (render/dvr_fast.py::
// _composite_scan) and the plain version: q is a product and a sum
// rounded apart, the tent weights are rounded to bf16, the resample
// along v is rounded to bf16 before the resample along u, sums are f32.
// Every resample product is then a bf16 value times a bf16 weight,
// exact in f32, so the two-tap sums equal the plain version's dense
// weight products to the bit; the kernel and its plain version differ
// only in how the OVER chain is associated (about 1e-6).
//
// Bound on the H100: operations, 0.157 ms at the 1080p headline (36
// flops a sample over 2.9·10⁸ samples, 250 slices × 1440 × 810). The
// classified volume (125 MB of bf16 RGBA) is mostly served from L2, as
// neighbouring pixels read the same taps.
//
// Design: the tent taps of q along v depend only on (k, i), those along
// u only on (k, j), so a pre-pass (composite_taps_kernel) computes each
// once, S·(hi + wi) of them, into a table of 8-byte entries (the first
// tap's index, and both weights as a bf16 pair; an inert slice or a
// missed footprint has weights 0). The composite (composite_kernel) is
// one thread per ROWS pixels along v of one column, a loop over the S
// slices: it reads the column's u taps once a slice for its ROWS pixels,
// and no sample divides, floors or rounds a weight. The tent filter has
// at most 2×2 nonzero taps, so the TPU's two dense weight-matrix
// products per slice become four 8-byte gathers; taps outside the slice
// count as zero, which is the exact box clipping of dvr_fast.py:27-28.
// The v-resample's eight values are rounded to bf16 in four packed
// conversions (cvt.rn.bf16x2.f32, the bits of round-to-nearest-even one
// by one). The per-sample opacity, al / max(τ, ε) and expf stay exact.
// PERF.md has the times of the variants (inline taps, unpacked
// rounding, 1, 2 and 4 pixels a thread, a warp's exit once every lane's
// α is exactly 1) that correrender_shearwarp_composite_probe runs.

#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-6f;
constexpr int kBlockX = 32;  // a warp's pixels along u
constexpr int kBlockY = 8;
constexpr int kTapThreads = 256;
constexpr int kShippedRows = 2;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The bf16 halves of a 32-bit word as f32 (exact: a shift, a mask).
__device__ __forceinline__ float low_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float high_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Unpacks one 8-byte RGBA tap (four bf16) into f32.
__device__ __forceinline__ float4 unpack(uint2 w) {
  return make_float4(low_bf16(w.x), high_bf16(w.x), low_bf16(w.y),
                     high_bf16(w.y));
}

// Rounds two f32 values to bf16 in one conversion (cvt.rn.bf16x2.f32):
// lo in the low half, hi in the high half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t w;
  memcpy(&w, &h, sizeof(w));
  return w;
}

// The v-resample of one column, w0·a + w1·b per channel, rounded to
// bf16. Every product is a bf16 value times a bf16 weight, exact in
// f32, so the sum is rounded once whichever product an FMA keeps.
template <bool PACKED>
__device__ __forceinline__ float4 resample_v(uint2 a, uint2 b, float w0,
                                             float w1) {
  const float4 fa = unpack(a);
  const float4 fb = unpack(b);
  const float r = w0 * fa.x + w1 * fb.x;
  const float g = w0 * fa.y + w1 * fb.y;
  const float bl = w0 * fa.z + w1 * fb.z;
  const float al = w0 * fa.w + w1 * fb.w;
  if constexpr (PACKED) {
    const uint32_t rg = pack_bf16x2(r, g);
    const uint32_t ba = pack_bf16x2(bl, al);
    return make_float4(low_bf16(rg), high_bf16(rg), low_bf16(ba),
                       high_bf16(ba));
  } else {
    return make_float4(round_bf16(r), round_bf16(g), round_bf16(bl),
                       round_bf16(al));
  }
}

// The two tent taps of q on the voxel centres `coords` (count n,
// spacing d): indices (t, t+1) and their bf16-rounded weights, zero for
// a tap outside [0, n).
__device__ __forceinline__ void taps(float q, const float* __restrict__ coords,
                                     int n, float d, int& t, float& w0,
                                     float& w1) {
  float pos = (q - __ldg(coords)) / d;
  pos = fminf(fmaxf(pos, -2.f), static_cast<float>(n) + 1.f);
  t = static_cast<int>(floorf(pos));
  w0 = 0.f;
  w1 = 0.f;
  if (t >= 0 && t < n) {
    w0 = round_bf16(fmaxf(1.f - fabsf(q - __ldg(coords + t)) / d, 0.f));
  }
  if (t + 1 >= 0 && t + 1 < n) {
    w1 = round_bf16(fmaxf(1.f - fabsf(q - __ldg(coords + t + 1)) / d, 0.f));
  }
}

// A table entry: (t, the bf16 bits of w0 | w1 << 16). Both weights are
// bf16 values, so the pair holds them exactly.
__device__ __forceinline__ uint2 pack_tap(int t, float w0, float w1) {
  return make_uint2(static_cast<uint32_t>(t),
                    (__float_as_uint(w0) >> 16) |
                        (__float_as_uint(w1) & 0xffff0000u));
}

__device__ __forceinline__ void unpack_tap(uint2 e, int& t, float& w0,
                                           float& w1) {
  t = static_cast<int>(e.x);
  w0 = __uint_as_float(e.y << 16);
  w1 = __uint_as_float(e.y & 0xffff0000u);
}

// q = e + (grid − e)·gk: FUSED_Q rounds once (an FMA, as the first
// kernel compiled it), else product and sum apart (the plain version).
template <bool FUSED_Q>
__device__ __forceinline__ float through_eye(float e, float grid, float gk) {
  if constexpr (FUSED_Q) {
    return __fmaf_rn(grid - e, gk, e);
  } else {
    return __fadd_rn(e, __fmul_rn(grid - e, gk));
  }
}

// The pre-pass: taps_v[k·hi + i] and taps_u[k·wi + j] for every slice.
template <bool FUSED_Q>
__global__ void __launch_bounds__(kTapThreads)
composite_taps_kernel(const float* __restrict__ g,
                      const float* __restrict__ coords_y,
                      const float* __restrict__ coords_x,
                      const float* __restrict__ grid_v,
                      const float* __restrict__ grid_u, int s, int yv, int xv,
                      int hi, int wi, float e_u, float e_v,
                      uint2* __restrict__ taps_v, uint2* __restrict__ taps_u) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kTapThreads + threadIdx.x;
  const int per_slice = hi + wi;
  if (idx >= static_cast<long long>(s) * per_slice) return;
  const int k = static_cast<int>(idx / per_slice);
  const int m = static_cast<int>(idx % per_slice);
  const bool along_v = m < hi;
  const float gk = g[k];
  int t = 0;
  float w0 = 0.f, w1 = 0.f;
  if (gk > kEps) {
    if (along_v) {
      const float d = yv > 1 ? coords_y[1] - coords_y[0] : 1.f;
      taps(through_eye<FUSED_Q>(e_v, grid_v[m], gk), coords_y, yv, d, t, w0,
           w1);
    } else {
      const float d = xv > 1 ? coords_x[1] - coords_x[0] : 1.f;
      taps(through_eye<FUSED_Q>(e_u, grid_u[m - hi], gk), coords_x, xv, d, t,
           w0, w1);
    }
  }
  if (along_v) {
    taps_v[static_cast<long long>(k) * hi + m] = pack_tap(t, w0, w1);
  } else {
    taps_u[static_cast<long long>(k) * wi + (m - hi)] = pack_tap(t, w0, w1);
  }
}

struct Geometry {
  const float* g;
  const float* coords_y;
  const float* coords_x;
  const float* grid_v;
  const float* grid_u;
  float e_u, e_v;
};

// TABLED: taps from the pre-pass, else computed per sample as the first
// kernel did (q fused). PACKED: the v-resample rounded in bf16 pairs.
// ROWS: pixels a thread, along v. EXIT: a warp leaves once every lane's
// α is exactly 1 (then 1 − α = 0 and no later slice changes a finite
// sum).
template <bool TABLED, bool PACKED, int ROWS, bool EXIT>
__global__ void __launch_bounds__(kBlockX * kBlockY) composite_kernel(
    const uint2* __restrict__ cf, int s, int yv, int xv, Geometry geo,
    const uint2* __restrict__ taps_v, const uint2* __restrict__ taps_u,
    const float* __restrict__ len_factor, const float* __restrict__ kstop,
    int hi, int wi, float slab_thickness, float attenuation,
    float* __restrict__ rgb, float* __restrict__ alpha) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i0 = (blockIdx.y * kBlockY + threadIdx.y) * ROWS;
  const bool column = j < wi;
  bool live[ROWS];
  float thickness0[ROWS], ks[ROWS], gv[ROWS];
  float acc[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = i0 + r;
    live[r] = column && i < hi;
    const long long pix = static_cast<long long>(i) * wi + j;
    thickness0[r] = live[r] ? slab_thickness * len_factor[pix] : 0.f;
    ks[r] = live[r] && kstop != nullptr ? kstop[pix] : 0.f;
    gv[r] = !TABLED && live[r] ? geo.grid_v[i] : 0.f;
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }
  const float gu = !TABLED && column ? geo.grid_u[j] : 0.f;
  const float dy = yv > 1 ? geo.coords_y[1] - geo.coords_y[0] : 1.f;
  const float dx = xv > 1 ? geo.coords_x[1] - geo.coords_x[0] : 1.f;
  const uint2 zero = make_uint2(0u, 0u);

  for (int k = 0; k < s; ++k) {
    if constexpr (EXIT) {
      bool done = true;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) done = done && (!live[r] || acc[r][3] == 1.f);
      if (__all_sync(0xffffffffu, done)) break;
    }
    int tx;
    float wx0, wx1, gk = 0.f;
    if constexpr (TABLED) {
      unpack_tap(column ? __ldg(taps_u + static_cast<long long>(k) * wi + j)
                        : zero,
                 tx, wx0, wx1);
    } else {
      gk = __ldg(geo.g + k);
      if (!column || !(gk > kEps)) continue;  // inert slice
      taps(through_eye<true>(geo.e_u, gu, gk), geo.coords_x, xv, dx, tx, wx0,
           wx1);
    }
    if (wx0 == 0.f && wx1 == 0.f) continue;
    const uint2* slice = cf + static_cast<long long>(k) * yv * xv;
    const bool in_x0 = tx >= 0 && tx < xv;
    const bool in_x1 = tx + 1 >= 0 && tx + 1 < xv;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (!live[r]) continue;
      int ty;
      float wy0, wy1;
      if constexpr (TABLED) {
        unpack_tap(__ldg(taps_v + static_cast<long long>(k) * hi + i0 + r), ty,
                   wy0, wy1);
      } else {
        taps(through_eye<true>(geo.e_v, gv[r], gk), geo.coords_y, yv, dy, ty,
             wy0, wy1);
      }
      if (wy0 == 0.f && wy1 == 0.f) continue;

      // The four taps at 32-bit offsets from the tap (ty, tx), which may
      // lie outside the slice: a tap outside, or of weight 0, is not read
      // and counts as zero.
      const uint2* p = slice + (ty * xv + tx);
      const bool row0 = wy0 != 0.f, row1 = wy1 != 0.f;
      const uint2 a0 = in_x0 && row0 ? __ldg(p) : zero;
      const uint2 a1 = in_x1 && row0 ? __ldg(p + 1) : zero;
      const uint2 b0 = in_x0 && row1 ? __ldg(p + xv) : zero;
      const uint2 b1 = in_x1 && row1 ? __ldg(p + xv + 1) : zero;
      // The v-resample at columns tx, tx+1, rounded to bf16.
      const float4 col[2] = {resample_v<PACKED>(a0, b0, wy0, wy1),
                             resample_v<PACKED>(a1, b1, wy0, wy1)};
      const float sr = wx0 * col[0].x + wx1 * col[1].x;
      const float sg = wx0 * col[0].y + wx1 * col[1].y;
      const float sb = wx0 * col[0].z + wx1 * col[1].z;
      const float tau = wx0 * col[0].w + wx1 * col[1].w;

      float thickness = thickness0[r];
      if (kstop != nullptr) {
        thickness *= fminf(fmaxf(ks[r] - static_cast<float>(k), 0.f), 1.f);
      }
      const float al = 1.f - expf(-tau * thickness * attenuation);
      const float w = (1.f - acc[r][3]) * (al / fmaxf(tau, kEps));
      acc[r][0] += w * sr;
      acc[r][1] += w * sg;
      acc[r][2] += w * sb;
      acc[r][3] += (1.f - acc[r][3]) * al;
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (!live[r]) continue;
    const long long pix = static_cast<long long>(i0 + r) * wi + j;
    rgb[pix * 3 + 0] = acc[r][0];
    rgb[pix * 3 + 1] = acc[r][1];
    rgb[pix * 3 + 2] = acc[r][2];
    alpha[pix] = acc[r][3];
  }
}

struct Launch {
  const uint2* cf;
  int s, yv, xv;
  Geometry geo;
  uint2* taps;  // S·(hi + wi) entries: the v table, then the u table
  const float* len_factor;
  const float* kstop;
  int hi, wi;
  float slab_thickness, attenuation;
  float* rgb;
  float* alpha;
  cudaStream_t stream;
};

template <bool FUSED_Q>
cudaError_t launch_taps(const Launch& a) {
  const long long entries = static_cast<long long>(a.s) * (a.hi + a.wi);
  if (entries == 0) return cudaSuccess;
  const long long blocks = (entries + kTapThreads - 1) / kTapThreads;
  composite_taps_kernel<FUSED_Q>
      <<<static_cast<unsigned>(blocks), kTapThreads, 0, a.stream>>>(
          a.geo.g, a.geo.coords_y, a.geo.coords_x, a.geo.grid_v,
          a.geo.grid_u, a.s, a.yv, a.xv, a.hi, a.wi, a.geo.e_u, a.geo.e_v,
          a.taps, a.taps + static_cast<long long>(a.s) * a.hi);
  return cudaGetLastError();
}

template <bool TABLED, bool PACKED, int ROWS, bool EXIT>
cudaError_t launch_composite(const Launch& a) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((a.wi + kBlockX - 1) / kBlockX,
                  (a.hi + kBlockY * ROWS - 1) / (kBlockY * ROWS));
  composite_kernel<TABLED, PACKED, ROWS, EXIT>
      <<<grid, block, 0, a.stream>>>(
          a.cf, a.s, a.yv, a.xv, a.geo, a.taps,
          TABLED ? a.taps + static_cast<long long>(a.s) * a.hi : nullptr,
          a.len_factor, a.kstop,
          a.hi, a.wi, a.slab_thickness, a.attenuation, a.rgb, a.alpha);
  return cudaGetLastError();
}

template <bool FUSED_Q, bool PACKED, int ROWS, bool EXIT>
cudaError_t launch_tabled(const Launch& a) {
  cudaError_t err = launch_taps<FUSED_Q>(a);
  if (err != cudaSuccess) return err;
  return launch_composite<true, PACKED, ROWS, EXIT>(a);
}

Launch make_launch(const void* cf, int s, int yv, int xv, const void* g,
                   const void* coords_y, const void* coords_x,
                   const void* grid_v, const void* grid_u,
                   const void* len_factor, const void* kstop, int hi, int wi,
                   float e_u, float e_v, float slab_thickness,
                   float attenuation, void* taps, void* rgb, void* alpha,
                   void* stream) {
  Launch a;
  a.cf = static_cast<const uint2*>(cf);
  a.s = s;
  a.yv = yv;
  a.xv = xv;
  a.geo = Geometry{static_cast<const float*>(g),
                   static_cast<const float*>(coords_y),
                   static_cast<const float*>(coords_x),
                   static_cast<const float*>(grid_v),
                   static_cast<const float*>(grid_u), e_u, e_v};
  a.taps = static_cast<uint2*>(taps);
  a.len_factor = static_cast<const float*>(len_factor);
  a.kstop = static_cast<const float*>(kstop);
  a.hi = hi;
  a.wi = wi;
  a.slab_thickness = slab_thickness;
  a.attenuation = attenuation;
  a.rgb = static_cast<float*>(rgb);
  a.alpha = static_cast<float*>(alpha);
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// `taps`: scratch of S·(hi + wi) 8-byte entries, from the wrapper.
extern "C" int correrender_shearwarp_composite(
    const void* cf, int s, int yv, int xv, const void* g, const void* coords_y,
    const void* coords_x, const void* grid_v, const void* grid_u,
    const void* len_factor, const void* kstop, int hi, int wi, float e_u,
    float e_v, float slab_thickness, float attenuation, void* taps, void* rgb,
    void* alpha, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Launch a = make_launch(cf, s, yv, xv, g, coords_y, coords_x, grid_v,
                               grid_u, len_factor, kstop, hi, wi, e_u, e_v,
                               slab_thickness, attenuation, taps, rgb, alpha,
                               stream);
  return launch_tabled<false, true, kShippedRows, false>(a);
}

// Variants for ops/cuda/ablate_fast_path.py and chip_smoke.py, not on
// any entry point's path (`taps` may be null for probe 1):
//   0 the shipped kernel;
//   1 inline taps, rounded one value at a time, q fused, one pixel a
//     thread: the first kernel's arithmetic;
//   2 tables with q fused as in 1 (its image equals probe 1's);
//   3 unpacked rounding;  4 one pixel a thread;  5 four pixels a thread;
//   6 the warp's exit once every α is exactly 1.
extern "C" int correrender_shearwarp_composite_probe(
    const void* cf, int s, int yv, int xv, const void* g, const void* coords_y,
    const void* coords_x, const void* grid_v, const void* grid_u,
    const void* len_factor, const void* kstop, int hi, int wi, float e_u,
    float e_v, float slab_thickness, float attenuation, void* taps, void* rgb,
    void* alpha, int probe, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Launch a = make_launch(cf, s, yv, xv, g, coords_y, coords_x, grid_v,
                               grid_u, len_factor, kstop, hi, wi, e_u, e_v,
                               slab_thickness, attenuation, taps, rgb, alpha,
                               stream);
  switch (probe) {
    case 0:
      return launch_tabled<false, true, kShippedRows, false>(a);
    case 1:
      return launch_composite<false, false, 1, false>(a);
    case 2:
      return launch_tabled<true, true, kShippedRows, false>(a);
    case 3:
      return launch_tabled<false, false, kShippedRows, false>(a);
    case 4:
      return launch_tabled<false, true, 1, false>(a);
    case 5:
      return launch_tabled<false, true, 4, false>(a);
    case 6:
      return launch_tabled<false, true, kShippedRows, true>(a);
  }
  return cudaErrorInvalidValue;
}
