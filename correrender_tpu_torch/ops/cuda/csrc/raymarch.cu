// B5 (exact plane-order DVR) and B6 (the isosurface's first hit), one
// thread per pixel ray.
//
// B5 replaces correrender_tpu/ops/pallas/raymarch_kernel.py::
// dvr_raymarch (kernel body _make_dvr_kernel), B6 replaces iso_raymarch
// (_make_iso_kernel). Per ray each computes what its TPU kernel
// computes, without the TPU's structure: no bricks, no lane rolls, no
// tent-weight matrix products, no DMA ring (the iso kernel's six-slot
// plane ring only kept its refinement's planes resident). The volume arrives permuted
// to (A, S, L) — planes along the principal axis, front to back — with
// NaN replaced by a 1e30 sentinel (ops/cuda/raymarch_kernel.py::
// prepare_raymarch_volume). Each ray marches its own slab window
// k ∈ [klo, khi] and the q sub-steps of each slab, front to back:
//
//   γ = g0 + (k − 1)·gk + s·gs,  raw_u = u0c + γ·su,  raw_v = v0c + γ·sv
//   sample = z-lerp of planes clip(k − 1), clip(k) at (s + 0.5)/q of the
//            bilinear sample at (clamp(raw_u), clamp(raw_v))
//   active on t = γ·inv_da ∈ [t0, t1] (t1 already holds a depth limit)
//            and inside the restriction ball (tested on raw_u, raw_v)
//   sample > 1e20 ⇒ NaN (sentinel) ⇒ nan_mode; the transfer function
//   alpha = 1 − exp(−tf_a·dt·atten), dt = dt_unit·|inv_da|; OVER
//
// The ray stops once its alpha reaches 0.999 (the reference shader's
// per-ray rule; the TPU kernel stopped whole 8×128 subtiles).
//
// B6 marches the same samples and stops at the first sign change of
// f = sample − iso between two active samples (a sample is active on
// [t0, t1] and when it does not touch a NaN voxel; the previous active
// sample carries across slabs). With refine_steps > 0 it bisects the
// crossing in γ over [γ_hit − gs, γ_hit] with true trilinear samples
// (z = clip((γ − g0p)/gk, 0, planes − 1), u and v clamped as in the
// march) and takes central differences of ±1 voxel along (principal,
// sub, lane) at the refined point; it writes (found, t_surf, gA, gS, gL).
// With refine_steps == 0 it writes the bracket (found, t_hit, f_lo,
// f_hi, 0) for the torch solvers.
//
// Precision: plain f32 arithmetic, no tensor cores and no texture
// filtering (its 8-bit fractional weights would miss the bars). The
// positions that decide whether a sample counts (γ, t, raw_u, raw_v and
// the ball distances) use __fadd_rn / __fmul_rn, which the compiler
// never contracts into FMAs, so every such test rounds as in the plain
// PyTorch version: a flipped test at the box entry would change a DVR
// pixel by a whole sample's alpha. B6 also rounds the sample value
// itself op by op (sample_slab: which side of the iso value it lies on
// moves a hit by a whole sub-step). B5 does not: its sample value
// (CellTaps::sample) contracts into FMAs, indexes a plane with 32-bit
// offsets and keeps a ray's eight taps while its samples stay in one
// cell, about 1e-7 from the plain version's value.
//
// B5's transfer function is the same piecewise-linear function as the
// plain version's hinge sum, in segment form (raymarch_kernel.py::
// tf_segments): per knot i the four channels' value at the knot and the
// slope to the next (0 after the last), rounded to f32 once from
// float64. A block copies the table from its parameter block into shared
// memory once; per sample a binary search over the knots (ceil(log2 K)
// steps, unrolled: 2 for config 1's 3 knots, at most 5) finds the
// segment, and c = value_i + slope_i·(u − knot_i) is 4 FMAs. The table
// stays out of the constant bank in the loop: a divergent index there
// serialises.
//
// Bound on the H100: the arithmetic per sample, and the eight loads of
// each cell a ray enters, served by L1 and L2. B5's warps cover 8 × 4 pixel
// tiles (kDvrTileWidth; 32 × 1 rows, B6's shape, are the other
// variant), whose rays sample a compact patch of voxels and end at
// similar depths. The scalars travel in the parameter block (constant
// bank), read uniformly by every thread.
//
// correrender_raymarch_dvr_probe launches variants of B5 for
// ops/cuda/ablate_raymarch.py only: the other tile, and probes that
// change the answer on purpose (no TF search, one tap, no expf), with
// the samples each variant took counted.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxKnots = 24;
constexpr int kKnotSlots = 32;  // the search's table: knots, then +inf
constexpr float kNanThresh = 1e20f;
constexpr float kExitAlpha = 0.999f;
constexpr int kDvrTileWidth = 8;  // B5's warp tile: 8 × 4 pixels
constexpr int kBlockThreads = 256;

// Probes of B5 (ablate_raymarch.py).
constexpr int kShipped = 0, kNoTfSearch = 1, kOneTap = 2, kNoExp = 3;

struct RayParams {
  // g0 gk gs u_max v_max u0c v0c atten vmin inv_vspan dt_unit inv_q
  // r_gc r_cs r_cl r_rad vox_s vox_l
  float p[18];
  float knots[kKnotSlots];       // ascending, +inf past the last
  float seg[kMaxKnots][8];       // value_0..3, slope_0..3 per knot
  int k, q, nan_mode, restriction, planes, sub, lane, width, height;
};

// Slab window of a ray: slab k holds γ ∈ [g0 + (k − 1)·gk, g0 + k·gk);
// [klo, khi] covers every γ in [t0·da, t1·da] with a slab to spare, so
// skipping the slabs outside it changes nothing.
__device__ __forceinline__ void slab_window(float t0, float t1, float inv_da,
                                            float g0, float gk, int planes,
                                            int* klo, int* khi) {
  const float da = 1.f / inv_da;
  const float planes_f = static_cast<float>(planes);
  const float lo_f = fminf(fmaxf(floorf((t0 * da - g0) / gk), -1.f),
                           planes_f + 1.f);
  const float hi_f = fminf(fmaxf(ceilf((t1 * da - g0) / gk) + 1.f, -1.f),
                           planes_f);
  *klo = max(static_cast<int>(lo_f), 0);
  *khi = static_cast<int>(hi_f);
}

// γ of sub-step s in the slab whose first sub-step is at gbase.
__device__ __forceinline__ float gamma_at(float gbase, int s, float gs) {
  return __fadd_rn(gbase, __fmul_rn(static_cast<float>(s), gs));
}

// The z-lerp by wz between planes plo and phi of the bilinear sample at
// (clamp(raw_u), clamp(raw_v)), every product and sum rounded on its own
// in the plain version's order.
__device__ __forceinline__ float sample_slab(
    const float* __restrict__ plo, const float* __restrict__ phi, float wz,
    float raw_u, float raw_v, float u_max, float v_max, int sub, int lane) {
  const float uc = fminf(fmaxf(raw_u, 0.f), u_max);
  const float vc = fminf(fmaxf(raw_v, 0.f), v_max);
  const int iu = min(static_cast<int>(uc), sub - 1);
  const int iv = min(static_cast<int>(vc), lane - 1);
  const float fu = uc - static_cast<float>(iu);
  const float fv = vc - static_cast<float>(iv);
  const long long r0 = static_cast<long long>(iu) * lane;
  const long long r1 = static_cast<long long>(min(iu + 1, sub - 1)) * lane;
  const int iv1 = min(iv + 1, lane - 1);
  const float wl = 1.f - wz;
  const auto tap = [&](long long i) {
    return __fadd_rn(__fmul_rn(wl, __ldg(plo + i)), __fmul_rn(wz, __ldg(phi + i)));
  };
  const float gu = 1.f - fu, gv = 1.f - fv;
  const float a = __fadd_rn(__fmul_rn(gv, tap(r0 + iv)), __fmul_rn(fv, tap(r0 + iv1)));
  const float b = __fadd_rn(__fmul_rn(gv, tap(r1 + iv)), __fmul_rn(fv, tap(r1 + iv1)));
  return __fadd_rn(__fmul_rn(gu, a), __fmul_rn(fu, b));
}

// B5's sample: the z-lerp by wz between the slab's two planes of the
// bilinear sample at (clamp(raw_u), clamp(raw_v)), in the plain
// version's formula with products and sums left to contract into FMAs.
// The eight taps sit at 32-bit offsets from the slab's 64-bit plane
// pointer plo: (iu, iv), + dv, + du, + du + dv, and the same + dz in the
// far plane, with du = lane and dv = 1 where the volume has two voxels
// along the axis (else 0). The cell's corner is kept one voxel inside the
// far edge (iu ≤ sub − 2), where the weight fu = 1 gives the edge voxel's
// value exactly as the plain version's clamped taps do (1·b + 0·a). A ray
// keeps its cell's taps while its samples stay in that cell of the slab,
// so a sample loads only where its ray enters a new cell; the value is
// the same either way.
struct CellTaps {
  int cell = -1;  // the cell's offset in the plane; -1: none loaded
  float lo[4], hi[4];

  __device__ __forceinline__ float sample(const float* __restrict__ plo,
                                          int dz, float wz, float raw_u,
                                          float raw_v, float u_max,
                                          float v_max, int iu_max,
                                          int iv_max, int du, int dv,
                                          int lane) {
    const float uc = fminf(fmaxf(raw_u, 0.f), u_max);
    const float vc = fminf(fmaxf(raw_v, 0.f), v_max);
    const int iu = min(static_cast<int>(uc), iu_max);
    const int iv = min(static_cast<int>(vc), iv_max);
    const float fu = uc - static_cast<float>(iu);
    const float fv = vc - static_cast<float>(iv);
    const int off = iu * lane + iv;
    if (off != cell) {
      cell = off;
      const float* __restrict__ p = plo + off;
      const int at[4] = {0, dv, du, du + dv};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        lo[t] = __ldg(p + at[t]);
        hi[t] = __ldg(p + dz + at[t]);
      }
    }
    const float wl = 1.f - wz;
    const float gv = 1.f - fv;
    const float a =
        gv * (wl * lo[0] + wz * hi[0]) + fv * (wl * lo[1] + wz * hi[1]);
    const float b =
        gv * (wl * lo[2] + wz * hi[2]) + fv * (wl * lo[3] + wz * hi[3]);
    return (1.f - fu) * a + fu * b;
  }
};

// Warp tile TW × (32 / TW) pixels; a block of 8 warps covers 32 × 8.
template <int TW>
__device__ __forceinline__ void tile_pixel(int* x, int* y) {
  constexpr int kTileH = 32 / TW, kWarpsX = 32 / TW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  *x = blockIdx.x * 32 + (warp % kWarpsX) * TW + lane % TW;
  *y = blockIdx.y * 8 + (warp / kWarpsX) * kTileH + lane / TW;
}

// STEPS: the binary search's steps, 2^STEPS ≥ K (knot slots past K
// hold +inf).
template <int TW, int PROBE, int STEPS>
__global__ void __launch_bounds__(kBlockThreads) raymarch_dvr_kernel(
    const float* __restrict__ vol, const float* __restrict__ fields,
    const __grid_constant__ RayParams P, float* __restrict__ rgb,
    float* __restrict__ alpha, unsigned long long* __restrict__ samples) {
  __shared__ float s_knots[kKnotSlots];
  __shared__ float4 s_seg[kMaxKnots][2];
  if (threadIdx.x < kKnotSlots) s_knots[threadIdx.x] = P.knots[threadIdx.x];
  if (threadIdx.x < 8 * P.k) {
    reinterpret_cast<float*>(s_seg)[threadIdx.x] =
        P.seg[threadIdx.x / 8][threadIdx.x % 8];
  }
  __syncthreads();
  int x, y;
  tile_pixel<TW>(&x, &y);
  if (x >= P.width || y >= P.height) return;
  const float g0 = P.p[0], gk = P.p[1], gs = P.p[2];
  const float u_max = P.p[3], v_max = P.p[4], u0c = P.p[5], v0c = P.p[6];
  const float atten = P.p[7], vmin = P.p[8], inv_vspan = P.p[9];
  const float dt_unit = P.p[10], inv_q = P.p[11];
  const float r_gc = P.p[12], r_cs = P.p[13], r_cl = P.p[14];
  const float r_rad = P.p[15], vox_s = P.p[16], vox_l = P.p[17];

  const long long n = static_cast<long long>(P.width) * P.height;
  const long long p = static_cast<long long>(y) * P.width + x;
  const float su = fields[p];
  const float sv = fields[n + p];
  const float inv_da = fields[2 * n + p];
  const float t0 = fields[3 * n + p];
  const float t1 = fields[4 * n + p];

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_a = 0.f;
  unsigned taken = 0;
  if (t1 >= t0) {  // the ray meets the box in front of its depth limit
    const float dt = dt_unit * fabsf(inv_da);
    int klo, khi;
    slab_window(t0, t1, inv_da, g0, gk, P.planes, &klo, &khi);
    const int plane = P.sub * P.lane;  // ≤ 2³⁰ (checked at launch)
    const int iu_max = max(P.sub - 2, 0), iv_max = max(P.lane - 2, 0);
    const int du = P.sub > 1 ? P.lane : 0, dv = P.lane > 1 ? 1 : 0;
    bool done = false;
    for (int kk = klo; kk <= khi && !done; ++kk) {
      const int zlo = max(kk - 1, 0), zhi = min(kk, P.planes - 1);
      const float* __restrict__ plo =
          vol + static_cast<long long>(zlo) * plane;
      const int dz = (zhi - zlo) * plane;
      CellTaps taps;
      const float gbase = __fadd_rn(g0, __fmul_rn(static_cast<float>(kk - 1), gk));
      for (int s = 0; s < P.q; ++s) {
        const float gamma = gamma_at(gbase, s, gs);
        const float t = __fmul_rn(gamma, inv_da);
        if (!(t >= t0 && t <= t1)) continue;  // inactive: adds exactly 0
        const float raw_u = __fadd_rn(u0c, __fmul_rn(gamma, su));
        const float raw_v = __fadd_rn(v0c, __fmul_rn(gamma, sv));
        if (P.restriction != 0) {
          const float d_a = fabsf(__fadd_rn(gamma, -r_gc));
          const float d_s = __fmul_rn(fabsf(__fadd_rn(raw_u, -r_cs)), vox_s);
          const float d_l = __fmul_rn(fabsf(__fadd_rn(raw_v, -r_cl)), vox_l);
          bool inside;
          if (P.restriction == 2) {  // Chebyshev
            inside = fmaxf(fmaxf(d_s, d_l), d_a) <= r_rad;
          } else {  // Euclidean
            const float sq = __fadd_rn(
                __fadd_rn(__fmul_rn(d_a, d_a), __fmul_rn(d_s, d_s)),
                __fmul_rn(d_l, d_l));
            inside = sq <= __fmul_rn(r_rad, r_rad);
          }
          if (!inside) continue;
        }
        ++taken;
        const float wz = (static_cast<float>(s) + 0.5f) * inv_q;
        float val;
        if (PROBE == kOneTap) {
          const float uc = fminf(fmaxf(raw_u, 0.f), u_max);
          const float vc = fminf(fmaxf(raw_v, 0.f), v_max);
          val = __ldg(plo + static_cast<int>(uc) * P.lane +
                      static_cast<int>(vc));
        } else {
          val = taps.sample(plo, dz, wz, raw_u, raw_v, u_max, v_max, iu_max,
                            iv_max, du, dv, P.lane);
        }

        const float u = fminf(fmaxf((val - vmin) * inv_vspan, 0.f), 1.f);
        int i = 0;  // the last knot ≤ u (knot 0 is ≤ 0)
        if (PROBE == kNoTfSearch) {
          i = min(static_cast<int>(u * static_cast<float>(P.k - 1)), P.k - 1);
        } else {
#pragma unroll
          for (int step = 1 << (STEPS - 1); step > 0; step >>= 1) {
            if (s_knots[i + step] <= u) i += step;
          }
        }
        const float4 value = s_seg[i][0], slope = s_seg[i][1];
        const float h = u - s_knots[i];
        float c0 = fmaf(slope.x, h, value.x);
        float c1 = fmaf(slope.y, h, value.y);
        float c2 = fmaf(slope.z, h, value.z);
        float c3 = fmaf(slope.w, h, value.w);
        if (val > kNanThresh) {  // the sample touches a NaN voxel
          if (P.nan_mode == 1) {  // yellow
            c0 = 1.f;
            c1 = 1.f;
            c2 = 0.f;
            c3 = 1.f;
          } else {
            c3 = 0.f;
          }
        }
        const float tau = c3 * dt * atten;
        const float a_s = PROBE == kNoExp ? fminf(tau, 1.f) : 1.f - expf(-tau);
        const float w = (1.f - acc_a) * a_s;
        acc_r += w * c0;
        acc_g += w * c1;
        acc_b += w * c2;
        acc_a += w;
        if (acc_a >= kExitAlpha) {
          done = true;
          break;
        }
      }
    }
  }
  rgb[3 * p] = acc_r;
  rgb[3 * p + 1] = acc_g;
  rgb[3 * p + 2] = acc_b;
  alpha[p] = acc_a;
  if (samples != nullptr) {
    atomicAdd(samples, static_cast<unsigned long long>(taken));
  }
}

struct IsoParams {
  // g0 gk gs u_max v_max u0c v0c iso g0p inv_ga inv_q
  float p[11];
  int q, refine_steps, planes, sub, lane, width, height;
};

// Trilinear sample at a per-ray γ plus voxel offsets (dz along the
// principal axis, du, dv in the plane), clamped to the volume's centres.
__device__ __forceinline__ float sample_ray(
    const float* __restrict__ vol, const IsoParams& P, float gamma, float su,
    float sv, float du, float dv, float dz) {
  const float zc = fminf(
      fmaxf(__fadd_rn(__fmul_rn(__fadd_rn(gamma, -P.p[8]), P.p[9]), dz), 0.f),
      static_cast<float>(P.planes - 1));
  const int iz = min(static_cast<int>(zc), P.planes - 1);
  const float fz = zc - static_cast<float>(iz);
  const long long plane = static_cast<long long>(P.sub) * P.lane;
  const float raw_u = __fadd_rn(__fadd_rn(P.p[5], __fmul_rn(gamma, su)), du);
  const float raw_v = __fadd_rn(__fadd_rn(P.p[6], __fmul_rn(gamma, sv)), dv);
  return sample_slab(vol + iz * plane, vol + min(iz + 1, P.planes - 1) * plane,
                     fz, raw_u, raw_v, P.p[3], P.p[4], P.sub, P.lane);
}

__global__ void __launch_bounds__(256) raymarch_iso_kernel(
    const float* __restrict__ vol, const float* __restrict__ fields,
    const __grid_constant__ IsoParams P, float* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= P.width || y >= P.height) return;
  const float g0 = P.p[0], gk = P.p[1], gs = P.p[2];
  const float u_max = P.p[3], v_max = P.p[4], u0c = P.p[5], v0c = P.p[6];
  const float iso = P.p[7], inv_q = P.p[10];

  const long long n = static_cast<long long>(P.width) * P.height;
  const long long p = static_cast<long long>(y) * P.width + x;
  const float su = fields[p];
  const float sv = fields[n + p];
  const float inv_da = fields[2 * n + p];
  const float t0 = fields[3 * n + p];
  const float t1 = fields[4 * n + p];

  bool found = false;
  float t_hit = 0.f, f_lo = 0.f, f_hi = 0.f;
  if (t1 >= t0) {
    int klo, khi;
    slab_window(t0, t1, inv_da, g0, gk, P.planes, &klo, &khi);
    const long long plane = static_cast<long long>(P.sub) * P.lane;
    bool have_prev = false;
    float prev = 0.f;
    for (int kk = klo; kk <= khi && !found; ++kk) {
      const float* __restrict__ plo = vol + max(kk - 1, 0) * plane;
      const float* __restrict__ phi = vol + min(kk, P.planes - 1) * plane;
      const float gbase = __fadd_rn(g0, __fmul_rn(static_cast<float>(kk - 1), gk));
      for (int s = 0; s < P.q; ++s) {
        const float gamma = gamma_at(gbase, s, gs);
        const float t = __fmul_rn(gamma, inv_da);
        if (!(t >= t0 && t <= t1)) continue;
        const float wz = (static_cast<float>(s) + 0.5f) * inv_q;
        const float val = sample_slab(
            plo, phi, wz, __fadd_rn(u0c, __fmul_rn(gamma, su)),
            __fadd_rn(v0c, __fmul_rn(gamma, sv)), u_max, v_max, P.sub, P.lane);
        if (!(val < kNanThresh)) continue;  // touches a NaN voxel: inactive
        const float f = __fadd_rn(val, -iso);
        if (have_prev && ((f >= 0.f) != (prev >= 0.f))) {
          found = true;
          t_hit = t;
          f_lo = prev;
          f_hi = f;
          break;
        }
        prev = f;
        have_prev = true;
      }
    }
  }
  float o1 = t_hit, o2 = f_lo, o3 = f_hi, o4 = 0.f;
  if (!found) {
    o1 = o2 = o3 = 0.f;
  } else if (P.refine_steps > 0) {
    // Bisection in γ over [γ_hit − gs, γ_hit] (γ_hit = t_hit·da, as the
    // TPU kernel recovers it), then ±1-voxel central differences.
    float ghi = __fmul_rn(t_hit, __fdiv_rn(1.f, inv_da));
    float glo = __fadd_rn(ghi, -gs);
    float fl = f_lo;
    for (int r = 0; r < P.refine_steps; ++r) {
      const float gm = __fmul_rn(0.5f, __fadd_rn(glo, ghi));
      const float fm = __fadd_rn(sample_ray(vol, P, gm, su, sv, 0.f, 0.f, 0.f), -iso);
      if ((fm >= 0.f) == (fl >= 0.f)) {
        glo = gm;
        fl = fm;
      } else {
        ghi = gm;
      }
    }
    const float g = __fmul_rn(0.5f, __fadd_rn(glo, ghi));
    o1 = __fmul_rn(g, inv_da);
    o2 = __fadd_rn(sample_ray(vol, P, g, su, sv, 0.f, 0.f, 1.f),
                   -sample_ray(vol, P, g, su, sv, 0.f, 0.f, -1.f));
    o3 = __fadd_rn(sample_ray(vol, P, g, su, sv, 1.f, 0.f, 0.f),
                   -sample_ray(vol, P, g, su, sv, -1.f, 0.f, 0.f));
    o4 = __fadd_rn(sample_ray(vol, P, g, su, sv, 0.f, 1.f, 0.f),
                   -sample_ray(vol, P, g, su, sv, 0.f, -1.f, 0.f));
  }
  out[p] = found ? 1.f : 0.f;
  out[n + p] = o1;
  out[2 * n + p] = o2;
  out[3 * n + p] = o3;
  out[4 * n + p] = o4;
}

// B5's launch: the segment table in the parameter block, the warp tile
// TW and probe PROBE; `samples` (nullable) receives the samples taken.
// The search takes ceil(log2 K) steps (at least 1), a template argument.
template <int TW, int PROBE>
int launch_dvr(const void* vol, int planes, int sub_extent, int lane_extent,
               const void* fields, int width, int height, const void* params,
               const void* tfp, int k, int q, int nan_mode, int restriction,
               void* rgb, void* alpha, void* samples, int device,
               void* stream) {
  if (k < 1 || k > kMaxKnots || q < 1 || planes < 1 || sub_extent < 1 ||
      lane_extent < 1 ||
      static_cast<long long>(sub_extent) * lane_extent > (1LL << 30)) {
    return cudaErrorInvalidValue;  // two planes' offsets fit 32 bits
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  RayParams P;
  const float* hp = static_cast<const float*>(params);
  for (int i = 0; i < 18; ++i) P.p[i] = hp[i];
  // tfp is (9, k): knots, then the values of the 4 channels at each
  // knot, then the slopes to the next knot (raymarch_kernel.py::
  // tf_segments).
  const float* ht = static_cast<const float*>(tfp);
  for (int i = 0; i < kKnotSlots; ++i) P.knots[i] = i < k ? ht[i] : INFINITY;
  for (int i = 0; i < kMaxKnots; ++i) {
    for (int c = 0; c < 8; ++c) P.seg[i][c] = i < k ? ht[(1 + c) * k + i] : 0.f;
  }
  P.k = k;
  P.q = q;
  P.nan_mode = nan_mode;
  P.restriction = restriction;
  P.planes = planes;
  P.sub = sub_extent;
  P.lane = lane_extent;
  P.width = width;
  P.height = height;
  const dim3 grid((width + 31) / 32, (height + 7) / 8);
  const auto launch = [&](auto kernel) {
    kernel<<<grid, kBlockThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vol), static_cast<const float*>(fields), P,
        static_cast<float*>(rgb), static_cast<float*>(alpha),
        static_cast<unsigned long long*>(samples));
    return cudaGetLastError();
  };
  if (k <= 2) return launch(raymarch_dvr_kernel<TW, PROBE, 1>);
  if (k <= 4) return launch(raymarch_dvr_kernel<TW, PROBE, 2>);
  if constexpr (PROBE == kShipped && TW == kDvrTileWidth) {
    if (k <= 8) return launch(raymarch_dvr_kernel<TW, PROBE, 3>);
    if (k <= 16) return launch(raymarch_dvr_kernel<TW, PROBE, 4>);
    return launch(raymarch_dvr_kernel<TW, PROBE, 5>);
  }
  return cudaErrorInvalidValue;  // the variants take up to 4 knots
}

}  // namespace

extern "C" int correrender_raymarch_dvr(
    const void* vol, int planes, int sub_extent, int lane_extent,
    const void* fields, int width, int height, const void* params,
    const void* tfp, int k, int q, int nan_mode, int restriction,
    void* rgb, void* alpha, int device, void* stream) {
  return launch_dvr<kDvrTileWidth, kShipped>(
      vol, planes, sub_extent, lane_extent, fields, width, height, params,
      tfp, k, q, nan_mode, restriction, rgb, alpha, nullptr, device, stream);
}

// Variants of B5 for ops/cuda/ablate_raymarch.py, not on any entry
// point's path: the warp tile `tile_width` (8: 8 × 4 pixels, 32: 32 × 1)
// with `probe` 0 (the shipped march); at the shipped tile, probes 1 (no
// TF search: the segment of u on evenly spaced knots, right for config
// 1's knots 0, 0.5 and 1), 2 (one tap instead of the eight-tap
// trilinear sample) and 3 (no expf: alpha = min(τ, 1)); the
// variants take transfer functions of up to 4 knots (config 1's has 3).
// The samples taken are added to *samples when it is not null.
extern "C" int correrender_raymarch_dvr_probe(
    const void* vol, int planes, int sub_extent, int lane_extent,
    const void* fields, int width, int height, const void* params,
    const void* tfp, int k, int q, int nan_mode, int restriction,
    void* rgb, void* alpha, int tile_width, int probe, void* samples,
    int device, void* stream) {
#define CORRERENDER_DVR_ARGS                                                \
  vol, planes, sub_extent, lane_extent, fields, width, height, params, tfp, \
      k, q, nan_mode, restriction, rgb, alpha, samples, device, stream
  constexpr int kOther = kDvrTileWidth == 8 ? 32 : 8;
  if (probe == kShipped && tile_width == kOther) {
    return launch_dvr<kOther, kShipped>(CORRERENDER_DVR_ARGS);
  }
  if (tile_width != kDvrTileWidth) return cudaErrorInvalidValue;
  switch (probe) {
    case kShipped:
      return launch_dvr<kDvrTileWidth, kShipped>(CORRERENDER_DVR_ARGS);
    case kNoTfSearch:
      return launch_dvr<kDvrTileWidth, kNoTfSearch>(CORRERENDER_DVR_ARGS);
    case kOneTap:
      return launch_dvr<kDvrTileWidth, kOneTap>(CORRERENDER_DVR_ARGS);
    case kNoExp:
      return launch_dvr<kDvrTileWidth, kNoExp>(CORRERENDER_DVR_ARGS);
  }
#undef CORRERENDER_DVR_ARGS
  return cudaErrorInvalidValue;
}

extern "C" int correrender_raymarch_iso(
    const void* vol, int planes, int sub_extent, int lane_extent,
    const void* fields, int width, int height, const void* params, int q,
    int refine_steps, void* out, int device, void* stream) {
  if (q < 1 || refine_steps < 0 || planes < 1 || sub_extent < 1 ||
      lane_extent < 1) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  IsoParams P;
  const float* hp = static_cast<const float*>(params);
  for (int i = 0; i < 11; ++i) P.p[i] = hp[i];
  P.q = q;
  P.refine_steps = refine_steps;
  P.planes = planes;
  P.sub = sub_extent;
  P.lane = lane_extent;
  P.width = width;
  P.height = height;
  const dim3 block(32, 8);
  const dim3 grid((width + 31) / 32, (height + 7) / 8);
  raymarch_iso_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vol), static_cast<const float*>(fields), P,
      static_cast<float*>(out));
  return cudaGetLastError();
}
