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
// f_hi, 0) for the torch solvers. B6 sets up its own rays: each thread
// computes its pixel's su, sv, inv_da, t0, t1 from the inverse
// projection and view, the model inverse and the box (iso_ray_setup, in
// the order of single f32 operations of the plain version's
// raymarch_kernel.py::iso_ray_fields), and writes the unit model-space
// direction that the shading reads, so no torch launch precedes it.
//
// Precision: plain f32 arithmetic, no tensor cores and no texture
// filtering (its 8-bit fractional weights would miss the bars). The
// positions that decide whether a sample counts (γ, t, raw_u, raw_v and
// the ball distances) use __fadd_rn / __fmul_rn, which the compiler
// never contracts into FMAs, so every such test rounds as in the plain
// PyTorch version: a flipped test at the box entry would change a DVR
// pixel by a whole sample's alpha. B6 also rounds its ray setup and the
// sample value itself op by op (IsoTaps::sample, the plain version's
// _sample_slab: which side of the iso value a sample lies on moves a hit
// by a whole sub-step), so it equals its plain version bit for bit. B5
// does not: its sample value (CellTaps::sample) contracts into FMAs,
// about 1e-7 from the plain version's value. Both index a plane with
// 32-bit offsets from one 64-bit plane pointer. B5 keeps a ray's eight
// taps while its samples stay in one cell of the slab; B6's march loads
// them at every sample (a cache read slower there: the lanes of a warp
// leave their cells at different sub-steps, so it saves no load
// instruction), and its bisection keeps them.
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
// Bound on the H100: the instructions issued per sample (for B6: the
// eight loads and their addresses, the 26 operations of the op-by-op
// value, the position with its clamps and floors, the tests), and the loads of each cell a ray enters, served by L1 and
// L2. Both kernels' warps cover 8 × 4 pixel tiles (kRayTileWidth; 32 × 1
// rows, the first design's shape, are the other variant), whose rays
// sample a compact patch of voxels and end at similar depths. The
// scalars travel in the parameter block (constant bank), read uniformly
// by every thread.
//
// correrender_raymarch_dvr_probe launches variants of B5 for
// ops/cuda/ablate_raymarch.py only: the other tile, and probes that
// change the answer on purpose (no TF search, one tap, no expf), with
// the samples each variant took counted. correrender_raymarch_iso_probe
// launches variants of B6 for ops/cuda/ablate_iso.py only (the other
// tile, the tap cache in the march, the other refinement, the ray fields
// read from memory, a launch bound), each with B6's answer, and a probe
// that reads one tap of each plane.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxKnots = 24;
constexpr int kKnotSlots = 32;  // the search's table: knots, then +inf
constexpr float kNanThresh = 1e20f;
constexpr float kExitAlpha = 0.999f;
constexpr int kRayTileWidth = 8;  // B5's and B6's warp tile: 8 × 4
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

// B6's parameter block. r holds the ray setup's constants, float32 from
// the host (raymarch_kernel.py::_iso_ray_constants): the inverse
// projection's first three rows (12), the inverse view's rotation (9),
// the model inverse's rotation with its rows in (principal, sub, lane)
// order (9), box_min − o and box_max − o in that order (3 + 3; o is the
// eye in model space), the sign of the slice order and the sub and lane
// voxel extents.
constexpr int kIsoScalars = 11, kIsoSetup = 39;

struct IsoParams {
  // g0 gk gs u_max v_max u0c v0c iso g0p inv_ga inv_q
  float p[kIsoScalars];
  float r[kIsoSetup];
  int dir_ch[3];  // the model-space channel of the principal, sub, lane axes
  int q, refine_steps, planes, sub, lane, width, height;
};

// torch.minimum and torch.maximum: NaN where either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) || isnan(b) ? a + b : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) || isnan(b) ? a + b : fmaxf(a, b);
}

// (m[0]·v[0] + m[1]·v[1]) + m[2]·v[2], each operation rounded alone.
__device__ __forceinline__ float dot3_rn(const float* m, const float* v) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m[0], v[0]), __fmul_rn(m[1], v[1])),
                   __fmul_rn(m[2], v[2]));
}

struct IsoRay {
  float su, sv, inv_da, t0, t1;
  float d[3];  // unit direction in model space: principal, sub, lane
};

// The ray fields of pixel (x, y) in the plain version's order of single
// f32 operations (raymarch_kernel.py::iso_ray_fields): the NDC pixel
// centre through the inverse projection (NDC z = 1), normalised, through
// the inverse view's rotation and the model inverse's; the slab test
// against the box (NaN-propagating minima and maxima, as torch's);
// t0 = max(t_near, 0), t1 = t_far where the ray meets the box in front of
// the eye, else t0 − 1; inv_da = 1/(sgn·d_a), su = d_s·inv_da/voxel_s,
// sv = d_l·inv_da/voxel_l.
__device__ __forceinline__ IsoRay iso_ray_setup(const IsoParams& P, int x,
                                                int y) {
  const float* r = P.r;
  const float px = __fdiv_rn(__fadd_rn(static_cast<float>(x), 0.5f),
                             static_cast<float>(P.width));
  const float py = __fdiv_rn(__fadd_rn(static_cast<float>(y), 0.5f),
                             static_cast<float>(P.height));
  const float gx = __fadd_rn(__fmul_rn(2.f, px), -1.f);
  const float gy = __fadd_rn(1.f, -__fmul_rn(2.f, py));
  float vt[3], vd[3], wd[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    vt[i] = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(r[4 * i], gx), __fmul_rn(r[4 * i + 1], gy)),
                  r[4 * i + 2]),
        r[4 * i + 3]);
  }
  const float nrm = __fsqrt_rn(dot3_rn(vt, vt));
#pragma unroll
  for (int i = 0; i < 3; ++i) vd[i] = __fdiv_rn(vt[i], nrm);
#pragma unroll
  for (int i = 0; i < 3; ++i) wd[i] = dot3_rn(r + 12 + 3 * i, vd);
  IsoRay ray;
  float t_near = 0.f, t_far = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    ray.d[i] = dot3_rn(r + 21 + 3 * i, wd);
    const float inv = __fdiv_rn(1.f, ray.d[i]);
    const float ta = __fmul_rn(r[30 + i], inv), tb = __fmul_rn(r[33 + i], inv);
    const float lo = nan_min(ta, tb), hi = nan_max(ta, tb);
    t_near = i == 0 ? lo : nan_max(t_near, lo);
    t_far = i == 0 ? hi : nan_min(t_far, hi);
  }
  const bool hit = t_near <= t_far && t_far >= 0.f;
  ray.t0 = nan_max(t_near, 0.f);
  ray.t1 = hit ? t_far : __fadd_rn(ray.t0, -1.f);
  ray.inv_da = __fdiv_rn(1.f, __fmul_rn(r[36], ray.d[0]));
  ray.su = __fdiv_rn(__fmul_rn(ray.d[1], ray.inv_da), r[37]);
  ray.sv = __fdiv_rn(__fmul_rn(ray.d[2], ray.inv_da), r[38]);
  return ray;
}

// floor(x) for 0 ≤ x < 2²³, as an int (the return value) and as a float
// (*xf), from one add in round-down mode: 2²³ + x rounds down to 2²³ +
// floor(x), whose low mantissa bits hold floor(x). A conversion between
// float and int issues at an eighth of an add's rate on the H100.
__device__ __forceinline__ int floor_index(float x, float* xf) {
  const float shifted = __fadd_rd(x, 8388608.f);
  *xf = __fsub_rn(shifted, 8388608.f);
  return __float_as_int(shifted) - 0x4B000000;
}

// p itself, opaque to the compiler: a plane pointer set once a slab stays
// one register pair, where the compiler would otherwise fold its 64-bit
// product back into every tap's address (and the int overload keeps a
// slab's plane offset from being recomputed at every sample).
__device__ __forceinline__ const float* pinned(const float* p) {
  asm("mov.b64 %0, %0;" : "+l"(p));
  return p;
}

__device__ __forceinline__ int pinned(int v) {
  asm("mov.b32 %0, %0;" : "+r"(v));
  return v;
}

// B6's sample: the z-lerp by wz between the planes at plo and plo + dz
// of the bilinear sample at (clamp(raw_u), clamp(raw_v)), every product
// and sum rounded on its own in the plain version's order
// (_sample_slab), with its corner rule: the cell (iu, iv) may sit on the
// far edge, whose clamped neighbour is the edge voxel itself (du = 0 or
// dv = 0 there). The eight taps sit at 32-bit offsets from the plane's
// 64-bit pointer, which the march sets once a slab. With KEEP a ray
// keeps the taps of its last (plane pair, cell) and loads only where it
// enters another; the value is the same either way.
struct IsoTaps {
  const float* plane = nullptr;  // what lo and hi hold: plane, dz, cell
  int dz = -1, cell = -1;
  float lo[4], hi[4];

  template <bool KEEP, bool ONE_TAP = false>
  __device__ __forceinline__ float sample(const float* __restrict__ plo,
                                          int dzo, float wz, float raw_u,
                                          float raw_v, float u_max,
                                          float v_max, int sub, int lane) {
    // uc ≤ u_max = sub − 1 and vc ≤ lane − 1, so their floors are the
    // plain version's min(int(uc), sub − 1) and min(int(vc), lane − 1).
    const float uc = fminf(fmaxf(raw_u, 0.f), u_max);
    const float vc = fminf(fmaxf(raw_v, 0.f), v_max);
    float iuf, ivf;
    const int iu = floor_index(uc, &iuf), iv = floor_index(vc, &ivf);
    const float fu = uc - iuf, fv = vc - ivf;
    const int off = iu * lane + iv;
    if (!KEEP || off != cell || plo != plane || dzo != dz) {
      cell = off;
      plane = plo;
      dz = dzo;
      const int du = iu < sub - 1 ? lane : 0, dv = iv < lane - 1 ? 1 : 0;
      const int at[4] = {off, off + dv, off + du, off + du + dv};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        lo[t] = ONE_TAP && t > 0 ? lo[0] : __ldg(plo + at[t]);
        hi[t] = ONE_TAP && t > 0 ? hi[0] : __ldg(plo + (dzo + at[t]));
      }
    }
    const float wl = 1.f - wz;
    float tap[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      tap[t] = __fadd_rn(__fmul_rn(wl, lo[t]), __fmul_rn(wz, hi[t]));
    }
    const float gu = 1.f - fu, gv = 1.f - fv;
    const float a = __fadd_rn(__fmul_rn(gv, tap[0]), __fmul_rn(fv, tap[1]));
    const float b = __fadd_rn(__fmul_rn(gv, tap[2]), __fmul_rn(fv, tap[3]));
    return __fadd_rn(__fmul_rn(gu, a), __fmul_rn(fu, b));
  }
};

// Trilinear sample at a ray's γ plus voxel offsets (dz along the
// principal axis, du, dv in the plane), clamped to the volume's centres:
// the plain version's sample_ray.
template <bool KEEP>
__device__ __forceinline__ float iso_sample_at(
    IsoTaps& taps, const float* __restrict__ vol, const IsoParams& P,
    float gamma, float su, float sv, float du, float dv, float dz) {
  const float zc = fminf(
      fmaxf(__fadd_rn(__fmul_rn(__fadd_rn(gamma, -P.p[8]), P.p[9]), dz), 0.f),
      static_cast<float>(P.planes - 1));
  float izf;
  const int iz = floor_index(zc, &izf);  // zc ≤ planes − 1
  const float raw_u = __fadd_rn(__fadd_rn(P.p[5], __fmul_rn(gamma, su)), du);
  const float raw_v = __fadd_rn(__fadd_rn(P.p[6], __fmul_rn(gamma, sv)), dv);
  const int plane = P.sub * P.lane;
  return taps.sample<KEEP>(pinned(vol + static_cast<long long>(iz) * plane),
                           (min(iz + 1, P.planes - 1) - iz) * plane,
                           zc - izf, raw_u, raw_v, P.p[3], P.p[4], P.sub,
                           P.lane);
}

// The refinement of a found ray: bisection in γ over [γ_hit − gs, γ_hit]
// (γ_hit = t_hit·da, as the TPU kernel recovers it), then ±1-voxel
// central differences at the midpoint. o = (t_surf, gA, gS, gL). The
// bisection's samples lie within one sub-step of the ray, mostly in one
// cell, so they keep their taps; the gradients read other cells.
__device__ __forceinline__ void iso_refine(const float* __restrict__ vol,
                                           const IsoParams& P, float t_hit,
                                           float f_lo, float su, float sv,
                                           float inv_da, float o[4]) {
  const float iso = P.p[7];
  IsoTaps taps;
  float ghi = __fmul_rn(t_hit, __fdiv_rn(1.f, inv_da));
  float glo = __fadd_rn(ghi, -P.p[2]);
  float fl = f_lo;
  for (int r = 0; r < P.refine_steps; ++r) {
    const float gm = __fmul_rn(0.5f, __fadd_rn(glo, ghi));
    const float fm = __fadd_rn(
        iso_sample_at<true>(taps, vol, P, gm, su, sv, 0.f, 0.f, 0.f), -iso);
    if ((fm >= 0.f) == (fl >= 0.f)) {
      glo = gm;
      fl = fm;
    } else {
      ghi = gm;
    }
  }
  const float g = __fmul_rn(0.5f, __fadd_rn(glo, ghi));
  o[0] = __fmul_rn(g, inv_da);
  // One axis a step, not unrolled: unrolled, the compiler hoists the six
  // samples' 48 loads together and the kernel's registers double.
#pragma unroll 1
  for (int axis = 0; axis < 3; ++axis) {
    const float du = axis == 1 ? 1.f : 0.f, dv = axis == 2 ? 1.f : 0.f;
    const float dz = axis == 0 ? 1.f : 0.f;
    // The plain version's offsets: ±1 along the axis, +0 elsewhere.
    const float d = __fadd_rn(
        iso_sample_at<false>(taps, vol, P, g, su, sv, du, dv, dz),
        -iso_sample_at<false>(taps, vol, P, g, su, sv, du > 0.f ? -1.f : 0.f,
                              dv > 0.f ? -1.f : 0.f, dz > 0.f ? -1.f : 0.f));
    o[1] = axis == 0 ? d : o[1];
    o[2] = axis == 1 ? d : o[2];
    o[3] = axis == 2 ? d : o[3];
  }
}

// Probes of B6 (ablate_iso.py): the value from one tap of each plane
// (the answer changes), and a launch bound of six blocks an SM.
constexpr int kIsoShipped = 0, kIsoOneTap = 1, kIsoSixBlocks = 2;

// B6. TW: the warp tile (tile_pixel); CACHE: the march keeps a ray's
// cell taps (IsoTaps; the bisection always keeps them); COMPACT: the
// march queues its found rays in shared memory and the block's threads
// then refine them in turn, so full warps refine (else each found ray
// refines at once, its warp's other lanes idle); SETUP: set up the rays
// here (else read the five fields from `fields`, (5, H, W)). `dirs`
// (nullable) receives the (H, W, 3) unit model-space directions when
// SETUP, `samples` (nullable) three counts (below).
template <int TW, bool CACHE, bool COMPACT, bool SETUP, int PROBE>
__global__ void __launch_bounds__(kBlockThreads,
                                  PROBE == kIsoSixBlocks ? 6 : 1)
    raymarch_iso_kernel(
    const float* __restrict__ vol, const float* __restrict__ fields,
    const __grid_constant__ IsoParams P, float* __restrict__ out,
    float* __restrict__ dirs, unsigned long long* __restrict__ samples) {
  int x, y;
  tile_pixel<TW>(&x, &y);
  const bool live = x < P.width && y < P.height;
  const unsigned members = __ballot_sync(0xffffffffu, live);
  if (!COMPACT && !live) return;  // COMPACT: every thread meets the barriers
  const float g0 = P.p[0], gk = P.p[1], gs = P.p[2];
  const float u_max = P.p[3], v_max = P.p[4], u0c = P.p[5], v0c = P.p[6];
  const float iso = P.p[7], inv_q = P.p[10];
  const int n = P.width * P.height;  // 5·n < 2³¹ (checked at launch)
  const int p = y * P.width + x;
  float su = 0.f, sv = 0.f, inv_da = 1.f, t0 = 0.f, t1 = -1.f;
  if (live) {
    if (SETUP) {
      const IsoRay ray = iso_ray_setup(P, x, y);
      su = ray.su;
      sv = ray.sv;
      inv_da = ray.inv_da;
      t0 = ray.t0;
      t1 = ray.t1;
      if (dirs != nullptr) {
#pragma unroll
        for (int i = 0; i < 3; ++i) dirs[3 * p + P.dir_ch[i]] = ray.d[i];
      }
    } else {
      su = fields[p];
      sv = fields[n + p];
      inv_da = fields[2 * n + p];
      t0 = fields[3 * n + p];
      t1 = fields[4 * n + p];
    }
  }

  const int plane = P.sub * P.lane;  // ≤ 2³⁰ (checked at launch)
  IsoTaps taps;
  bool found = false;
  float t_hit = 0.f, f_lo = 0.f, f_hi = 0.f;
  unsigned taken = 0, iters = 0;  // samples taken, sub-steps visited
  if (t1 >= t0) {  // the ray meets the box in front of the eye
    int klo, khi;
    slab_window(t0, t1, inv_da, g0, gk, P.planes, &klo, &khi);
    // The previous active sample's f; NaN before the first, where both
    // sign tests below fail.
    float prev = __int_as_float(0x7fffffff);
    // kf = kk − 1 and sf = s as floats, counted (no conversions).
    float kf = static_cast<float>(klo - 1);
    for (int kk = klo; kk <= khi; ++kk, kf += 1.f) {
      const int zlo = max(kk - 1, 0), zhi = min(kk, P.planes - 1);
      const float* __restrict__ plo =
          pinned(vol + static_cast<long long>(zlo) * plane);
      const int dz = pinned((zhi - zlo) * plane);
      const float gbase = __fadd_rn(g0, __fmul_rn(kf, gk));
      float sf = 0.f;
      for (int s = 0; s < P.q; ++s, sf += 1.f) {
        ++iters;
        const float gamma = __fadd_rn(gbase, __fmul_rn(sf, gs));
        const float t = __fmul_rn(gamma, inv_da);
        if (!(t >= t0 && t <= t1)) continue;
        ++taken;
        const float wz = __fmul_rn(__fadd_rn(sf, 0.5f), inv_q);
        const float val = taps.sample<CACHE, PROBE == kIsoOneTap>(
            plo, dz, wz, __fadd_rn(u0c, __fmul_rn(gamma, su)),
            __fadd_rn(v0c, __fmul_rn(gamma, sv)), u_max, v_max, P.sub,
            P.lane);
        if (!(val < kNanThresh)) continue;  // touches a NaN voxel: inactive
        const float f = __fadd_rn(val, -iso);
        if (f >= 0.f ? prev < 0.f : prev >= 0.f) {  // a sign change
          found = true;
          t_hit = t;
          f_lo = prev;
          f_hi = f;
          goto marched;
        }
        prev = f;
      }
    }
  }
marched:
  const bool refine = found && P.refine_steps > 0;
  if (refine) taken += P.refine_steps + 6;
  if (samples != nullptr) {  // the probe's counts (ablate_iso.py)
    // samples[0]: samples taken; [1]: the march's sub-steps visited by
    // the rays; [2]: the lane slots their warps spent on them (32 × the
    // warp's most), whose ratio to [1] is the march's SIMT efficiency.
    const unsigned group = COMPACT ? 0xffffffffu : members;
    const unsigned most = __reduce_max_sync(group, iters);
    atomicAdd(samples, static_cast<unsigned long long>(taken));
    atomicAdd(samples + 1, static_cast<unsigned long long>(iters));
    if ((threadIdx.x & 31) == __ffs(group) - 1) {
      atomicAdd(samples + 2, 32ull * most);
    }
  }
  float o[4] = {t_hit, f_lo, f_hi, 0.f};  // the bracket, or zeros
  if constexpr (COMPACT) {
    __shared__ int s_count;
    __shared__ int s_pixel[kBlockThreads];
    __shared__ float s_ray[5][kBlockThreads];
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();
    const unsigned queued = __ballot_sync(0xffffffffu, refine);
    if (refine) {  // one shared atomic a warp
      const int lane_id = threadIdx.x & 31, leader = __ffs(queued) - 1;
      int base = 0;
      if (lane_id == leader) base = atomicAdd(&s_count, __popc(queued));
      base = __shfl_sync(queued, base, leader);
      const int slot = base + __popc(queued & ((1u << lane_id) - 1u));
      s_pixel[slot] = p;
      s_ray[0][slot] = t_hit;
      s_ray[1][slot] = f_lo;
      s_ray[2][slot] = su;
      s_ray[3][slot] = sv;
      s_ray[4][slot] = inv_da;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < s_count; i += kBlockThreads) {
      float r[4];
      iso_refine(vol, P, s_ray[0][i], s_ray[1][i], s_ray[2][i], s_ray[3][i],
                 s_ray[4][i], r);
      const int q = s_pixel[i];
      out[q] = 1.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) out[(c + 1) * n + q] = r[c];
    }
    if (!live || refine) return;
  } else if (refine) {
    iso_refine(vol, P, t_hit, f_lo, su, sv, inv_da, o);
  }
  out[p] = found ? 1.f : 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) out[(c + 1) * n + p] = o[c];
}

// B6's launch; fields is read only by the SETUP = false variant.
template <int TW, bool CACHE, bool COMPACT, bool SETUP,
          int PROBE = kIsoShipped>
int launch_iso(const void* vol, int planes, int sub_extent, int lane_extent,
               const void* fields, int width, int height, const void* params,
               int axis_world, int sub_axis, int lane_axis, int q,
               int refine_steps, void* out, void* dirs, void* samples,
               int device, void* stream) {
  const int axes[3] = {axis_world, sub_axis, lane_axis};
  if (q < 1 || refine_steps < 0 || planes < 1 || sub_extent < 1 ||
      lane_extent < 1 || width < 1 || height < 1 ||
      planes >= (1 << 23) || sub_extent >= (1 << 23) ||
      lane_extent >= (1 << 23) ||  // floor_index's range
      static_cast<long long>(sub_extent) * lane_extent > (1LL << 30) ||
      5LL * width * height > 2147483647LL ||
      axis_world == sub_axis || axis_world == lane_axis ||
      sub_axis == lane_axis) {
    return cudaErrorInvalidValue;
  }
  for (int i = 0; i < 3; ++i) {
    if (axes[i] < 0 || axes[i] > 2) return cudaErrorInvalidValue;
  }
  if (!SETUP && fields == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  IsoParams P;
  const float* hp = static_cast<const float*>(params);
  for (int i = 0; i < kIsoScalars; ++i) P.p[i] = hp[i];
  for (int i = 0; i < kIsoSetup; ++i) P.r[i] = hp[kIsoScalars + i];
  for (int i = 0; i < 3; ++i) P.dir_ch[i] = axes[i];
  P.q = q;
  P.refine_steps = refine_steps;
  P.planes = planes;
  P.sub = sub_extent;
  P.lane = lane_extent;
  P.width = width;
  P.height = height;
  const dim3 grid((width + 31) / 32, (height + 7) / 8);
  raymarch_iso_kernel<TW, CACHE, COMPACT, SETUP, PROBE>
      <<<grid, kBlockThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(vol), static_cast<const float*>(fields),
          P, static_cast<float*>(out), static_cast<float*>(dirs),
          static_cast<unsigned long long*>(samples));
  return cudaGetLastError();
}

// The shipped B6 (the fastest at the headline iso frame, ablate_iso.py):
// 8 × 4 tiles, the march loading its eight taps at every sample (its
// warps' lanes leave their cells at different sub-steps, so a cache saves
// no load instruction and costs its test), refinement inline, rays set
// up in the kernel.
constexpr bool kIsoMarchCache = false, kIsoCompact = false;

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
  if constexpr (PROBE == kShipped && TW == kRayTileWidth) {
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
  return launch_dvr<kRayTileWidth, kShipped>(
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
  constexpr int kOther = kRayTileWidth == 8 ? 32 : 8;
  if (probe == kShipped && tile_width == kOther) {
    return launch_dvr<kOther, kShipped>(CORRERENDER_DVR_ARGS);
  }
  if (tile_width != kRayTileWidth) return cudaErrorInvalidValue;
  switch (probe) {
    case kShipped:
      return launch_dvr<kRayTileWidth, kShipped>(CORRERENDER_DVR_ARGS);
    case kNoTfSearch:
      return launch_dvr<kRayTileWidth, kNoTfSearch>(CORRERENDER_DVR_ARGS);
    case kOneTap:
      return launch_dvr<kRayTileWidth, kOneTap>(CORRERENDER_DVR_ARGS);
    case kNoExp:
      return launch_dvr<kRayTileWidth, kNoExp>(CORRERENDER_DVR_ARGS);
  }
#undef CORRERENDER_DVR_ARGS
  return cudaErrorInvalidValue;
}

extern "C" int correrender_raymarch_iso(
    const void* vol, int planes, int sub_extent, int lane_extent, int width,
    int height, const void* params, int axis_world, int sub_axis,
    int lane_axis, int q, int refine_steps, void* out, void* dirs,
    int device, void* stream) {
  return launch_iso<kRayTileWidth, kIsoMarchCache, kIsoCompact, true>(
      vol, planes, sub_extent, lane_extent, nullptr, width, height, params,
      axis_world, sub_axis, lane_axis, q, refine_steps, out, dirs, nullptr,
      device, stream);
}

// Variants of B6 for ops/cuda/ablate_iso.py, not on any entry point's
// path, each one switch away from the shipped kernel: the warp tile
// `tile_width` (8: 8 × 4 pixels, 32: 32 × 1), `cache` (1: the march keeps
// its cell taps), `compact` (1: the compacted refinement), `setup` (0:
// read the five ray fields from `fields`, (5, H, W) float32, as the plain
// version's iso_ray_fields computes them), and `probe` 1 (one tap of
// each plane: a wrong answer on purpose) or 2 (a launch bound of six
// blocks an SM). Every variant but probe 1 computes the shipped kernel's
// outputs. `samples` (nullable) receives the kernel's three counts.
extern "C" int correrender_raymarch_iso_probe(
    const void* vol, int planes, int sub_extent, int lane_extent,
    const void* fields, int width, int height, const void* params,
    int axis_world, int sub_axis, int lane_axis, int q, int refine_steps,
    void* out, void* dirs, int tile_width, int cache, int compact,
    int setup, int probe, void* samples, int device, void* stream) {
#define CORRERENDER_ISO_ARGS                                                 \
  vol, planes, sub_extent, lane_extent, fields, width, height, params,      \
      axis_world, sub_axis, lane_axis, q, refine_steps, out, dirs, samples, \
      device, stream
  constexpr int kTile = kRayTileWidth, kOther = kTile == 8 ? 32 : 8;
  constexpr bool kCache = kIsoMarchCache, kCompact = kIsoCompact;
  const int switched = (tile_width != kTile) + ((cache != 0) != kCache) +
                       ((compact != 0) != kCompact) + (setup == 0) +
                       (probe != kIsoShipped);
  int rc = cudaErrorInvalidValue;
  if (switched == 0) {
    rc = launch_iso<kTile, kCache, kCompact, true>(CORRERENDER_ISO_ARGS);
  } else if (switched == 1 && tile_width == kOther) {
    rc = launch_iso<kOther, kCache, kCompact, true>(CORRERENDER_ISO_ARGS);
  } else if (switched == 1 && (cache != 0) != kCache) {
    rc = launch_iso<kTile, !kCache, kCompact, true>(CORRERENDER_ISO_ARGS);
  } else if (switched == 1 && (compact != 0) != kCompact) {
    rc = launch_iso<kTile, kCache, !kCompact, true>(CORRERENDER_ISO_ARGS);
  } else if (switched == 1 && setup == 0) {
    rc = launch_iso<kTile, kCache, kCompact, false>(CORRERENDER_ISO_ARGS);
  } else if (switched == 1 && probe == kIsoOneTap) {
    rc = launch_iso<kTile, kCache, kCompact, true, kIsoOneTap>(
        CORRERENDER_ISO_ARGS);
  } else if (switched == 1 && probe == kIsoSixBlocks) {
    rc = launch_iso<kTile, kCache, kCompact, true, kIsoSixBlocks>(
        CORRERENDER_ISO_ARGS);
  }
#undef CORRERENDER_ISO_ARGS
  return rc;
}
