// B5: exact plane-order DVR, one thread per pixel ray.
//
// Replaces correrender_tpu/ops/pallas/raymarch_kernel.py::dvr_raymarch
// (kernel body _make_dvr_kernel). Per ray it computes what that kernel
// computes, without the TPU's structure: no bricks, no lane rolls, no
// tent-weight matrix product, no DMA ring. The volume arrives permuted
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
//   sample > 1e20 ⇒ NaN (sentinel) ⇒ nan_mode; hinge transfer function
//   alpha = 1 − exp(−tf_a·dt·atten), dt = dt_unit·|inv_da|; OVER
//
// The ray stops once its alpha reaches 0.999 (the reference shader's
// per-ray rule; the TPU kernel stopped whole 8×128 subtiles).
//
// Precision: plain f32 arithmetic, no tensor cores and no texture
// filtering (its 8-bit fractional weights would miss the bars). The
// positions that decide whether a sample counts (γ, t, raw_u, raw_v and
// the ball distances) use __fadd_rn / __fmul_rn, which the compiler
// never contracts into FMAs, so every such test rounds as in the plain
// PyTorch version: a flipped test at the box entry would change a pixel
// by a whole sample's alpha.
//
// Bound on the H100: the eight trilinear loads per sample, served by L1
// and L2 (a warp is a 32×1 row of pixels whose rays sample neighbouring
// voxels), and the hinge sum (K ≤ 24 knots × 4 channels). The transfer
// function and all scalars travel in the kernel's parameter block
// (constant bank), read uniformly by every thread.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxKnots = 24;
constexpr float kNanThresh = 1e20f;
constexpr float kExitAlpha = 0.999f;

struct RayParams {
  // g0 gk gs u_max v_max u0c v0c atten vmin inv_vspan dt_unit inv_q
  // r_gc r_cs r_cl r_rad vox_s vox_l
  float p[18];
  float knots[kMaxKnots];
  float base[4];
  float slope[4][kMaxKnots];
  int k, q, nan_mode, restriction, planes, sub, lane, width, height;
};

__global__ void __launch_bounds__(256) raymarch_dvr_kernel(
    const float* __restrict__ vol, const float* __restrict__ fields,
    const RayParams P, float* __restrict__ rgb, float* __restrict__ alpha) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
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
  if (t1 >= t0) {  // the ray meets the box in front of its depth limit
    const float da = 1.f / inv_da;
    const float dt = dt_unit * fabsf(inv_da);
    // Slab window: slab k holds γ ∈ [g0 + (k − 1)·gk, g0 + k·gk); the
    // window covers every γ in [t0·da, t1·da] with a slab to spare, so
    // skipping the slabs outside it changes nothing.
    const float planes_f = static_cast<float>(P.planes);
    const float lo_f = fminf(fmaxf(floorf((t0 * da - g0) / gk), -1.f),
                             planes_f + 1.f);
    const float hi_f = fminf(fmaxf(ceilf((t1 * da - g0) / gk) + 1.f, -1.f),
                             planes_f);
    const int klo = max(static_cast<int>(lo_f), 0);
    const int khi = static_cast<int>(hi_f);
    const long long plane = static_cast<long long>(P.sub) * P.lane;
    bool done = false;
    for (int kk = klo; kk <= khi && !done; ++kk) {
      const float* __restrict__ plo = vol + max(kk - 1, 0) * plane;
      const float* __restrict__ phi = vol + min(kk, P.planes - 1) * plane;
      const float gbase = __fadd_rn(g0, __fmul_rn(static_cast<float>(kk - 1), gk));
      for (int s = 0; s < P.q; ++s) {
        const float sf = static_cast<float>(s);
        const float gamma = __fadd_rn(gbase, __fmul_rn(sf, gs));
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
        const float wz = (sf + 0.5f) * inv_q;
        const float uc = fminf(fmaxf(raw_u, 0.f), u_max);
        const float vc = fminf(fmaxf(raw_v, 0.f), v_max);
        const int iu = min(static_cast<int>(uc), P.sub - 1);
        const int iv = min(static_cast<int>(vc), P.lane - 1);
        const float fu = uc - static_cast<float>(iu);
        const float fv = vc - static_cast<float>(iv);
        const long long r0 = static_cast<long long>(iu) * P.lane;
        const long long r1 = static_cast<long long>(min(iu + 1, P.sub - 1)) * P.lane;
        const int iv1 = min(iv + 1, P.lane - 1);
        const float wl = 1.f - wz;
        const float b00 = wl * __ldg(plo + r0 + iv) + wz * __ldg(phi + r0 + iv);
        const float b01 = wl * __ldg(plo + r0 + iv1) + wz * __ldg(phi + r0 + iv1);
        const float b10 = wl * __ldg(plo + r1 + iv) + wz * __ldg(phi + r1 + iv);
        const float b11 = wl * __ldg(plo + r1 + iv1) + wz * __ldg(phi + r1 + iv1);
        const float val = (1.f - fu) * ((1.f - fv) * b00 + fv * b01) +
                          fu * ((1.f - fv) * b10 + fv * b11);

        const float u = fminf(fmaxf((val - vmin) * inv_vspan, 0.f), 1.f);
        float c0 = P.base[0], c1 = P.base[1], c2 = P.base[2], c3 = P.base[3];
        for (int i = 0; i < P.k; ++i) {
          const float h = fmaxf(u - P.knots[i], 0.f);
          c0 += P.slope[0][i] * h;
          c1 += P.slope[1][i] * h;
          c2 += P.slope[2][i] * h;
          c3 += P.slope[3][i] * h;
        }
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
        const float w = (1.f - acc_a) * (1.f - expf(-c3 * dt * atten));
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
}

}  // namespace

extern "C" int correrender_raymarch_dvr(
    const void* vol, int planes, int sub_extent, int lane_extent,
    const void* fields, int width, int height, const void* params,
    const void* tfp, int k, int q, int nan_mode, int restriction,
    void* rgb, void* alpha, int device, void* stream) {
  if (k < 1 || k > kMaxKnots || q < 1 || planes < 1 || sub_extent < 1 ||
      lane_extent < 1) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  RayParams P;
  const float* hp = static_cast<const float*>(params);
  for (int i = 0; i < 18; ++i) P.p[i] = hp[i];
  // tfp is (5, 1 + k): row 0 = [pad, knots...], rows 1-4 = [base, slopes...]
  const float* ht = static_cast<const float*>(tfp);
  for (int i = 0; i < k; ++i) P.knots[i] = ht[1 + i];
  for (int ch = 0; ch < 4; ++ch) {
    P.base[ch] = ht[(1 + ch) * (1 + k)];
    for (int i = 0; i < k; ++i) P.slope[ch][i] = ht[(1 + ch) * (1 + k) + 1 + i];
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
  const dim3 block(32, 8);
  const dim3 grid((width + 31) / 32, (height + 7) / 8);
  raymarch_dvr_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vol), static_cast<const float*>(fields), P,
      static_cast<float*>(rgb), static_cast<float*>(alpha));
  return cudaGetLastError();
}
