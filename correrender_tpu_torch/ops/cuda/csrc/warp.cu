// The shear-warp's homography warp: the composited intermediate image
// resampled onto the screen in one pass over the screen's pixels.
//
// Replaces no TPU kernel: the JAX package leaves the warp to XLA
// (correrender_tpu/render/dvr_fast.py::_warp_matmul, dense tent-weight
// einsums). Its plain version is ops/cuda/warp_kernel.py::
// warp_two_pass_plain, the same two passes as dense weights and bmm.
//
// The map from screen pixel (px, py) to the intermediate image is
// projective, and factors into two passes of per-line tent resampling
// (Catmull–Smith): pass A, T(r, px) = I(r, u(px, r)) along row r of
// the intermediate; pass B, S(px, py) = T(sv(px, py), px) down column
// px of T. A tent filter has at most two nonzero taps, so one thread
// per screen pixel computes its pass-B coordinate sv, the pass-A values
// of its two rows (each from two taps), and their two-tap sum, then
// masks and blends the pixel. Nothing is written but the frame.
//
// Rounding follows the plain version op for op. Tent weights and image
// values are rounded to bf16, so every product is exact in f32 and the
// plain's dense sums (zeros besides two products) equal these two-tap
// sums to the bit; T is rounded to bf16 between the passes. Every other
// step is written with the _rn intrinsics, so that nvcc contracts
// nothing the plain rounds twice into an FMA. Taps are found as the
// benchmark's reference finds them: the floor of the coordinate, NaN
// taken as −2, clamped to [−2, taps] before the integer cast, so a huge
// or non-finite coordinate gives no tap (the plain's NaN weights, which
// poison whole columns of its products, have no counterpart here).
//
// The pass order (t_int: the intermediate's axes swapped; t_out: the
// screen's) is an argument: the intermediate is read through its
// strides, and a thread maps its screen pixel to (px, py), so the
// threads of a warp always walk the screen's x and store 16-byte float4
// pixels into the contiguous (height, width, 4) frame.
//
// Bound on the H100: bytes. The f32 intermediate read once (16 bytes a
// pixel) and the f32 RGBA frame written once: 66 MB at 1080p, 0.020 ms
// at 3.35 TB/s; about 60 flops a pixel. Neighbouring pixels read
// neighbouring taps, which L1 and L2 serve.

#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // pixels of one screen row per block

struct Params {
  float a0, a1, a2, b0, b1, b2, c0, c1, c2;  // the variant's coefficients
  float sign_ok;                             // required sign of den_full
  float bg[4];                               // straight-alpha background
};
static_assert(sizeof(Params) == 14 * sizeof(float), "params are 14 floats");

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// dvr_fast.py::_safe: a denominator kept off zero.
__device__ __forceinline__ float safe(float den) {
  return fabsf(den) < 1e-12f ? 1e-12f : den;
}

// bf16(max(1 − |coord − tap|, 0)), as the plain's _tent.
__device__ __forceinline__ float tent(float coord, int tap) {
  const float w = __fsub_rn(1.0f, fabsf(__fsub_rn(coord, float(tap))));
  return round_bf16(w < 0.0f ? 0.0f : w);
}

// The first of a coordinate's two taps: floor, NaN as −2, in [−2, taps].
__device__ __forceinline__ int first_tap(float coord, int taps) {
  const float t = floorf(isnan(coord) ? -2.0f : coord);
  return int(fminf(fmaxf(t, -2.0f), float(taps)));
}

__global__ void __launch_bounds__(kThreads) homography_warp_kernel(
    const float* __restrict__ rgb, const float* __restrict__ alpha,
    int rgb_row, int rgb_col, int rgb_ch, int alpha_row, int alpha_col,
    int hi, int wi, int t_out, Params p, float4* __restrict__ out,
    int width) {
  const int sx = blockIdx.x * kThreads + threadIdx.x;
  const int sy = blockIdx.y;
  if (sx >= width) return;
  const float px = float(t_out ? sy : sx);
  const float py = float(t_out ? sx : sy);

  // Pass B's coordinate: ((c0 + c1·px) + c2·py), ((b0 + b1·px) + b2·py).
  const float cpa = __fadd_rn(p.c0, __fmul_rn(p.c1, px));
  const float bpa = __fadd_rn(p.b0, __fmul_rn(p.b1, px));
  const float apa = __fadd_rn(p.a0, __fmul_rn(p.a1, px));
  const float den_full = __fadd_rn(cpa, __fmul_rn(p.c2, py));
  const float sv = __fdiv_rn(__fadd_rn(bpa, __fmul_rn(p.b2, py)),
                             safe(den_full));

  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int r0 = first_tap(sv, hi);
#pragma unroll
  for (int dr = 0; dr < 2; ++dr) {
    const int r = r0 + dr;
    if (r < 0 || r > hi - 1) continue;
    // Pass A at (r, px): py* solves sv(px, py*) = r, then u(px, py*).
    const float y = float(r);
    const float num = __fsub_rn(__fmul_rn(y, cpa), bpa);
    const float den = __fsub_rn(p.b2, __fmul_rn(y, p.c2));
    const float py_star = __fdiv_rn(num, safe(den));
    const float u_den = __fadd_rn(cpa, __fmul_rn(p.c2, py_star));
    const float u = __fdiv_rn(__fadd_rn(apa, __fmul_rn(p.a2, py_star)),
                              safe(u_den));
    float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const int j0 = first_tap(u, wi);
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
      const int j = j0 + dj;
      if (j < 0 || j > wi - 1) continue;
      const float w = tent(u, j);
      const float* c = rgb + r * rgb_row + j * rgb_col;
      t[0] = __fadd_rn(t[0], __fmul_rn(w, round_bf16(__ldg(c))));
      t[1] = __fadd_rn(t[1], __fmul_rn(w, round_bf16(__ldg(c + rgb_ch))));
      t[2] = __fadd_rn(t[2], __fmul_rn(w, round_bf16(__ldg(c + 2 * rgb_ch))));
      t[3] = __fadd_rn(t[3], __fmul_rn(w, round_bf16(__ldg(
                                              alpha + r * alpha_row +
                                              j * alpha_col))));
    }
    const float wb = tent(sv, r);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      s[k] = __fadd_rn(s[k], __fmul_rn(wb, round_bf16(t[k])));
  }

  // The finish (dvr_fast.py::_warp_finish): forward rays only, alpha
  // clamped to [0, 1] (NaN kept, as torch.clamp keeps it); then
  // render/dvr.py::blend_background: OVER the background, un-premultiply.
  const float valid = __fmul_rn(den_full, p.sign_ok) > 0.0f ? 1.0f : 0.0f;
  float a = __fmul_rn(s[3], valid);
  a = a < 0.0f ? 0.0f : (a > 1.0f ? 1.0f : a);
  const float rest = __fsub_rn(1.0f, a);
  const float behind = __fmul_rn(rest, p.bg[3]);
  const float a_out = __fadd_rn(a, behind);
  const float keep = a_out < 1e-6f ? 1e-6f : a_out;
  float4 o;
  o.x = __fdiv_rn(__fadd_rn(__fmul_rn(s[0], valid), __fmul_rn(behind, p.bg[0])),
                  keep);
  o.y = __fdiv_rn(__fadd_rn(__fmul_rn(s[1], valid), __fmul_rn(behind, p.bg[1])),
                  keep);
  o.z = __fdiv_rn(__fadd_rn(__fmul_rn(s[2], valid), __fmul_rn(behind, p.bg[2])),
                  keep);
  o.w = a_out;
  out[sy * width + sx] = o;
}

}  // namespace

// rgb (hi, wi, 3) and alpha (hi, wi) f32 through their element strides;
// t_int swaps the intermediate's axes, t_out the screen's; params (host):
// a0 a1 a2 b0 b1 b2 c0 c1 c2 of the variant, sign_ok, the background's
// r g b a; out: the (height, width, 4) f32 frame.
extern "C" int correrender_warp(const void* rgb, int rgb_s0, int rgb_s1,
                                int rgb_s2, const void* alpha, int alpha_s0,
                                int alpha_s1, int hi, int wi, int t_int,
                                int t_out, const float* params, void* out,
                                int width, int height, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Params p;
  std::memcpy(&p, params, sizeof(Params));
  int rgb_row = rgb_s0, rgb_col = rgb_s1, alpha_row = alpha_s0,
      alpha_col = alpha_s1;
  if (t_int) {
    const int swap = hi;
    hi = wi;
    wi = swap;
    rgb_row = rgb_s1;
    rgb_col = rgb_s0;
    alpha_row = alpha_s1;
    alpha_col = alpha_s0;
  }
  const dim3 grid((width + kThreads - 1) / kThreads, height);
  homography_warp_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rgb), static_cast<const float*>(alpha),
      rgb_row, rgb_col, rgb_s2, alpha_row, alpha_col, hi, wi, t_out, p,
      static_cast<float4*>(out), width);
  return cudaGetLastError();
}
