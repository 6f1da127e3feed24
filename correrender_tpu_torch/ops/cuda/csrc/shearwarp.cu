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
// _composite_scan): the tent weights are rounded to bf16, the resample
// along v is rounded to bf16 before the resample along u, sums are f32.
// So the kernel and its plain version differ only by f32 summation order.
//
// Bound on the H100: L1/L2 load throughput. Each pixel reads 4 taps of
// 8 bytes per slice (S·4 taps per pixel); the classified volume is read
// from device memory about once, since a 250² slice is 0.5 MB in bf16
// RGBA and stays in L2 while every pixel block passes over it.
//
// Design: one thread per intermediate pixel, a loop over the S slices.
// The tent filter has at most 2×2 nonzero taps, so the TPU's two dense
// weight-matrix products per slice become four 8-byte gathers; taps
// outside the slice count as zero, which is the exact box clipping of
// dvr_fast.py:27-28. Pixels whose footprint misses a slice skip its
// loads. Neighbouring threads sample neighbouring points of a slice, so
// their taps share L1 lines. No early ray termination: the reference
// compositor has none.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-6f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Unpacks one 8-byte RGBA tap (four bf16) into f32.
__device__ __forceinline__ float4 unpack(uint2 w) {
  __nv_bfloat162 rg = *reinterpret_cast<__nv_bfloat162*>(&w.x);
  __nv_bfloat162 ba = *reinterpret_cast<__nv_bfloat162*>(&w.y);
  return make_float4(__low2float(rg), __high2float(rg), __low2float(ba),
                     __high2float(ba));
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

__global__ void composite_kernel(
    const uint2* __restrict__ cf, int s, int yv, int xv,
    const float* __restrict__ g, const float* __restrict__ coords_y,
    const float* __restrict__ coords_x, const float* __restrict__ grid_v,
    const float* __restrict__ grid_u, const float* __restrict__ len_factor,
    const float* __restrict__ kstop, int hi, int wi, float e_u, float e_v,
    float slab_thickness, float attenuation, float* __restrict__ rgb,
    float* __restrict__ alpha) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= hi || j >= wi) return;
  const long long pix = static_cast<long long>(i) * wi + j;
  const float gv = grid_v[i];
  const float gu = grid_u[j];
  const float dy = yv > 1 ? coords_y[1] - coords_y[0] : 1.f;
  const float dx = xv > 1 ? coords_x[1] - coords_x[0] : 1.f;
  const float thickness0 = slab_thickness * len_factor[pix];
  const float ks = kstop != nullptr ? kstop[pix] : 0.f;

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_a = 0.f;
  for (int k = 0; k < s; ++k) {
    const float gk = __ldg(g + k);
    if (!(gk > kEps)) continue;  // inert slice
    const float qv = e_v + (gv - e_v) * gk;
    const float qu = e_u + (gu - e_u) * gk;
    int ty, tx;
    float wy0, wy1, wx0, wx1;
    taps(qv, coords_y, yv, dy, ty, wy0, wy1);
    taps(qu, coords_x, xv, dx, tx, wx0, wx1);
    if ((wy0 == 0.f && wy1 == 0.f) || (wx0 == 0.f && wx1 == 0.f)) continue;

    const uint2* slice = cf + static_cast<long long>(k) * yv * xv;
    const uint2 zero = make_uint2(0u, 0u);
    float4 col[2];  // the v-resample at columns tx, tx+1, rounded to bf16
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int x = tx + c;
      const bool in_x = x >= 0 && x < xv;
      const float4 a = unpack(in_x && wy0 != 0.f ? __ldg(slice + ty * xv + x) : zero);
      const float4 b = unpack(in_x && wy1 != 0.f ? __ldg(slice + (ty + 1) * xv + x) : zero);
      col[c] = make_float4(round_bf16(wy0 * a.x + wy1 * b.x),
                           round_bf16(wy0 * a.y + wy1 * b.y),
                           round_bf16(wy0 * a.z + wy1 * b.z),
                           round_bf16(wy0 * a.w + wy1 * b.w));
    }
    const float sr = wx0 * col[0].x + wx1 * col[1].x;
    const float sg = wx0 * col[0].y + wx1 * col[1].y;
    const float sb = wx0 * col[0].z + wx1 * col[1].z;
    const float tau = wx0 * col[0].w + wx1 * col[1].w;

    float thickness = thickness0;
    if (kstop != nullptr) {
      thickness *= fminf(fmaxf(ks - static_cast<float>(k), 0.f), 1.f);
    }
    const float al = 1.f - expf(-tau * thickness * attenuation);
    const float w = (1.f - acc_a) * (al / fmaxf(tau, kEps));
    acc_r += w * sr;
    acc_g += w * sg;
    acc_b += w * sb;
    acc_a += (1.f - acc_a) * al;
  }
  rgb[pix * 3 + 0] = acc_r;
  rgb[pix * 3 + 1] = acc_g;
  rgb[pix * 3 + 2] = acc_b;
  alpha[pix] = acc_a;
}

}  // namespace

extern "C" int correrender_shearwarp_composite(
    const void* cf, int s, int yv, int xv, const void* g, const void* coords_y,
    const void* coords_x, const void* grid_v, const void* grid_u,
    const void* len_factor, const void* kstop, int hi, int wi, float e_u,
    float e_v, float slab_thickness, float attenuation, void* rgb, void* alpha,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 block(32, 8);
  const dim3 grid((wi + block.x - 1) / block.x, (hi + block.y - 1) / block.y);
  composite_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(cf), s, yv, xv, static_cast<const float*>(g),
      static_cast<const float*>(coords_y), static_cast<const float*>(coords_x),
      static_cast<const float*>(grid_v), static_cast<const float*>(grid_u),
      static_cast<const float*>(len_factor), static_cast<const float*>(kstop),
      hi, wi, e_u, e_v, slab_thickness, attenuation, static_cast<float*>(rgb),
      static_cast<float*>(alpha));
  return cudaGetLastError();
}
