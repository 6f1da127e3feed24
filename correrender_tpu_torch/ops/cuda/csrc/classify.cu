// K2 and B3: transfer-function classification.
//
// K2 (correrender_classify_cf) replaces
// correrender_tpu/ops/pallas/shearwarp_kernel.py::classify_to_cf: it
// classifies into the shear-warp compositor's bf16 layout.
// B3 (correrender_classify_volume) replaces
// correrender_tpu/ops/pallas/classify_kernel.py::classify_pallas: it
// classifies a field into (Z, Y, X, 4) float32.
//
// Both share lut_lerp, whose semantics follow the f32 reference
// render/classify.py:34-41, not the TPU kernels (which round the tent
// weights and the LUT to bf16, classify_kernel.py:39-43): u = clip((v −
// lo)/(hi − lo), 0, 1)·(R − 1), a linear lerp of the premultiplied LUT
// at u, NaN → transparent black, and a degenerate domain (hi ≤ lo) maps
// every finite value to bin 0 (the TPU kernels divide by zero there).
//
// Bound on the H100: device-memory traffic. K2 reads 4 bytes and writes
// 8 per voxel, B3 reads 4 and writes 16; the LUT (R·16 bytes) stays in
// L1. The lerp is direct (two LUT reads), where the TPU needed a two-hot
// matrix product because it has no fast gather.
//
// K2 is one thread per voxel of the slice-oriented volume (S, Yv, Xv).
// It reads the (Z, Y, X) field through the permute-and-flip strides of
// the camera's slice orientation, so no transposed copy of the field is
// made, rounds the four channels to bf16 and stores them as one 8-byte
// word, in the (S, Yv, Xv, 4) layout that K3 reads.
// B3 is one thread per voxel of a contiguous field, one 16-byte store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float4 lut_lerp(float val,
                                           const float4* __restrict__ lutp,
                                           int res, float lo, float hi) {
  float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
  if (isnan(val)) return c;
  const float span = hi - lo;
  float u = 0.f;
  if (span > 0.f) {
    u = fminf(fmaxf((val - lo) / span, 0.f), 1.f) * static_cast<float>(res - 1);
  }
  const int i0 = min(static_cast<int>(floorf(u)), res - 1);
  const int i1 = min(i0 + 1, res - 1);
  const float f = u - static_cast<float>(i0);
  const float4 a = __ldg(lutp + i0);
  const float4 b = __ldg(lutp + i1);
  c.x = (1.f - f) * a.x + f * b.x;
  c.y = (1.f - f) * a.y + f * b.y;
  c.z = (1.f - f) * a.z + f * b.z;
  c.w = (1.f - f) * a.w + f * b.w;
  return c;
}

__global__ void classify_cf_kernel(const float* __restrict__ field,
                                   long long st_s, long long st_v,
                                   long long st_u, int yv, int xv,
                                   const float4* __restrict__ lutp, int res,
                                   float lo, float hi,
                                   uint2* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= yv * xv) return;
  const int s = blockIdx.y;
  const int iv = p / xv;
  const int iu = p - iv * xv;
  const float4 c = lut_lerp(field[s * st_s + iv * st_v + iu * st_u], lutp,
                            res, lo, hi);
  __nv_bfloat162 rg = __floats2bfloat162_rn(c.x, c.y);
  __nv_bfloat162 ba = __floats2bfloat162_rn(c.z, c.w);
  uint2 word;
  word.x = *reinterpret_cast<unsigned int*>(&rg);
  word.y = *reinterpret_cast<unsigned int*>(&ba);
  out[static_cast<long long>(s) * yv * xv + p] = word;
}

__global__ void classify_volume_kernel(const float* __restrict__ field,
                                       long long n,
                                       const float4* __restrict__ lutp,
                                       int res, float lo, float hi,
                                       float4* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = lut_lerp(__ldg(field + i), lutp, res, lo, hi);
}

}  // namespace

extern "C" int correrender_classify_cf(
    const void* field, long long offset, long long st_s, long long st_v,
    long long st_u, int s, int yv, int xv, const void* lutp, int res,
    float lo, float hi, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  constexpr int kThreads = 256;
  const dim3 grid((yv * xv + kThreads - 1) / kThreads, s);
  classify_cf_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(field) + offset, st_s, st_v, st_u, yv, xv,
      static_cast<const float4*>(lutp), res, lo, hi, static_cast<uint2*>(out));
  return cudaGetLastError();
}

extern "C" int correrender_classify_volume(const void* field, long long n,
                                           const void* lutp, int res,
                                           float lo, float hi, void* out,
                                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  constexpr int kThreads = 256;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  classify_volume_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(field), n, static_cast<const float4*>(lutp),
      res, lo, hi, static_cast<float4*>(out));
  return cudaGetLastError();
}
