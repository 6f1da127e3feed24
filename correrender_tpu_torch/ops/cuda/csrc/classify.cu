// K2: transfer-function classification into the compositor's layout.
//
// Replaces correrender_tpu/ops/pallas/shearwarp_kernel.py::classify_to_cf.
// Semantics follow the f32 reference render/classify.py:34-41, not the
// TPU kernel: u = clip((v − lo)/(hi − lo), 0, 1)·(R − 1), a linear
// lerp of the premultiplied LUT at u, NaN → transparent black, and a
// degenerate domain (hi ≤ lo) maps every finite value to bin 0 (the TPU
// kernel divides by zero there).
//
// Bound on the H100: device-memory traffic, 4 bytes read and 8 bytes
// written per voxel; the LUT (R·16 bytes) stays in L1.
//
// Design: one thread per voxel of the slice-oriented volume
// (S, Yv, Xv). The kernel reads the (Z, Y, X) field through the
// permute-and-flip strides of the camera's slice orientation, so no
// transposed copy of the field is made; the lerp is direct (two LUT
// reads), where the TPU needed a two-hot matrix product because it has
// no fast gather. The four channels are rounded to bf16 and stored as
// one 8-byte word, in the (S, Yv, Xv, 4) layout that K3 reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
  const float val = field[s * st_s + iv * st_v + iu * st_u];

  float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!isnan(val)) {
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
  }
  __nv_bfloat162 rg = __floats2bfloat162_rn(c.x, c.y);
  __nv_bfloat162 ba = __floats2bfloat162_rn(c.z, c.w);
  uint2 word;
  word.x = *reinterpret_cast<unsigned int*>(&rg);
  word.y = *reinterpret_cast<unsigned int*>(&ba);
  out[static_cast<long long>(s) * yv * xv + p] = word;
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
