// K1: fused one-pass Pearson correlation over the member axis.
//
// Replaces correrender_tpu/ops/pallas/pearson_kernel.py::pearson_pallas
// (_pearson_pallas_flat). Semantics: the reference's one-pass
// computePearson1 (Correlation.cpp:42-99),
//
//     r = (n·Σxy − Σx·Σy) / sqrt((n·Σxx − (Σx)²) · (n·Σyy − (Σy)²)),
//
// so a zero-variance series gives 0/0 = NaN, as in the reference.
//
// Bound on the H100: device-memory traffic. The kernel reads the
// (V, n) f32 stack exactly once (V·n·4 bytes) and writes V floats;
// it does about 5 flops per 4-byte load, far below the ~20 flop/byte
// where f32 arithmetic would become the limit.
//
// Design: the stack is member-last, so each voxel's series is one
// contiguous run. One warp owns one voxel: its lanes stride over the
// n members with coalesced loads (streaming cache hint: the stack is
// read once), keep Σy, Σy², Σxy in f32 registers and reduce them with
// warp shuffles. Σx and Σx² of the reference series are computed once
// outside and passed in `stats`. Plain f32 FMAs, no tensor cores: the
// TPU kernel needed Precision.HIGHEST because a single bf16 pass cost
// 3.4e-4; here there is no reduced-precision pass to avoid.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
pearson_kernel(const float* __restrict__ series,
               const float* __restrict__ ref,
               const float* __restrict__ stats,
               float* __restrict__ out, long long v, int n) {
  const long long voxel =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (voxel >= v) return;  // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const float* y = series + voxel * n;

  float sy = 0.f, syy = 0.f, sxy = 0.f;
#pragma unroll 4
  for (int j = lane; j < n; j += 32) {
    const float yj = __ldcs(y + j);
    const float xj = __ldg(ref + j);
    sy += yj;
    syy = fmaf(yj, yj, syy);
    sxy = fmaf(xj, yj, sxy);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sy += __shfl_xor_sync(0xffffffffu, sy, off);
    syy += __shfl_xor_sync(0xffffffffu, syy, off);
    sxy += __shfl_xor_sync(0xffffffffu, sxy, off);
  }
  if (lane == 0) {
    const float nn = static_cast<float>(n);
    const float sx = stats[0];
    const float sxx = stats[1];
    const float num = nn * sxy - sx * sy;
    const float den = sqrtf((nn * sxx - sx * sx) * (nn * syy - sy * sy));
    out[voxel] = num / den;
  }
}

}  // namespace

extern "C" int correrender_pearson(const void* series, const void* ref,
                                   const void* stats, void* out,
                                   long long v, int n, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long blocks = (v + kWarpsPerBlock - 1) / kWarpsPerBlock;
  pearson_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(series), static_cast<const float*>(ref),
      static_cast<const float*>(stats), static_cast<float*>(out), v, n);
  return cudaGetLastError();
}

extern "C" const char* correrender_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
