// B8: Kendall tau-b pair counts in integers.
//
// Replaces correrender_tpu/ops/pallas/kendall_kernel.py::kendall_pallas
// (_kendall_flat). Over all ordered pairs (i, j) of a voxel's members
// the kernel counts, in 32-bit integers,
//
//     num = Σ sign(x_i − x_j)·sign(y_i − y_j),
//     ty  = #{y_i == y_j},  txy = #{x_i == x_j and y_i == y_j}
//
// (the diagonal included in the ties), and flags a NaN in y. The x ties
// are the same for every voxel; the wrapper counts them once and
// assembles tau in the JAX package's float32 order
// (ops/kendall.py::tau_from_counts), with the reference's joint ties
// n3 subtracted from the numerator (Correlation.cpp:444). The counts
// are exact up to n = 46340, so there is no f32 limit on n (the JAX
// route stops at n = 4000, correlation.py:237-242).
//
// Bound on the H100: integer compares, n² pairs per voxel against n
// reads.
//
// Design: one warp per voxel (ksg_common.cuh); x in shared memory once
// per block.

#include <cuda_runtime.h>

#include "ksg_common.cuh"

namespace {

using namespace correrender;

__global__ void kendall_kernel(const float* __restrict__ series,
                               const float* __restrict__ ref,
                               int* __restrict__ counts, long long v, int n) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  float* xs = smem;
  float* ys = smem + n + warp * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = ref[j];
  const long long voxel = static_cast<long long>(blockIdx.x) * warps + warp;
  const bool live = voxel < v;
  int nan_seen = 0;
  if (live) {
    const float* y = series + voxel * n;
    for (int j = lane; j < n; j += 32) {
      const float yj = __ldcs(y + j);
      nan_seen |= isnan(yj);
      ys[j] = yj;
    }
  }
  __syncthreads();
  if (!live) return;
  int num = 0, ty = 0, txy = 0;
  for (int i = lane; i < n; i += 32) {
    const float xi = xs[i], yi = ys[i];
    for (int j = 0; j < n; ++j) {
      const float xj = xs[j], yj = ys[j];
      const int sx = (xi > xj) - (xi < xj);
      const int sy = (yi > yj) - (yi < yj);
      const int tie_y = yi == yj;
      num += sx * sy;
      ty += tie_y;
      txy += tie_y & (xi == xj);
    }
  }
  num = warp_sum(num);
  ty = warp_sum(ty);
  txy = warp_sum(txy);
  nan_seen = __any_sync(kFullMask, nan_seen);
  if (lane == 0) {
    int* out = counts + voxel * 4;
    out[0] = num;
    out[1] = ty;
    out[2] = txy;
    out[3] = nan_seen;
  }
}

}  // namespace

extern "C" int correrender_kendall(const void* series, const void* ref,
                                   void* counts, long long v, int n,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int warps;
  size_t smem;
  if (!launch_shape(n * sizeof(float), n * sizeof(float), &warps, &smem)) {
    return cudaErrorInvalidValue;
  }
  err = allow_shared(kendall_kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (v + warps - 1) / warps;
  kendall_kernel<<<static_cast<unsigned>(blocks), warps * 32, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(series), static_cast<const float*>(ref),
      static_cast<int*>(counts), v, n);
  return cudaGetLastError();
}
