// B9: KSG mutual information over the full pairwise Chebyshev rows,
// estimators 1 and 2.
//
// Replaces correrender_tpu/ops/pallas/ksg_kernel.py::mi_ksg_pallas
// (_mi_ksg_flat). Semantics: ops/mi_ksg.py (reference
// MutualInformation.cpp:399-509): the (k+1)-th smallest Chebyshev
// distance of each point, self and ties included; per-axis counts over
// the half-open [v − r, v + r); ψ sums; the constant ψ(k) + ψ(n)
// (− 1/k) and the clamp at 0 are applied by the wrapper.
//
// Bound on the H100: f32 operations. Each voxel costs about n² point
// pairs, 2 passes (3 for estimator 2) of about 6 operations each, while
// it reads only its n values once; at n = 1000 that is some 10⁴
// operations per byte, far past the H100's 20 f32 operations per byte.
//
// Design: one warp per voxel. The noised reference series sits in
// shared memory once per block, each warp's noised voxel series beside
// it; the tie-break noise is added here from the (n,) noise vector, so
// no noised copy of the stack is made. A lane takes points
// i = lane, lane + 32, ... and keeps the k+1 smallest distances of its
// row in registers (KSmallest), which is select_kth's answer exactly.
// The noised values, the count boundaries x_i ± r and r ∓ ε are rounded
// with __fadd_rn/__fsub_rn as the plain version rounds them: an FMA
// there would move a count, and ψ by a whole step. A voxel with a NaN
// gives NaN (the wrapper applies the reference series' NaN).

#include <cuda_runtime.h>

#include "ksg_common.cuh"

namespace {

using namespace correrender;

// The k-th distance of point (xi, yi) over points [j0, j1) of (x, y).
template <int KMAX>
__device__ __forceinline__ float kth_distance(const float* x, const float* y,
                                              int j0, int j1, float xi,
                                              float yi, int kp1) {
  KSmallest<KMAX> best;
  best.reset();
  for (int j = j0; j < j1; ++j) best.push(chebyshev(xi, yi, x[j], y[j]), kp1);
  return best.top[0];
}

// Estimator 2's per-axis extents of the neighbour set over [j0, j1).
__device__ __forceinline__ void neighbour_extents(const float* x,
                                                  const float* y, int j0,
                                                  int j1, float xi, float yi,
                                                  float r, float* ex,
                                                  float* ey) {
  float mx = -1.0f, my = -1.0f;
  for (int j = j0; j < j1; ++j) {
    const float dx = fabsf(__fsub_rn(x[j], xi));
    const float dy = fabsf(__fsub_rn(y[j], yi));
    if (fmaxf(dx, dy) <= r) {
      mx = fmaxf(mx, dx);
      my = fmaxf(my, dy);
    }
  }
  *ex = mx;
  *ey = my;
}

template <int KMAX>
__global__ void ksg_kernel(const float* __restrict__ series,
                           const float* __restrict__ x_noised,
                           const float* __restrict__ y_noise,
                           float* __restrict__ psi_sum,
                           int* __restrict__ counts, long long v, int n,
                           int kp1, int estimator) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  float* xs = smem;
  float* ys = smem + n + warp * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = x_noised[j];
  const long long voxel = static_cast<long long>(blockIdx.x) * warps + warp;
  const bool live = voxel < v;
  int nan_seen = 0;
  if (live) {
    const float* y = series + voxel * n;
    for (int j = lane; j < n; j += 32) {
      const float yj = __ldcs(y + j);
      nan_seen |= isnan(yj);
      ys[j] = y_noise ? __fadd_rn(yj, __ldg(y_noise + j)) : yj;
    }
  }
  __syncthreads();
  if (!live) return;
  if (__any_sync(kFullMask, nan_seen)) {
    if (lane == 0) psi_sum[voxel] = NAN;
    return;
  }
  float acc = 0.0f;
  for (int i = lane; i < n; i += 32) {
    const float xi = xs[i], yi = ys[i];
    const float r = kth_distance<KMAX>(xs, ys, 0, n, xi, yi, kp1);
    float ex = 0.0f, ey = 0.0f;
    if (estimator == 2) neighbour_extents(xs, ys, 0, n, xi, yi, r, &ex, &ey);
    float rx, ry;
    count_radii(estimator, r, ex, ey, &rx, &ry);
    const float xlo = __fsub_rn(xi, rx), xhi = __fadd_rn(xi, rx);
    const float ylo = __fsub_rn(yi, ry), yhi = __fadd_rn(yi, ry);
    int cx = 0, cy = 0;
    for (int j = 0; j < n; ++j) {
      const float xj = xs[j], yj = ys[j];
      cx += (xj >= xlo) & (xj < xhi);
      cy += (yj >= ylo) & (yj < yhi);
    }
    if (counts) {
      counts[(voxel * n + i) * 2] = cx;
      counts[(voxel * n + i) * 2 + 1] = cy;
    }
    acc += psi_of_counts(estimator, cx, cy);
  }
  acc = warp_sum(acc);
  if (lane == 0) psi_sum[voxel] = acc;
}

template <int KMAX>
cudaError_t launch(const float* series, const float* x_noised,
                   const float* y_noise, float* psi_sum, int* counts,
                   long long v, int n, int kp1, int estimator,
                   cudaStream_t stream) {
  int warps;
  size_t smem;
  if (!launch_shape(n * sizeof(float), n * sizeof(float), &warps, &smem)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_shared(ksg_kernel<KMAX>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (v + warps - 1) / warps;
  ksg_kernel<KMAX><<<static_cast<unsigned>(blocks), warps * 32, smem,
                     stream>>>(series, x_noised, y_noise, psi_sum, counts, v,
                               n, kp1, estimator);
  return cudaGetLastError();
}

}  // namespace

extern "C" int correrender_mi_ksg(const void* series, const void* x_noised,
                                  const void* y_noise, void* psi_sum,
                                  void* counts, long long v, int n, int k,
                                  int estimator, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto* s = static_cast<const float*>(series);
  const auto* x = static_cast<const float*>(x_noised);
  const auto* ny = static_cast<const float*>(y_noise);
  auto* psi = static_cast<float*>(psi_sum);
  auto* c = static_cast<int*>(counts);
  auto st = static_cast<cudaStream_t>(stream);
  const int kp1 = k + 1;
  if (kp1 <= 4) return launch<4>(s, x, ny, psi, c, v, n, kp1, estimator, st);
  if (kp1 <= 8) return launch<8>(s, x, ny, psi, c, v, n, kp1, estimator, st);
  if (kp1 <= kMaxNeighbours) {
    return launch<kMaxNeighbours>(s, x, ny, psi, c, v, n, kp1, estimator, st);
  }
  return cudaErrorInvalidValue;
}
