// Device functions shared by the rank and mutual-information kernels
// (spearman.cu, kendall.cu, ksg.cu, ksg_banded.cu).
//
// Replaces correrender_tpu/ops/pallas/common.py (digamma_vpu,
// select_kth). The same ψ series runs in torch in ops/special.py, so a
// kernel and its plain version evaluate ψ alike.
//
// Layout shared by the four kernels: one warp per voxel (B8 and B10:
// four voxels a warp up to kNarrowMaxMembers members). The reference
// series (or its ranks, or its order) sits in shared memory once per
// block, each voxel's series beside it.

#pragma once

#include <cuda_runtime.h>

namespace correrender {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kCountEpsilon = 1e-6f;  // MutualInformation.cpp:162-165
// The longest neighbour list a thread keeps in registers: k + 1 ≤ 16.
constexpr int kMaxNeighbours = 16;
// The shared memory a block may use (H100: 227 KB) and the share at
// which fewer warps per block are taken.
constexpr size_t kMaxSharedBytes = 232448;
constexpr size_t kTargetSharedBytes = 96 * 1024;
constexpr int kMaxWarpsPerBlock = 8;
// B8 and B10 give a voxel 8 lanes up to this many members, where a full
// warp's last pass over the members would leave most lanes idle, and a
// whole warp above it (PERF.md has the times of 32, 16 and 8 lanes).
constexpr int kNarrowMaxMembers = 128;

// Warps per block and dynamic shared bytes for `block_bytes` shared by
// the block plus `warp_bytes` per warp; false when one warp cannot fit.
inline bool launch_shape(size_t block_bytes, size_t warp_bytes, int* warps,
                         size_t* smem) {
  int w = kMaxWarpsPerBlock;
  while (w > 1 && block_bytes + w * warp_bytes > kTargetSharedBytes) --w;
  *warps = w;
  *smem = block_bytes + w * warp_bytes;
  return *smem <= kMaxSharedBytes;
}

template <typename Kernel>
inline cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// Sum over the LANES lanes that share one voxel (B8, B10: LANES = 8 or
// 32, 32 / LANES voxels a warp).
template <int LANES, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, off);
  }
  return v;
}

// ψ(x) for x ≥ 1: shift by 8 with the recurrence, then the asymptotic
// series (ops/special.py::digamma_series).
__device__ __forceinline__ float digamma_series(float x) {
  const float shifted = x + 8.0f;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc = acc + 1.0f / (x + static_cast<float>(i));
  const float inv = 1.0f / shifted;
  const float inv2 = inv * inv;
  return logf(shifted) - 0.5f * inv -
         inv2 * (1.0f / 12.0f - inv2 * (1.0f / 120.0f - inv2 / 252.0f)) - acc;
}

// The kp1 smallest values seen so far, a multiset kept in descending
// order: top[0] is the kp1-th smallest (select_kth's answer once every
// value has been pushed, self and ties included). Slots past kp1 stay
// +inf. A push that beats top[0] drops it and slides the new value into
// place without a branch per slot. KMAX ≥ kp1 is a compile-time bound,
// so the list stays in registers; the kernels instantiate 4, 8 and 16.
template <int KMAX>
struct KSmallest {
  float top[KMAX];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int t = 0; t < KMAX; ++t) top[t] = INFINITY;
  }

  __device__ __forceinline__ void push(float d, int kp1) {
    if (!(d < top[0])) return;
#pragma unroll
    for (int t = 0; t < KMAX; ++t) {
      if (t + 1 < kp1) {
        top[t] = fmaxf(top[t + 1 < KMAX ? t + 1 : t], fminf(top[t], d));
      } else if (t + 1 == kp1) {
        top[t] = fminf(top[t], d);
      }
    }
  }
};

// Chebyshev distance between points i and j of the joint (x, y) space.
__device__ __forceinline__ float chebyshev(float xi, float yi, float xj,
                                           float yj) {
  return fmaxf(fabsf(__fsub_rn(xj, xi)), fabsf(__fsub_rn(yj, yi)));
}

// The count radii of point i from its k-th distance r (estimator 1), or
// from the per-axis extents of its neighbour set (estimator 2: the max
// |dx|, |dy| over {j : dch_j ≤ r}, ties included), rounded as the plain
// version rounds them.
__device__ __forceinline__ void count_radii(int estimator, float r, float ex,
                                            float ey, float* rx, float* ry) {
  if (estimator == 1) {
    *rx = __fsub_rn(r, kCountEpsilon);
    *ry = *rx;
  } else {
    *rx = __fadd_rn(ex, kCountEpsilon);
    *ry = __fadd_rn(ey, kCountEpsilon);
  }
}

// ψ terms of one point from its marginal counts (centre included).
__device__ __forceinline__ float psi_of_counts(int estimator, int cx, int cy) {
  const float fx = static_cast<float>(cx), fy = static_cast<float>(cy);
  if (estimator == 1) {
    return digamma_series(fmaxf(fx, 1.0f)) + digamma_series(fmaxf(fy, 1.0f));
  }
  return digamma_series(fmaxf(fx - 1.0f, 1.0f)) +
         digamma_series(fmaxf(fy - 1.0f, 1.0f));
}

}  // namespace correrender
