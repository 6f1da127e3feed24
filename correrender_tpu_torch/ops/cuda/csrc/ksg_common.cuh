// Device functions shared by the rank and mutual-information kernels
// (spearman.cu, kendall.cu, ksg.cu, ksg_banded.cu); below count_radii,
// those of the two KSG kernels, B9 and B10: the ψ table, the marginal
// counts by binary search, the voxel's y sort and estimator 2's extents.
//
// Replaces correrender_tpu/ops/pallas/common.py (digamma_vpu,
// select_kth). The same ψ series runs in torch in ops/special.py, so a
// kernel and its plain version evaluate ψ alike.
//
// Layout shared by the four kernels: one warp per voxel (B8 and B10:
// four voxels a warp up to kNarrowMaxMembers members). The reference
// series (or its ranks, or its order) sits in shared memory once per
// block, each voxel's series beside it (B9 and B10: the reference
// sorted, its ψ table, and each voxel's y in x order and sorted).

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
// so the list stays in registers; B10 instantiates 4, 8 and 16, B9 each
// kp1 = KMAX from 2 to 16.
template <int KMAX>
struct KSmallest {
  float top[KMAX];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int t = 0; t < KMAX; ++t) top[t] = INFINITY;
  }

  __device__ __forceinline__ void push(float d, int kp1) {
    if (!(d < top[0])) return;
    insert(d, kp1);
  }

  // push without its check: a d ≥ top[0] (or NaN) leaves the list as it
  // is, so the network is right for any d; with kp1 = KMAX known at
  // compile time it is 2·kp1 − 1 min/max operations.
  __device__ __forceinline__ void insert(float d, int kp1) {
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

// The block's table of ψ(m) = digamma_series(m) at m = 1..n (psi[0] =
// ψ(1)), filled by all its threads; read by psi_terms.
__device__ __forceinline__ void fill_psi_table(float* psi, int n) {
  for (int m = threadIdx.x; m <= n; m += blockDim.x) {
    psi[m] = digamma_series(static_cast<float>(max(m, 1)));
  }
}

// ψ terms of one point from its marginal counts (centre included):
// ψ(max(c, 1)) a count for estimator 1, ψ(max(c − 1, 1)) for estimator 2,
// read from the block's table.
__device__ __forceinline__ float psi_terms(const float* psi, int estimator,
                                           int cx, int cy) {
  const int off = estimator == 1 ? 0 : 1;
  return psi[max(cx - off, 1)] + psi[max(cy - off, 1)];
}

// Where x-order index j sits in B9's shared arrays of the x order: the
// low log2(R) bits of j XORed with bits 5 and up, so that the 32 lanes
// of a warp reading points R apart (R a power of two ≤ 32) hit 32
// distinct banks. A bijection within each aligned group of R values, so
// an array padded to a multiple of R holds it; R = 1 (B10) leaves j as
// it is.
template <int R>
__device__ __forceinline__ int swizzled(int j) {
  return j ^ ((j >> 5) & (R - 1));
}

// The marginal counts #{j : v_j ∈ [v − r, v + r)} of a point in xs (n
// values in x order, stored swizzled<R>, read as +inf past them) and in
// ysorted (len values, +inf past n; len a power of two), by four
// interleaved branch-free binary searches: each finds #{j : a[j] <
// bound}, as a lower bound does. The count is exactly the scan's, for
// any radius (a negative one gives 0): comparisons against a sorted
// array are monotone, and −0 and +0 compare equal in either order.
template <int R = 1>
__device__ __forceinline__ void marginal_counts(const float* xs,
                                                const float* ysorted, int n,
                                                int len, float xi, float yi,
                                                float rx, float ry, int* cx,
                                                int* cy) {
  const float bound[4] = {__fsub_rn(xi, rx), __fadd_rn(xi, rx),
                          __fsub_rn(yi, ry), __fadd_rn(yi, ry)};
  int pos[4] = {0, 0, 0, 0};
  for (int half = len >> 1; half > 0; half >>= 1) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = pos[b] + half - 1;
      const float a =
          b < 2 ? (j < n ? xs[swizzled<R>(j)] : INFINITY) : ysorted[j];
      pos[b] += a < bound[b] ? half : 0;
    }
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int j = pos[b];
    pos[b] +=
        (b < 2 ? (j < n ? xs[swizzled<R>(j)] : INFINITY) : ysorted[j]) <
        bound[b];
  }
  *cx = max(pos[1] - pos[0], 0);
  *cy = max(pos[3] - pos[2], 0);
}

// The compare-exchange stages (size, stride) of a bitonic sort, stride
// from `top` down to 1, on the E·LANES values of a chunk held E to a
// lane (lane sub holds global indices first + E·sub, ..., + E − 1): a
// partner fewer than E places away is in the lane's own registers, one
// E or more away in lane sub ^ (stride / E), a shuffle away. Equal
// values compare alike in either order (−0 and +0 included), so min and
// max keep the counts.
template <int LANES, int E>
__device__ __forceinline__ void register_stages(float (&r)[E], int first,
                                                int sub, int size, int top) {
#pragma unroll
  for (int stride = E * LANES / 2; stride > 0; stride >>= 1) {
    if (stride > top) continue;
    if (stride < E) {
#pragma unroll
      for (int t = 0; t < E; ++t) {
        if ((t & stride) == 0) {
          const int u = t | stride;
          const bool ascending = ((first + E * sub + t) & size) == 0;
          const float lo = fminf(r[t], r[u]), hi = fmaxf(r[t], r[u]);
          r[t] = ascending ? lo : hi;
          r[u] = ascending ? hi : lo;
        }
      }
    } else {
      const int apart = stride / E;
      const bool lower = (sub & apart) == 0;
#pragma unroll
      for (int t = 0; t < E; ++t) {
        const float other = __shfl_xor_sync(kFullMask, r[t], apart);
        const bool ascending = ((first + E * sub + t) & size) == 0;
        r[t] = lower == ascending ? fminf(r[t], other) : fmaxf(r[t], other);
      }
    }
  }
}

// Ascending bitonic sort of a[0, len) (len a power of two, a multiple of
// E·LANES) by the LANES lanes of one voxel; every lane of the warp takes
// part in every step. Stages whose partners lie within a chunk of E·LANES
// values run in registers, the wider ones in shared memory.
template <int LANES, int E>
__device__ void chunked_bitonic_sort(float* a, int len, int sub) {
  constexpr int kChunk = E * LANES;
  float r[E];
  for (int first = 0; first < len; first += kChunk) {
#pragma unroll
    for (int t = 0; t < E; ++t) r[t] = a[first + E * sub + t];
#pragma unroll
    for (int size = 2; size <= kChunk; size <<= 1) {
      register_stages<LANES, E>(r, first, sub, size, size / 2);
    }
#pragma unroll
    for (int t = 0; t < E; ++t) a[first + E * sub + t] = r[t];
  }
  __syncwarp();
  for (int size = 2 * kChunk; size <= len; size <<= 1) {
    for (int stride = size / 2; stride >= kChunk; stride >>= 1) {
      for (int t = sub; t < len; t += LANES) {
        const int partner = t ^ stride;
        if (partner > t) {
          const float lo = a[t], hi = a[partner];
          if ((lo > hi) == ((t & size) == 0)) {
            a[t] = hi;
            a[partner] = lo;
          }
        }
      }
      __syncwarp();
    }
    for (int first = 0; first < len; first += kChunk) {
#pragma unroll
      for (int t = 0; t < E; ++t) r[t] = a[first + E * sub + t];
      register_stages<LANES, E>(r, first, sub, size, kChunk / 2);
#pragma unroll
      for (int t = 0; t < E; ++t) a[first + E * sub + t] = r[t];
    }
    __syncwarp();
  }
}

// Ascending sort of a voxel's y (len a power of two ≥ LANES): up to 8
// values a lane in registers, in chunks of 8·LANES beyond.
template <int LANES>
__device__ __forceinline__ void sort_y(float* a, int len, int sub) {
  if (len == LANES) {
    chunked_bitonic_sort<LANES, 1>(a, len, sub);
  } else if (len == 2 * LANES) {
    chunked_bitonic_sort<LANES, 2>(a, len, sub);
  } else if (len == 4 * LANES) {
    chunked_bitonic_sort<LANES, 4>(a, len, sub);
  } else {
    chunked_bitonic_sort<LANES, 8>(a, len, sub);
  }
}

// |xs[j] − xi| (xs stored swizzled<R>), or +inf past either end.
template <int R = 1>
__device__ __forceinline__ float x_gap(const float* xs, int n, int j,
                                       float xi) {
  return j >= 0 && j < n ? fabsf(__fsub_rn(xs[swizzled<R>(j)], xi))
                         : INFINITY;
}

// Estimator 2's extents (max |dx|, |dy| over {j : dch_j ≤ r}, ties
// included) of point (xi, yi) with the reference xs sorted ascending:
// the range (lo, hi) once, then on along each side while |Δx| ≤ r.
// The rounded |Δx| never decreases along a side, so every j with
// dch_j ≤ r lies in that window, for any (lo, hi) around the point.
// Neither extent can pass r, so a side stops once both have reached it.
// xs and ys are stored swizzled<R>.
template <int R = 1>
__device__ __forceinline__ void walk_extents(const float* xs,
                                             const float* ys, int n,
                                             float xi, float yi, float r,
                                             int lo, int hi, float* ex,
                                             float* ey) {
  float mx = -1.0f, my = -1.0f;
  for (int j = lo + 1; j < hi; ++j) {
    const float dx = fabsf(__fsub_rn(xs[swizzled<R>(j)], xi));
    const float dy = fabsf(__fsub_rn(ys[swizzled<R>(j)], yi));
    if (fmaxf(dx, dy) <= r) {
      mx = fmaxf(mx, dx);
      my = fmaxf(my, dy);
    }
  }
  for (int step = -1; step <= 1; step += 2) {
    int j = step < 0 ? lo : hi;
    while (!(mx == r && my == r)) {
      const float dx = x_gap<R>(xs, n, j, xi);
      if (!(dx <= r)) break;
      const float dy = fabsf(__fsub_rn(ys[swizzled<R>(j)], yi));
      if (fmaxf(dx, dy) <= r) {
        mx = fmaxf(mx, dx);
        my = fmaxf(my, dy);
      }
      j += step;
    }
  }
  *ex = mx;
  *ey = my;
}

}  // namespace correrender
