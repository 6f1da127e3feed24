// B10: KSG mutual information with the reference's x-sorted rank band.
//
// Replaces correrender_tpu/ops/pallas/ksg_banded.py::mi_ksg_banded
// (_banded_full). It computes what B9 (ksg.cu) computes, point for
// point: the same k-th distances, the same counts, the same ψ terms;
// only the order of the ψ sum differs.
//
// The reference series is shared by every voxel, so the wrapper sorts
// the noised x once (perm, xs). In that order the k-th neighbour of
// point i lies inside the rank band j ∈ [i − W/2, i + W/2) whenever the
// nearest x outside the band is farther than r + ε (the gap check of
// ksg_banded.py:342-343): every point outside has |Δx| ≥ gap > r. A
// point that fails the check joins its warp's repair queue (shared
// memory, any length up to n); after the band pass the warp's lanes
// recompute the queued points from their full rows, by the same device
// functions B9 uses. So there is no repair tier and no escalation to B9
// (the JAX kernel's 256-point tier and lax.cond exist because its
// repair is a dense block of fixed height).
//
// Counts: x by binary search in xs; y by binary search in a copy of the
// voxel's noised y that the warp sorts in shared memory (bitonic). Both
// count exactly the j with v_j ∈ [v_i − r, v_i + r) that B9 counts by
// scanning, for any radius, since comparisons against a sorted array
// are monotone. Per point the work is the band (W ≈ 192 pairs) and two
// binary searches instead of B9's 2n pairs.
//
// Bound on the H100: f32 operations (the band's pairs), as for B9.
//
// Selection ties: KSmallest keeps the multiset, so tied distances need
// no repair (the TPU kernel's tie-oblivious selection routes tied
// columns to repair, _band_select's tie_ok).

#include <cuda_runtime.h>

#include "ksg_common.cuh"

namespace {

using namespace correrender;

constexpr float kBig = 1e30f;  // a gap past either end of the sorted x

// #{j < len : a[j] < value} for ascending a.
__device__ __forceinline__ int lower_bound(const float* a, int len,
                                           float value) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < value) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// #{j : lo ≤ a[j] < hi} for ascending a.
__device__ __forceinline__ int range_count(const float* a, int len, float lo,
                                           float hi) {
  return max(lower_bound(a, len, hi) - lower_bound(a, len, lo), 0);
}

// Ascending bitonic sort of a[0, len) (len a power of two) by one warp.
__device__ void warp_bitonic_sort(float* a, int len, int lane) {
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < len; t += 32) {
        const int partner = t ^ stride;
        if (partner > t) {
          const float lo = a[t], hi = a[partner];
          const bool ascending = (t & size) == 0;
          if ((lo > hi) == ascending) {
            a[t] = hi;
            a[partner] = lo;
          }
        }
      }
      __syncwarp();
    }
  }
}

// Estimator 2's extents over [a, b), the counts by binary search, the
// per-point counts if asked; returns the point's ψ terms.
__device__ __forceinline__ float finish_point(
    const float* xs, const float* ys, const float* ysorted,
    const int* __restrict__ perm, int* __restrict__ counts, long long voxel,
    int n, int i, float r, int a, int b, int estimator) {
  const float xi = xs[i], yi = ys[i];
  float ex = 0.0f, ey = 0.0f;
  if (estimator == 2) neighbour_extents(xs, ys, a, b, xi, yi, r, &ex, &ey);
  float rx, ry;
  count_radii(estimator, r, ex, ey, &rx, &ry);
  const int cx = range_count(xs, n, __fsub_rn(xi, rx), __fadd_rn(xi, rx));
  const int cy =
      range_count(ysorted, n, __fsub_rn(yi, ry), __fadd_rn(yi, ry));
  if (counts) {
    const int p = __ldg(perm + i);  // back to the series' own order
    counts[(voxel * n + p) * 2] = cx;
    counts[(voxel * n + p) * 2 + 1] = cy;
  }
  return psi_of_counts(estimator, cx, cy);
}

template <int KMAX>
__global__ void ksg_banded_kernel(const float* __restrict__ series,
                                  const int* __restrict__ perm,
                                  const float* __restrict__ xs_sorted,
                                  const float* __restrict__ y_noise,
                                  float* __restrict__ psi_sum,
                                  int* __restrict__ counts,
                                  int* __restrict__ repaired, long long v,
                                  int n, int npow2, int half_band, int kp1,
                                  int estimator) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  float* xs = smem;
  float* ys = smem + n + warp * (2 * n + npow2);  // y in x-sorted order
  float* ysorted = ys + n;                        // y ascending
  int* queue = reinterpret_cast<int*>(ysorted + npow2);  // points to repair
  for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = xs_sorted[j];
  const long long voxel = static_cast<long long>(blockIdx.x) * warps + warp;
  const bool live = voxel < v;
  int nan_seen = 0;
  if (live) {
    const float* y = series + voxel * n;
    for (int j = lane; j < npow2; j += 32) {
      float yj = INFINITY;
      if (j < n) {
        const int p = __ldg(perm + j);
        yj = __ldg(y + p);
        nan_seen |= isnan(yj);
        if (y_noise) yj = __fadd_rn(yj, __ldg(y_noise + p));
        ys[j] = yj;
      }
      ysorted[j] = yj;
    }
  }
  __syncthreads();
  if (!live) return;
  if (__any_sync(kFullMask, nan_seen)) {
    if (lane == 0) {
      psi_sum[voxel] = NAN;
      if (repaired) repaired[voxel] = 0;
    }
    return;
  }
  warp_bitonic_sort(ysorted, npow2, lane);
  // Pass 1: every point through its band; a point that fails the gap
  // check joins the warp's repair queue (lanes stay in step: a repair
  // inside this loop would hold the other 31 lanes for a full row).
  float acc = 0.0f;
  int queued = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    bool repair = false;
    if (i < n) {
      const float xi = xs[i], yi = ys[i];
      const int j0 = max(i - half_band, 0), j1 = min(i + half_band, n);
      const float r = kth_distance<KMAX>(xs, ys, j0, j1, xi, yi, kp1);
      const float margin = __fadd_rn(r, kCountEpsilon);
      const float gap_lo = i - half_band - 1 >= 0
                               ? __fsub_rn(xi, xs[i - half_band - 1]) : kBig;
      const float gap_hi =
          i + half_band < n ? __fsub_rn(xs[i + half_band], xi) : kBig;
      repair = !(gap_lo > margin && gap_hi > margin);
      if (!repair) {
        acc += finish_point(xs, ys, ysorted, perm, counts, voxel, n, i, r,
                            j0, j1, estimator);
      }
    }
    const unsigned votes = __ballot_sync(kFullMask, repair);
    if (repair) queue[queued + __popc(votes & ((1u << lane) - 1u))] = i;
    queued += __popc(votes);
  }
  __syncwarp();
  // Pass 2: the queued points from their full rows, B9's code, one lane
  // each.
  for (int q = lane; q < queued; q += 32) {
    const int i = queue[q];
    const float r = kth_distance<KMAX>(xs, ys, 0, n, xs[i], ys[i], kp1);
    acc += finish_point(xs, ys, ysorted, perm, counts, voxel, n, i, r, 0, n,
                        estimator);
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    psi_sum[voxel] = acc;
    if (repaired) repaired[voxel] = queued;
  }
}

template <int KMAX>
cudaError_t launch(const float* series, const int* perm,
                   const float* xs_sorted, const float* y_noise,
                   float* psi_sum, int* counts, int* repaired, long long v,
                   int n, int half_band, int kp1, int estimator,
                   cudaStream_t stream) {
  int npow2 = 32;
  while (npow2 < n) npow2 <<= 1;
  int warps;
  size_t smem;
  if (!launch_shape(n * sizeof(float), (2 * n + npow2) * sizeof(float),
                    &warps, &smem)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_shared(ksg_banded_kernel<KMAX>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (v + warps - 1) / warps;
  ksg_banded_kernel<KMAX><<<static_cast<unsigned>(blocks), warps * 32, smem,
                            stream>>>(series, perm, xs_sorted, y_noise,
                                      psi_sum, counts, repaired, v, n, npow2,
                                      half_band, kp1, estimator);
  return cudaGetLastError();
}

}  // namespace

extern "C" int correrender_mi_ksg_banded(
    const void* series, const void* perm, const void* xs_sorted,
    const void* y_noise, void* psi_sum, void* counts, void* repaired,
    long long v, int n, int w_band, int k, int estimator, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto* s = static_cast<const float*>(series);
  const auto* p = static_cast<const int*>(perm);
  const auto* xs = static_cast<const float*>(xs_sorted);
  const auto* ny = static_cast<const float*>(y_noise);
  auto* psi = static_cast<float*>(psi_sum);
  auto* c = static_cast<int*>(counts);
  auto* rep = static_cast<int*>(repaired);
  auto st = static_cast<cudaStream_t>(stream);
  const int kp1 = k + 1, hb = w_band / 2;
  if (kp1 <= 4) {
    return launch<4>(s, p, xs, ny, psi, c, rep, v, n, hb, kp1, estimator, st);
  }
  if (kp1 <= 8) {
    return launch<8>(s, p, xs, ny, psi, c, rep, v, n, hb, kp1, estimator, st);
  }
  if (kp1 <= kMaxNeighbours) {
    return launch<kMaxNeighbours>(s, p, xs, ny, psi, c, rep, v, n, hb, kp1,
                                  estimator, st);
  }
  return cudaErrorInvalidValue;
}
