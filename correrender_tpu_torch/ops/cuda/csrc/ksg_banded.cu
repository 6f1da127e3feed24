// B10: KSG mutual information by an exact pruned scan in x order.
//
// Replaces correrender_tpu/ops/pallas/ksg_banded.py::mi_ksg_banded
// (_banded_full). It computes what B9 (ksg.cu) computes, point for
// point: the same k-th distances, extents, counts and ψ terms; only the
// order of the ψ sum differs.
//
// Bound on the H100: the pairs it evaluates, read from shared memory,
// not the bytes of the stack. The TPU kernel takes each point's k-th
// neighbour from a band of W = 192 ranks around it in x order (clamped
// to n rounded up to 128, so the whole row at n = 100) and repairs the
// points whose gap check fails; a port of that design evaluated about
// 6·10¹¹ pairs/s on the H100, 1.6·10¹¹ pairs in 247 ms at 250³ × 100,
// where reading the stack takes 1.9 ms. The walk below evaluates only
// the slab around each point (87 ms there, PERF.md).
//
// Design: the wrapper sorts the noised reference once (perm, xs). For
// point i in that order the kernel walks outward, j = i − 1, i − 2, ...
// and j = i + 1, i + 2, ..., eight points down and eight up per round,
// and keeps the k+1 smallest Chebyshev distances in registers
// (KSmallest). A side stops once the last |Δx| it read is ≥ top[0], the
// current (k+1)-th smallest: |Δx| never decreases along a side (the
// rounded difference of ascending values is monotone), a point's
// distance is at least its |Δx|, top[0] never rises, and a push equal
// to top[0] leaves the multiset's (k+1)-th value as it is. So r is the
// full row's, bit for bit; the up to seven points a side reads past its
// stop are pushed as no-ops. Eight independent loads a round keep the
// walk from waiting on each load in turn. Estimator 2's extents need
// every j with dch ≤ r, ties included: a second walk re-reads the first
// walk's range with the final r, then goes on while |Δx| ≤ r, and stops
// early once both extents reach r (they cannot pass it; at r = 0 it
// stops at once). Under mass ties r can be 0, and the first walk stops
// at its first round that ends on |Δx| ≥ 0. When one side runs out the
// walk goes on along the other; there is no band, gap check or repair
// queue. For independent data a point's slab |Δx| < r holds about
// √((k+1)·n) points (about 20 at n = 100), against the full row before.
//
// Lanes: LANES lanes take one voxel, 32 / LANES voxels a warp; lane
// `sub` of a voxel takes points sub, sub + LANES, ...: 8 lanes up to
// kNarrowMaxMembers members, so that small ensembles do not leave most
// of a warp idle in its last round, else 32.
//
// Counts: x by binary search in xs; y by binary search in a copy of the
// voxel's noised y that its lanes sort (bitonic: every stage within a
// chunk of up to 8 values a lane in registers and shuffles, the wider
// stages in shared memory); the four searches of a point run
// interleaved, without branches. Both count exactly the j with
// v_j ∈ [v_i − r, v_i + r) that a scan of the row counts, for any
// radius, since comparisons against a sorted array are monotone. The ψ of a
// count comes from a table of ψ(1..n) that each block fills once with
// the same digamma_series. The searches, the sort, the ψ table and
// estimator 2's walk are ksg_common.cuh's, shared with B9.
//
// `repaired` counts, per voxel, the points whose answer needs a point
// outside the rank band [i − W/2, i + W/2): one with |Δx| < r, or for
// estimator 2's extents |Δx| ≤ r. |Δx| grows along a side, so the first
// point past each band edge decides (out_of_band); the points the walk
// reads past its stop do not count. It shows how often the TPU kernel's
// band assumption fails on these data; that kernel repairs a point
// whenever an edge gap is ≤ r + 1e-6, so it repairs at least these.
// Selection ties need nothing special: KSmallest keeps the multiset.

#include <cuda_runtime.h>

#include "ksg_common.cuh"

namespace {

using namespace correrender;

// The points a side of the walk reads per round.
constexpr int kWalkWidth = 8;

// One round of a side: j, j + step, ..., kWalkWidth points, pushed (a
// distance past top[0] is a no-op, one past either end +inf); false
// once the side is done. j moves on by kWalkWidth·step.
template <int KMAX>
__device__ __forceinline__ bool walk_step(const float* xs, const float* ys,
                                          int n, float xi, float yi,
                                          int kp1, int step, int* j,
                                          KSmallest<KMAX>* best) {
  float d[kWalkWidth], dx_last = INFINITY;
#pragma unroll
  for (int u = 0; u < kWalkWidth; ++u) {
    const int jj = *j + u * step;
    const bool in = jj >= 0 && jj < n;
    const float dx = in ? fabsf(__fsub_rn(xs[jj], xi)) : INFINITY;
    d[u] = in ? fmaxf(dx, fabsf(__fsub_rn(ys[jj], yi))) : INFINITY;
    dx_last = dx;
  }
#pragma unroll
  for (int u = 0; u < kWalkWidth; ++u) best->push(d[u], kp1);
  *j += kWalkWidth * step;
  return dx_last < best->top[0];
}

// Point i's k-th distance by the pruned walk, a round down and a round
// up at a time, each side until it is done; *lo and *hi are left at the
// first points not visited.
template <int KMAX>
__device__ __forceinline__ float walk_kth(const float* xs, const float* ys,
                                          int n, int i, float xi, float yi,
                                          int kp1, int* lo_out,
                                          int* hi_out) {
  KSmallest<KMAX> best;
  best.reset();
  best.push(chebyshev(xi, yi, xs[i], ys[i]), kp1);
  int lo = i - 1, hi = i + 1;
  bool down = true, up = true;
  while (down || up) {
    if (down) down = walk_step(xs, ys, n, xi, yi, kp1, -1, &lo, &best);
    if (up) up = walk_step(xs, ys, n, xi, yi, kp1, 1, &hi, &best);
  }
  *lo_out = max(lo, -1);
  *hi_out = min(hi, n);
  return best.top[0];
}

// Whether point i's answer needs a point outside its rank band of
// half width `half_band` (see `repaired` above).
__device__ __forceinline__ bool out_of_band(const float* xs, int n, int i,
                                            float xi, float r,
                                            int half_band, int estimator) {
  const float gap = fminf(x_gap(xs, n, i - half_band - 1, xi),
                          x_gap(xs, n, i + half_band, xi));
  return estimator == 2 ? gap <= r : gap < r;
}

template <int KMAX, int LANES>
__global__ void ksg_banded_kernel(const float* __restrict__ series,
                                  const int* __restrict__ perm,
                                  const float* __restrict__ xs_sorted,
                                  const float* __restrict__ y_noise,
                                  float* __restrict__ psi_sum,
                                  int* __restrict__ counts,
                                  int* __restrict__ repaired, long long v,
                                  int n, int npow2, int half_band, int kp1,
                                  int estimator) {
  constexpr int kGroups = 32 / LANES;  // voxels per warp
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int group = lane / LANES, sub = lane % LANES;
  float* xs = smem;
  float* psi = xs + n;  // ψ(m) at m = 1..n
  // This voxel's y in x order, then ascending (first in its own order).
  float* ys = psi + n + 1 + (warp * kGroups + group) * (n + npow2);
  float* ysorted = ys + n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = xs_sorted[j];
  fill_psi_table(psi, n);
  const long long first =
      (static_cast<long long>(blockIdx.x) * warps + warp) * kGroups;
  const long long voxel = first + group;
  const bool live = voxel < v;
  int nan_seen = 0;
  for (int j = sub; j < npow2; j += LANES) {
    float yj = INFINITY;
    if (live && j < n) {
      yj = __ldcs(series + voxel * n + j);
      nan_seen |= isnan(yj);
      if (y_noise) yj = __fadd_rn(yj, __ldg(y_noise + j));
    }
    ysorted[j] = yj;
  }
  __syncthreads();
  if (first >= v) return;  // the whole warp
  for (int j = sub; j < n; j += LANES) ys[j] = ysorted[__ldg(perm + j)];
  __syncwarp();
  const unsigned group_mask = (kFullMask >> (32 - LANES)) << (group * LANES);
  const bool nan = (__ballot_sync(kFullMask, nan_seen) & group_mask) != 0;
  sort_y<LANES>(ysorted, npow2, sub);
  double acc = 0.0;  // the ψ sum in double, as B9's (ksg.cu)
  int left = 0;
  if (live && !nan) {
    for (int i = sub; i < n; i += LANES) {
      const float xi = xs[i], yi = ys[i];
      int lo, hi;
      const float r = walk_kth<KMAX>(xs, ys, n, i, xi, yi, kp1, &lo, &hi);
      float ex = 0.0f, ey = 0.0f;
      if (estimator == 2) {
        walk_extents(xs, ys, n, xi, yi, r, lo, hi, &ex, &ey);
      }
      if (repaired) {
        left += out_of_band(xs, n, i, xi, r, half_band, estimator);
      }
      float rx, ry;
      count_radii(estimator, r, ex, ey, &rx, &ry);
      int cx, cy;
      marginal_counts(xs, ysorted, n, npow2, xi, yi, rx, ry, &cx, &cy);
      if (counts) {
        const int p = __ldg(perm + i);  // back to the series' own order
        counts[(voxel * n + p) * 2] = cx;
        counts[(voxel * n + p) * 2 + 1] = cy;
      }
      acc += psi_terms(psi, estimator, cx, cy);
    }
  }
  acc = group_sum<LANES>(acc);
  left = group_sum<LANES>(left);
  if (live && sub == 0) {
    psi_sum[voxel] = nan ? NAN : static_cast<float>(acc);
    if (repaired) repaired[voxel] = left;
  }
}

struct Args {
  const float* series;
  const int* perm;
  const float* xs_sorted;
  const float* y_noise;
  float* psi_sum;
  int* counts;
  int* repaired;
  long long v;
  int n, half_band, kp1, estimator;
  cudaStream_t stream;
};

template <int KMAX, int LANES>
cudaError_t launch(const Args& a) {
  constexpr int kGroups = 32 / LANES;
  int npow2 = 32;
  while (npow2 < a.n) npow2 <<= 1;
  int warps;
  size_t smem;
  if (!launch_shape((2 * a.n + 1) * sizeof(float),
                    kGroups * (a.n + npow2) * sizeof(float), &warps,
                    &smem)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_shared(ksg_banded_kernel<KMAX, LANES>, smem);
  if (err != cudaSuccess) return err;
  const long long per_block = static_cast<long long>(warps) * kGroups;
  const long long blocks = (a.v + per_block - 1) / per_block;
  ksg_banded_kernel<KMAX, LANES>
      <<<static_cast<unsigned>(blocks), warps * 32, smem, a.stream>>>(
          a.series, a.perm, a.xs_sorted, a.y_noise, a.psi_sum, a.counts,
          a.repaired, a.v, a.n, npow2, a.half_band, a.kp1, a.estimator);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t launch_lanes(const Args& a) {
  if (a.n <= kNarrowMaxMembers) return launch<KMAX, 8>(a);
  return launch<KMAX, 32>(a);
}

}  // namespace

extern "C" int correrender_mi_ksg_banded(
    const void* series, const void* perm, const void* xs_sorted,
    const void* y_noise, void* psi_sum, void* counts, void* repaired,
    long long v, int n, int w_band, int k, int estimator, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{static_cast<const float*>(series),
               static_cast<const int*>(perm),
               static_cast<const float*>(xs_sorted),
               static_cast<const float*>(y_noise),
               static_cast<float*>(psi_sum),
               static_cast<int*>(counts),
               static_cast<int*>(repaired),
               v,
               n,
               w_band / 2,
               k + 1,
               estimator,
               static_cast<cudaStream_t>(stream)};
  if (a.kp1 <= 4) return launch_lanes<4>(a);
  if (a.kp1 <= 8) return launch_lanes<8>(a);
  if (a.kp1 <= kMaxNeighbours) return launch_lanes<kMaxNeighbours>(a);
  return cudaErrorInvalidValue;
}
