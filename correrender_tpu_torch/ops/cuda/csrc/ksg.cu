// B9: KSG mutual information over the full pairwise Chebyshev rows,
// estimators 1 and 2.
//
// Replaces correrender_tpu/ops/pallas/ksg_kernel.py::mi_ksg_pallas
// (_mi_ksg_flat). Semantics: ops/mi_ksg.py (reference
// MutualInformation.cpp:399-509): the (k+1)-th smallest Chebyshev
// distance of each point over its whole row, self and ties included;
// estimator 2's tie-inclusive extents; per-axis counts over the
// half-open [v − r, v + r); ψ sums; NaN for a voxel that holds a NaN.
// The constant ψ(k) + ψ(n) (− 1/k) and the clamp at 0 are applied by
// the wrapper. B10 (ksg_banded.cu) computes the same function point for
// point by a pruned walk; B9 scans every row in full, so its cost does
// not depend on the data.
//
// Bound on the H100: f32 operations, those of the full-row k-th-distance
// pass: about five a pair (Δy, |Δx|, |Δy|, their max, one compare), n²
// pairs a voxel, plus the y sort (n·log2 n compare-exchanges) and four
// binary searches a point (4·log2 n steps). At n = 1000 that is some 10⁴
// operations per byte of the series, far past the H100's 20. None of
// them is an FMA, while the f32 peak chip_smoke.py states (67·10¹²
// operations/s) counts an FMA as two: one instruction a lane a cycle
// issues at most half of it, so this pass's ceiling is about half of
// that bound.
//
// Design, for the issue rate:
// - Counts by binary search, not by a second pass over the row. The
//   wrapper sorts the noised reference once (perm, xs); each warp keeps
//   its voxel's noised y in x order and a copy that its lanes sort
//   (bitonic), and a point's four bounds are searched without branches,
//   its ψ read from the block's ψ(1..n) table (ksg_common.cuh, shared
//   with B10). The counts are the scan's exactly, since comparisons
//   against a sorted array are monotone: n² steps a voxel become
//   n·log2 n.
// - The k-th-distance pass reads each shared (x_j, y_j) once for ROWS
//   rows of a lane, each row with its own KSmallest list in registers:
//   a pair costs two FADDs, one FMNMX with |·| modifiers and one FSETP
//   that ORs into a predicate, while the two loads and the index step
//   are shared by ROWS pairs. Each k + 1 from 2 to 16 has its own
//   instance, so a list holds exactly k + 1 values and an insert is
//   2·k + 1 min/max operations; ROWS is 8 up to k = 3, 4 up to 7, else 2
//   (the lists take at most 32 registers).
// - A lane's rows are ROWS consecutive points in x order (lanes ROWS
//   apart, 32·ROWS rows a warp at a time), and the lane scans outward
//   from their middle, a point up and a point down a step (indices mod
//   n, every j once). Its rows' nearest candidates come first, close
//   together (|Δx| grows with the rank gap), so pushes die out early in
//   the scan for all rows of a lane at once. The shared arrays of the x order are stored
//   swizzled (ksg_common.cuh::swizzled<ROWS>), so the 32 lanes' reads,
//   ROWS points apart, land on 32 banks.
// - The pushes are guarded by one warp vote a step (__any_sync over the
//   step's 2·ROWS compares): a step whose compares all fail costs no
//   list operation, and a step that passes runs the insert network on
//   all 2·ROWS distances without a check or a branch each (a distance
//   ≥ top[0] leaves a list as it is). A push equal to top[0] changes
//   nothing, so the lists hold the multiset's k+1 smallest whatever the
//   order. The vote passes in every step in which some row of the warp
//   meets a nearer point; PERF.md has the pass with and without its
//   pushes, and the layouts against each other (ablate_ksg.py).
// - Estimator 2's extents read only the rank window where the rounded
//   |Δx| ≤ r: outside it |Δx| > r, so no neighbour lies there and the
//   extents are the full row's exactly. A lane's rows are consecutive,
//   so their windows overlap: one walk out from the rows reads each
//   candidate once for all of them (Rows::extents), where a walk a row
//   would read the shared part once a row and leave lanes idle while
//   the longest window of the warp is walked.
// The noised values and the count boundaries are rounded with
// __fadd_rn/__fsub_rn as the plain version rounds them: an FMA there
// would move a count, and ψ by a whole step. The ψ sum of a voxel
// accumulates in double: n float terms summed in a lane's order drift
// by about 1e-5 of ψ/n from the plain version's sum at n = 12288.

#include <cuda_runtime.h>

#include "ksg_common.cuh"

namespace {

using namespace correrender;

constexpr int kWarp = 32;

// The length of a shared array of the x order: n rounded up to a
// multiple of 8, the widest swizzle.
__host__ __device__ __forceinline__ int padded(int n) { return (n + 7) & ~7; }

// r[t] for a t known only at run time, without a local-memory array.
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int t) {
  float v = a[0];
#pragma unroll
  for (int u = 1; u < N; ++u) v = u == t ? a[u] : v;
  return v;
}

// A lane's rows: ROWS points in x order, STEP apart (first, first +
// STEP, ...), read from the shared arrays of the x order, which are
// stored swizzled<SW>. A row past n reads (+inf, +inf).
template <int KP1, int ROWS, int STEP, int SW>
struct Rows {
  int first;
  float x[ROWS], y[ROWS];

  __device__ __forceinline__ Rows(const float* xs, const float* ys, int n,
                                  int first_)
      : first(first_) {
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      const int i = first + STEP * t;
      x[t] = i < n ? xs[swizzled<SW>(i)] : INFINITY;
      y[t] = i < n ? ys[swizzled<SW>(i)] : INFINITY;
    }
  }

  // Candidate j against the rows: d[t] its Chebyshev distance to row t;
  // true when it beats some row's current top[0].
  __device__ __forceinline__ bool distances(
      const float* xs, const float* ys, int j,
      const KSmallest<KP1> (&best)[ROWS], float (&d)[ROWS]) const {
    const float xj = xs[swizzled<SW>(j)], yj = ys[swizzled<SW>(j)];
    bool beats = false;
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      d[t] = chebyshev(x[t], y[t], xj, yj);
      beats |= d[t] < best[t].top[0];
    }
    return beats;
  }

  // The (k+1)-th smallest Chebyshev distance r[t] of each row over the
  // whole row j = 0..n−1, self and ties included (a row past n: +inf).
  // The list length KP1 = k + 1 is a compile-time constant, so an insert
  // is 2·k + 1 min/max operations without a check per slot.
  __device__ __forceinline__ void kth(const float* xs, const float* ys,
                                      int n, float (&r)[ROWS]) const {
    KSmallest<KP1> best[ROWS];
#pragma unroll
    for (int t = 0; t < ROWS; ++t) best[t].reset();
    int up = min(first + STEP * (ROWS - 1) / 2, n - 1);
    int down = up == 0 ? n - 1 : up - 1;
    float du[ROWS], dd[ROWS];
    for (int m = n >> 1; m > 0; --m) {
      const bool beats = distances(xs, ys, up, best, du) |
                         distances(xs, ys, down, best, dd);
      up = up + 1 == n ? 0 : up + 1;
      down = down == 0 ? n - 1 : down - 1;
      if (__any_sync(kFullMask, beats)) {
#pragma unroll
        for (int t = 0; t < ROWS; ++t) {
          best[t].insert(du[t], KP1);
          best[t].insert(dd[t], KP1);
        }
      }
    }
    if (n & 1) {  // the last point, up
      distances(xs, ys, up, best, du);
#pragma unroll
      for (int t = 0; t < ROWS; ++t) best[t].insert(du[t], KP1);
    }
#pragma unroll
    for (int t = 0; t < ROWS; ++t) r[t] = best[t].top[0];
  }

  // Candidate j into the extents of the rows whose neighbour set it
  // joins (dch ≤ r[t]); true while its |Δx| ≤ r[t] for some row.
  __device__ __forceinline__ bool extend(const float* xs, const float* ys,
                                         int j, const float (&r)[ROWS],
                                         float (&ex)[ROWS],
                                         float (&ey)[ROWS]) const {
    const float xj = xs[swizzled<SW>(j)], yj = ys[swizzled<SW>(j)];
    bool near = false;
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      const float dx = fabsf(__fsub_rn(xj, x[t]));
      const float dy = fabsf(__fsub_rn(yj, y[t]));
      if (fmaxf(dx, dy) <= r[t]) {
        ex[t] = fmaxf(ex[t], dx);
        ey[t] = fmaxf(ey[t], dy);
      }
      near |= dx <= r[t];
    }
    return near;
  }

  // Estimator 2's extents (max |dx|, |dy| over {j : dch_j ≤ r[t]}, ties
  // included) of every row at once. Row t's neighbours lie in the rank
  // window where its rounded |Δx| ≤ r[t], which holds t, and the rounded
  // |Δx| never decreases along a side: so the span of the rows once, then
  // a walk down and a walk up, each until its |Δx| passes every row's
  // r, read each candidate once for all the rows and miss no neighbour.
  __device__ __forceinline__ void extents(const float* xs, const float* ys,
                                          int n, const float (&r)[ROWS],
                                          float (&ex)[ROWS],
                                          float (&ey)[ROWS]) const {
    float rr[ROWS];  // a row past n takes no candidate
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      rr[t] = first + STEP * t < n ? r[t] : -1.0f;
      ex[t] = ey[t] = -1.0f;
    }
    const int lo = min(first, n), hi = min(first + STEP * (ROWS - 1) + 1, n);
    for (int j = lo; j < hi; ++j) extend(xs, ys, j, rr, ex, ey);
    for (int j = lo - 1; j >= 0 && extend(xs, ys, j, rr, ex, ey); --j) {
    }
    for (int j = hi; j < n && extend(xs, ys, j, rr, ex, ey); ++j) {
    }
  }
};

template <int KP1>
__global__ void ksg_kernel(const float* __restrict__ series,
                           const int* __restrict__ perm,
                           const float* __restrict__ xs_sorted,
                           const float* __restrict__ y_noise,
                           float* __restrict__ psi_sum,
                           int* __restrict__ counts, long long v, int n,
                           int npow2, int estimator) {
  constexpr int kRows = KP1 <= 4 ? 8 : KP1 <= 8 ? 4 : 2;
  // A lane's rows are kRows consecutive points, lanes kRows apart.
  constexpr int kRowStep = 1, kLaneStep = kRows, kSwizzle = kRows;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int nx = padded(n);
  float* xs = smem;      // the sorted reference, swizzled
  float* psi = xs + nx;  // ψ(m) at m = 1..n
  // This voxel's noised y in x order (swizzled), then ascending (first
  // in its own order).
  float* ys = psi + n + 1 + warp * (nx + npow2);
  float* ysorted = ys + nx;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    xs[swizzled<kSwizzle>(j)] = xs_sorted[j];
  }
  fill_psi_table(psi, n);
  const long long voxel = static_cast<long long>(blockIdx.x) * warps + warp;
  const bool live = voxel < v;
  int nan_seen = 0;
  for (int j = lane; j < npow2; j += kWarp) {
    float yj = INFINITY;
    if (live && j < n) {
      yj = __ldcs(series + voxel * n + j);
      nan_seen |= isnan(yj);
      if (y_noise) yj = __fadd_rn(yj, __ldg(y_noise + j));
    }
    ysorted[j] = yj;
  }
  __syncthreads();
  if (!live) return;  // the whole warp
  if (__any_sync(kFullMask, nan_seen)) {
    if (lane == 0) psi_sum[voxel] = NAN;
    return;
  }
  for (int j = lane; j < n; j += kWarp) {
    ys[swizzled<kSwizzle>(j)] = ysorted[__ldg(perm + j)];
  }
  __syncwarp();
  sort_y<kWarp>(ysorted, npow2, lane);
  double acc = 0.0;
  for (int base = 0; base < n; base += kWarp * kRows) {
    const Rows<KP1, kRows, kRowStep, kSwizzle> rows(xs, ys, n,
                                                    base + kLaneStep * lane);
    float r[kRows], ex[kRows] = {}, ey[kRows] = {};
    rows.kth(xs, ys, n, r);
    if (estimator == 2) rows.extents(xs, ys, n, r, ex, ey);
#pragma unroll 1
    for (int t = 0; t < kRows; ++t) {
      const int i = rows.first + kRowStep * t;
      if (i >= n) break;
      const float xi = xs[swizzled<kSwizzle>(i)];
      const float yi = ys[swizzled<kSwizzle>(i)];
      float rx, ry;
      count_radii(estimator, pick(r, t), pick(ex, t), pick(ey, t), &rx,
                  &ry);
      int cx, cy;
      marginal_counts<kSwizzle>(xs, ysorted, n, npow2, xi, yi, rx, ry, &cx,
                                &cy);
      if (counts) {
        const int p = __ldg(perm + i);  // back to the series' own order
        counts[(voxel * n + p) * 2] = cx;
        counts[(voxel * n + p) * 2 + 1] = cy;
      }
      acc += psi_terms(psi, estimator, cx, cy);
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) psi_sum[voxel] = static_cast<float>(acc);
}

struct Args {
  const float* series;
  const int* perm;
  const float* xs_sorted;
  const float* y_noise;
  float* psi_sum;
  int* counts;
  long long v;
  int n, estimator;
  cudaStream_t stream;
};

template <int KP1>
cudaError_t launch(const Args& a) {
  int npow2 = kWarp;
  while (npow2 < a.n) npow2 <<= 1;
  int warps;
  size_t smem;
  const int nx = padded(a.n);
  if (!launch_shape((nx + a.n + 1) * sizeof(float),
                    (nx + npow2) * sizeof(float), &warps, &smem)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_shared(ksg_kernel<KP1>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (a.v + warps - 1) / warps;
  ksg_kernel<KP1><<<static_cast<unsigned>(blocks), warps * kWarp, smem,
                    a.stream>>>(a.series, a.perm, a.xs_sorted, a.y_noise,
                                a.psi_sum, a.counts, a.v, a.n, npow2,
                                a.estimator);
  return cudaGetLastError();
}

// The instance of k + 1 = kp1, from 2 to kMaxNeighbours.
template <int KP1 = 2>
cudaError_t launch_kp1(const Args& a, int kp1) {
  if (kp1 == KP1) return launch<KP1>(a);
  if constexpr (KP1 < kMaxNeighbours) return launch_kp1<KP1 + 1>(a, kp1);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int correrender_mi_ksg(const void* series, const void* perm,
                                  const void* xs_sorted, const void* y_noise,
                                  void* psi_sum, void* counts, long long v,
                                  int n, int k, int estimator, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{static_cast<const float*>(series),
               static_cast<const int*>(perm),
               static_cast<const float*>(xs_sorted),
               static_cast<const float*>(y_noise),
               static_cast<float*>(psi_sum),
               static_cast<int*>(counts),
               v,
               n,
               estimator,
               static_cast<cudaStream_t>(stream)};
  return launch_kp1(a, k + 1);
}
