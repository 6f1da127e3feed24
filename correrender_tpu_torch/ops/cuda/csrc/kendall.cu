// B8: Kendall tau-b pair counts by Knight's merge count.
//
// Replaces correrender_tpu/ops/pallas/kendall_kernel.py::kendall_pallas
// (_kendall_flat). The kernel writes, per voxel, the counts over all
// ordered pairs (i, j) of its members that the TPU kernel sums,
//
//     num = Σ sign(x_i − x_j)·sign(y_i − y_j),
//     ty  = #{y_i == y_j},  txy = #{x_i == x_j and y_i == y_j}
//
// (the diagonal included in the ties), and a NaN flag. The wrapper
// assembles tau in the JAX package's float32 order
// (ops/kendall.py::tau_from_counts), with the joint ties n3 subtracted
// from the numerator (Correlation.cpp:444). The counts are exact up to
// n = 46340, so there is no f32 limit on n (the JAX route stops at
// n = 4000, correlation.py:237-242).
//
// Bound on the H100: the TPU kernel's pairwise sweep is n² compares per
// voxel against n reads (139 ms at 250³ × 100 against a 1.9 ms read of
// the stack). Knight's method (the reference's own,
// Correlation.cpp:305-465) needs about n·log²n / 2 compare steps per
// voxel in this merge, so the kernel is still bound by its compares and
// shared-memory reads, not by the read of the stack (34 ms at 250³ ×
// 100 on the H100, PERF.md).
//
// Design: the reference x is shared by every voxel, so the host orders
// it once (a stable sort: `perm`) and gives each sorted position the
// first position of its x-tie group (`gstart`); no voxel does x work.
// Per voxel, two buffers of n floats in shared memory:
//
//   1. y is read coalesced and gathered into x order through perm;
//   2. where x has ties, a merge sort by (x group, y) orders y within
//      each group, and n3 is read off its runs;
//   3. a merge sort by y counts its exchanges S: for each element of a
//      right run, the elements of the left run that are strictly
//      greater (its placing binary search gives that count);
//   4. n2 is read off the runs of the sorted y; n1 off gstart.
//
// Then Σ_{i<j} sign·sign = n0 − n1 − n2 + n3 − 2S with n0 = n(n−1)/2,
// written doubled, as the ordered-pair counts above. Each merge level
// places every element by one binary search in the partner run; left
// and right elements search alike (the tie rule is a value, not a
// branch), so a warp never runs the two searches one after the other.
// Floats are compared as floats (−0 == +0, as the pair sweep's signs
// have it). A voxel with a NaN member is flagged; its sorts run on (they
// only move values within their runs) and its counts are not read.
//
// Lanes: LANES lanes take one voxel, 32 / LANES voxels a warp, lane
// `sub` taking elements sub, sub + LANES, ...: 8 lanes up to
// kNarrowMaxMembers members, so that a small n does not leave most of a
// warp idle in the last pass of every merge level, else 32.
// One warp fits n up to 12288 (_build.MAX_MEMBERS) in 12·n bytes of
// shared memory.

#include <cuda_runtime.h>

#include "ksg_common.cuh"

namespace {

using namespace correrender;

// #{j ∈ [lo, hi) : (g_j, a_j) < (g, key)}, or ≤ with `or_equal`, for a
// run ascending in (g, a); without SEG the group is ignored. The flag
// is a value, not a branch, so the lanes of a warp that search a left
// run and those that search a right run take the same path.
template <bool SEG>
__device__ __forceinline__ int run_rank(const float* a, const int* gstart,
                                        int lo, int hi, float key, int g,
                                        bool or_equal) {
  const int base = lo;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float am = a[mid];
    bool before = am < key || (or_equal && am == key);
    if (SEG) {
      const int gm = gstart[mid];
      before = gm < g || (gm == g && before);
    }
    if (before) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - base;
}

// One stable merge level: runs [s, s + w) and [s + w, s + 2w) of `in`
// into `out`. An element of a left run goes before the equal elements
// of its right run. Returns this lane's exchanges: for each element of
// a right run, the left-run elements strictly greater.
template <bool SEG, int LANES>
__device__ long long merge_level(const float* in, float* out,
                                 const int* gstart, int n, int w,
                                 int sub) {
  long long exchanges = 0;
  for (int q = sub; q < n; q += LANES) {
    const int s = q & ~(2 * w - 1);
    const int mid = min(s + w, n), e = min(s + 2 * w, n);
    const float key = in[q];
    const int g = SEG ? gstart[q] : 0;
    const bool left = q < mid;
    const int before = run_rank<SEG>(in, gstart, left ? mid : s,
                                     left ? e : mid, key, g, !left);
    out[q - (left ? 0 : mid - s) + before] = key;
    if (!left) exchanges += (mid - s) - before;
  }
  __syncwarp();
  return exchanges;
}

// Merge sort of *buf[0, n) by (group, value) or by value, ping-ponging
// with *tmp: *buf holds the result after. Returns this lane's
// exchanges.
template <bool SEG, int LANES>
__device__ long long merge_sort(float** buf, float** tmp, const int* gstart,
                                int n, int sub) {
  long long exchanges = 0;
  for (int w = 1; w < n; w <<= 1) {
    exchanges += merge_level<SEG, LANES>(*buf, *tmp, gstart, n, w, sub);
    float* t = *buf;
    *buf = *tmp;
    *tmp = t;
  }
  return exchanges;
}

// This lane's share of Σ_q (q − first index of q's run of equal values)
// over a[0, n), ascending within each [lo(q), q] (lo = 0, or q's x
// group): the tied pairs.
template <int LANES>
__device__ long long tied_pairs(const float* a, const int* gstart, int n,
                                int sub) {
  long long pairs = 0;
  for (int q = sub; q < n; q += LANES) {
    const int lo = gstart ? gstart[q] : 0;
    pairs += (q - lo) - run_rank<false>(a, nullptr, lo, q, a[q], 0, false);
  }
  return pairs;
}

template <int LANES>
__global__ void kendall_kernel(const float* __restrict__ series,
                               const int* __restrict__ perm,
                               const int* __restrict__ gstart_g,
                               int* __restrict__ counts, long long v,
                               int n) {
  constexpr int kGroups = 32 / LANES;
  extern __shared__ int smem_i[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int group = lane / LANES, sub = lane % LANES;
  int* gstart = smem_i;
  float* buf = reinterpret_cast<float*>(smem_i + n) +
               (warp * kGroups + group) * 2 * n;
  float* tmp = buf + n;
  int x_ties = 0;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int g = gstart_g[j];
    gstart[j] = g;
    x_ties |= g != j;
  }
  const long long first =
      (static_cast<long long>(blockIdx.x) * warps + warp) * kGroups;
  const long long voxel = first + group;
  const bool live = voxel < v;
  int nan_seen = 0;
  for (int j = sub; j < n; j += LANES) {
    const float yj = live ? __ldcs(series + voxel * n + j) : 0.0f;
    nan_seen |= isnan(yj);
    tmp[j] = yj;
  }
  x_ties = __syncthreads_or(x_ties);
  if (first >= v) return;
  const unsigned group_mask = (kFullMask >> (32 - LANES)) << (group * LANES);
  const bool nan = (__ballot_sync(kFullMask, nan_seen) & group_mask) != 0;
  for (int j = sub; j < n; j += LANES) buf[j] = tmp[__ldg(perm + j)];
  __syncwarp();
  long long n1 = 0, n3 = 0;
  if (x_ties) {
    merge_sort<true, LANES>(&buf, &tmp, gstart, n, sub);
    n3 = tied_pairs<LANES>(buf, gstart, n, sub);
    for (int q = sub; q < n; q += LANES) n1 += q - gstart[q];
  }
  long long s = merge_sort<false, LANES>(&buf, &tmp, nullptr, n, sub);
  long long n2 = tied_pairs<LANES>(buf, nullptr, n, sub);
  s = group_sum<LANES>(s);
  n1 = group_sum<LANES>(n1);
  n2 = group_sum<LANES>(n2);
  n3 = group_sum<LANES>(n3);
  if (live && sub == 0) {
    int* out = counts + voxel * 4;
    const long long n0 = static_cast<long long>(n) * (n - 1) / 2;
    out[0] = nan ? 0 : static_cast<int>(2 * (n0 - n1 - n2 + n3 - 2 * s));
    out[1] = nan ? n : static_cast<int>(2 * n2 + n);
    out[2] = nan ? n : static_cast<int>(2 * n3 + n);
    out[3] = nan;
  }
}

template <int LANES>
cudaError_t launch(const void* series, const void* perm, const void* gstart,
                   void* counts, long long v, int n, cudaStream_t stream) {
  constexpr int kGroups = 32 / LANES;
  int warps;
  size_t smem;
  if (!launch_shape(n * sizeof(int), kGroups * 2 * n * sizeof(float), &warps,
                    &smem)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_shared(kendall_kernel<LANES>, smem);
  if (err != cudaSuccess) return err;
  const long long per_block = static_cast<long long>(warps) * kGroups;
  const long long blocks = (v + per_block - 1) / per_block;
  kendall_kernel<LANES><<<static_cast<unsigned>(blocks), warps * 32, smem,
                          stream>>>(
      static_cast<const float*>(series), static_cast<const int*>(perm),
      static_cast<const int*>(gstart), static_cast<int*>(counts), v, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int correrender_kendall(const void* series, const void* perm,
                                   const void* gstart, void* counts,
                                   long long v, int n, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  if (n <= kNarrowMaxMembers) {
    return launch<8>(series, perm, gstart, counts, v, n, st);
  }
  return launch<32>(series, perm, gstart, counts, v, n, st);
}
