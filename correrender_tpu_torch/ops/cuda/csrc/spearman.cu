// B7: Spearman rho by a per-voxel sort, with exact integer moments.
//
// Replaces correrender_tpu/ops/pallas/spearman_kernel.py::spearman_pallas
// (_spearman_flat). The TPU kernel counts each member's rank pairwise
// (n² compares, since Mosaic has no sort); here each voxel's series is
// sorted and the tie-averaged ranks are read off the sorted runs:
//
//     2·rank = first + last + 2   (0-based first and last of the run),
//
// an integer, the same as the TPU kernel's 2·#{y_j < y_i} +
// #{y_j == y_i} + 1. The kernel sums (2r)² and (2r)(2r_x) in integers
// (the doubled reference ranks 2r_x come from the host) and writes
// Σ2r = n(n + 1), which holds for any series (the ranks of n members
// average to (n + 1)/2, ties or not). The moments are exact; the wrapper
// assembles rho in float64. (In f32, as JAX sums them, Σr² ≈ n³/3
// passes 2²⁴ at n ≈ 370.)
//
// Sort keys: one 32-bit word a member, the value's bits in an unsigned
// total order. −0 is first made +0 (v + 0), so equal floats have equal
// keys; a NaN member j gets 0xFF800001 + j, after +inf (0xFF800000) and
// in index order, so each NaN is a run of its own, as in the XLA path
// that correlate_field runs on the CPU (argsort puts NaN last). Padding
// keys are 0xFFFFFFFE, above every member's; 0xFFFFFFFF marks the end of
// a merge run. The payload is the member's 2r_x, not its index: inside
// a tie run every member gets the same 2r, so the order within a run
// cannot change Σ(2r)(2r_x), and the sort need not be stable. The runs
// are read from the sorted keys alone.
//
// Bound on the H100: the sort's compares (n log n per voxel at least)
// against n reads; at n = 100 the stack's bytes.
//
// Design, up to 1024 members (the register path): LANES lanes a voxel,
// 8 up to kNarrowMaxMembers members (4 voxels a warp, adjacent rows, so
// the warp's loads stay coalesced), else 32. A lane holds E = pow2(n) /
// LANES (key, payload) pairs in registers and sorts them there
// (Batcher's odd-even merge sort, compile-time indices). The group merges
// its runs pairwise, E, 2E, ... wide, through a buffer of its own in
// shared memory: each lane writes its run, finds where its E outputs
// start by merge path (one binary search on its diagonal) and merges
// them serially into its registers, so after log2(LANES) levels lane l
// holds positions l·E to l·E + E − 1 in order. A bitonic network across
// the lanes' registers (__shfl_xor_sync stages, no shared memory) was
// the first design; its sort compiled to about 4 times as many
// instructions and the kernel took nearly twice as long at 250³ × 100 on
// the H100 (PERF.md); it stays as a probe. The run bounds come from a
// segmented max-scan (first) and min-scan (last) inside the lane over
// its E keys, then across the lane group by shuffles. The products
// (2r)(2r_x) ≤ 4n² are summed in int32 inside a lane (E·4n² < 2³¹ for
// n ≤ 1024) and in int64 across lanes.
//
// Above 1024 members (the shared path): one warp a voxel, the keys and
// payloads in shared memory, a bitonic network there (up to n = 12288,
// _build.MAX_MEMBERS).
//
// correrender_spearman_probe launches variants of the register path for
// ops/cuda/ablate_spearman.py only: other lane widths, the bitonic
// network across lanes, and timing probes that compute wrong answers on
// purpose (no sort; no tie scan).

#include <cuda_runtime.h>

#include <climits>

#include "ksg_common.cuh"

namespace {

using namespace correrender;

constexpr int kRegisterMaxMembers = 1024;
constexpr int kBlockThreads = 512;  // 64 voxels a block at 8 lanes
constexpr unsigned kPadKey = 0xfffffffeu;  // after every member's key
constexpr unsigned kRunEnd = 0xffffffffu;  // after a merge run, above padding
constexpr unsigned kNanKey = 0xff800001u;  // + member index

// Variants of the register path (ablate_spearman.py): the shipped order
// by merge path, timing probes without the sort or without the tie scan,
// and the order by a bitonic network across the lanes' registers.
constexpr int kShipped = 0, kNoSort = 1, kNoTieScan = 2, kBitonic = 3;

template <int PROBE>
__host__ __device__ constexpr bool merges() {
  return PROBE == kShipped || PROBE == kNoTieScan;
}

// The member's value in an unsigned total order: −0 as +0, NaN after
// +inf in index order.
__device__ __forceinline__ unsigned sort_key(float v, int idx) {
  const float c = __fadd_rn(v, 0.0f);  // −0 + 0 = +0
  const unsigned u = __float_as_uint(c);
  // Negative: all bits flipped; otherwise the sign bit set.
  const unsigned key =
      u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) | 0x80000000u);
  return isnan(c) ? kNanKey + static_cast<unsigned>(idx) : key;
}

// One compare-exchange inside a lane (the lane's sort, the bitonic
// network's strides below E): ascending unless `desc`.
__device__ __forceinline__ void exchange(unsigned& ka, int& xa, unsigned& kb,
                                         int& xb, bool desc) {
  const bool swap = desc ? (ka < kb) : (ka > kb);
  const unsigned k = ka;
  const int x = xa;
  ka = swap ? kb : ka;
  xa = swap ? xb : xa;
  kb = swap ? k : kb;
  xb = swap ? x : xb;
}

// Stage (SIZE, J) of the bitonic network over the LANES·E positions
// p = sub·E + e: pairs (p, p ^ J), ascending where p & SIZE is 0.
template <int LANES, int E, int SIZE, int J>
__device__ __forceinline__ void bitonic_stage(unsigned (&k)[E], int (&x)[E],
                                              int sub) {
  if constexpr (J >= E) {
    // Across lanes: the partner is lane sub ^ (J / E), slot e.
    constexpr int kLaneXor = J / E;
    const bool lower = (sub & kLaneXor) == 0;
    const bool desc = ((sub * E) & SIZE) != 0;
    const bool keep_min = lower != desc;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const unsigned ok = __shfl_xor_sync(kFullMask, k[e], kLaneXor);
      const int ox = __shfl_xor_sync(kFullMask, x[e], kLaneXor);
      const bool take = keep_min ? (ok < k[e]) : (ok > k[e]);
      k[e] = take ? ok : k[e];
      x[e] = take ? ox : x[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((e ^ J) > e) {
        const bool desc = ((sub * E + e) & SIZE) != 0;
        exchange(k[e], x[e], k[e ^ J], x[e ^ J], desc);
      }
    }
  }
}

template <int LANES, int E, int SIZE, int J>
__device__ __forceinline__ void bitonic_merge(unsigned (&k)[E], int (&x)[E],
                                              int sub) {
  if constexpr (J > 0) {
    bitonic_stage<LANES, E, SIZE, J>(k, x, sub);
    bitonic_merge<LANES, E, SIZE, J / 2>(k, x, sub);
  }
}

// Ascending bitonic sort of the group's LANES·E (key, payload) pairs.
template <int LANES, int E, int SIZE = 2>
__device__ __forceinline__ void bitonic_sort(unsigned (&k)[E], int (&x)[E],
                                             int sub) {
  if constexpr (SIZE <= LANES * E) {
    bitonic_merge<LANES, E, SIZE, SIZE / 2>(k, x, sub);
    bitonic_sort<LANES, E, SIZE * 2>(k, x, sub);
  }
}

// Batcher's odd-even merge sort of one lane's E pairs in registers,
// ascending: 63 compare-exchanges at E = 16 and 191 at E = 32, against
// the bitonic network's 80 and 240.
template <int E, int P, int K>
__device__ __forceinline__ void odd_even_pass(unsigned (&k)[E], int (&x)[E]) {
  if constexpr (K >= 1) {
#pragma unroll
    for (int j = K % P; j < E - K; j += 2 * K) {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (i + j + K < E && (i + j) / (2 * P) == (i + j + K) / (2 * P)) {
          exchange(k[i + j], x[i + j], k[i + j + K], x[i + j + K], false);
        }
      }
    }
    odd_even_pass<E, P, K / 2>(k, x);
  }
}

template <int E, int P = 1>
__device__ __forceinline__ void odd_even_sort(unsigned (&k)[E], int (&x)[E]) {
  if constexpr (P < E) {
    odd_even_pass<E, P, P>(k, x);
    odd_even_sort<E, P * 2>(k, x);
  }
}

// Inclusive max-scan over the group's lanes (lane order).
template <int LANES>
__device__ __forceinline__ int group_scan_max(int v, int sub) {
#pragma unroll
  for (int d = 1; d < LANES; d <<= 1) {
    const int o = __shfl_up_sync(kFullMask, v, d, LANES);
    if (sub >= d) v = max(v, o);
  }
  return v;
}

// Inclusive min-scan over the group's lanes, from the last lane down.
template <int LANES>
__device__ __forceinline__ int group_scan_min_rev(int v, int sub) {
#pragma unroll
  for (int d = 1; d < LANES; d <<= 1) {
    const int o = __shfl_down_sync(kFullMask, v, d, LANES);
    if (sub + d < LANES) v = min(v, o);
  }
  return v;
}

// Slots of a group's merge buffer: the LANES·E keys and one run end
// after each of at most LANES runs.
template <int LANES, int E>
__host__ __device__ constexpr int merge_slots() {
  return LANES * E + LANES;
}

// The group's ascending order by merges: each lane sorts its E keys in
// registers, then runs of w = E, 2E, ... are merged pairwise through the
// group's buffer in shared memory, each lane producing the E outputs at
// its positions by merge path (a binary search for its diagonal, then a
// serial merge, A first on equal keys). Each run in the buffer ends in a
// kRunEnd slot, so a side never reads past its run.
template <int LANES, int E>
__device__ __forceinline__ void merge_sort_group(unsigned (&k)[E],
                                                 int (&x)[E], int sub,
                                                 uint2* buf) {
  odd_even_sort<E>(k, x);
  const int base = sub * E;
  for (int w = E; w < LANES * E; w *= 2) {
    uint2* dst = buf + (base / w) * (w + 1) + base % w;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dst[e] = make_uint2(k[e], static_cast<unsigned>(x[e]));
    }
    if ((base + E) % w == 0) dst[E] = make_uint2(kRunEnd, 0u);
    __syncwarp();
    const uint2* a_run = buf + (base / (2 * w)) * 2 * (w + 1);
    const uint2* b_run = a_run + (w + 1);
    const int d = base % (2 * w);
    int lo = max(0, d - w), hi = min(d, w);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a_run[mid].x <= b_run[d - 1 - mid].x) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int i = lo, j = d - lo;
    uint2 a = a_run[i], b = b_run[j];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool take_a = a.x <= b.x;
      k[e] = take_a ? a.x : b.x;
      x[e] = static_cast<int>(take_a ? a.y : b.y);
      i += take_a;
      j += !take_a;
      a = a_run[i];
      b = b_run[j];
    }
    __syncwarp();
  }
}

// The register path: LANES lanes a voxel, E keys a lane.
template <int LANES, int E, int PROBE>
__global__ void __launch_bounds__(kBlockThreads) spearman_regs_kernel(
    const float* __restrict__ series, const int* __restrict__ xrank2,
    long long* __restrict__ sums, long long v, int n) {
  extern __shared__ int xr[];
  for (int j = threadIdx.x; j < n; j += blockDim.x) xr[j] = xrank2[j];
  __syncthreads();
  uint2* merge_buf = reinterpret_cast<uint2*>(xr + ((n + 1) & ~1)) +
                     (threadIdx.x / LANES) * merge_slots<LANES, E>();
  const int sub = threadIdx.x % LANES;
  const int groups = blockDim.x / LANES;
  const long long sum_2r = static_cast<long long>(n) * (n + 1);
  // Every warp of the block runs the same number of rounds (shuffles
  // need the whole warp); a group past the last voxel sorts padding.
  for (long long first = static_cast<long long>(blockIdx.x) * groups;
       first < v; first += static_cast<long long>(gridDim.x) * groups) {
    const long long voxel = first + threadIdx.x / LANES;
    // Member j = e·LANES + sub, which exists while e·LANES < lim: the
    // group's lanes read neighbouring words. Where a member starts does
    // not matter to the sort.
    const int lim = voxel < v ? n - sub : 0;
    const float* y = series + voxel * n + sub;
    unsigned k[E];
    int x[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e * LANES < lim) {
        k[e] = sort_key(__ldcs(y + e * LANES), e * LANES + sub);
        x[e] = xr[e * LANES + sub];
      } else {
        k[e] = kPadKey;
        x[e] = 0;
      }
    }
    if constexpr (merges<PROBE>()) {
      merge_sort_group<LANES, E>(k, x, sub, merge_buf);
    } else if constexpr (PROBE == kBitonic) {
      bitonic_sort<LANES, E>(k, x, sub);
    }

    int s_rr = 0, s_rx = 0;  // (2r)² ≤ 4n², E·4n² < 2³¹
    if (PROBE == kNoTieScan) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int p = sub * E + e;
        const int r2 = 2 * p + 2;
        if (p < n) {
          s_rr += r2 * r2;
          s_rx += r2 * x[e];
        }
      }
    } else {
      // Run starts and ends as bit masks over the lane's E slots.
      const unsigned prev_k = __shfl_up_sync(kFullMask, k[E - 1], 1, LANES);
      const unsigned next_k = __shfl_down_sync(kFullMask, k[0], 1, LANES);
      unsigned starts = 0, ends = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const unsigned before = e > 0 ? k[e - 1] : prev_k;
        const unsigned after = e + 1 < E ? k[e + 1] : next_k;
        const bool start = (e == 0 && sub == 0) || k[e] != before;
        const bool end = (e + 1 == E && sub + 1 == LANES) || k[e] != after;
        starts |= static_cast<unsigned>(start) << e;
        ends |= static_cast<unsigned>(end) << e;
      }
      // The last start at or before the lane's first slot, and the
      // first end at or after its last, from the other lanes.
      const int lane_start = starts ? sub * E + 31 - __clz(starts) : -1;
      const int lane_end = ends ? sub * E + __ffs(ends) - 1 : INT_MAX;
      int carry_first = __shfl_up_sync(
          kFullMask, group_scan_max<LANES>(lane_start, sub), 1, LANES);
      int carry_last = __shfl_down_sync(
          kFullMask, group_scan_min_rev<LANES>(lane_end, sub), 1, LANES);
      if (sub == 0) carry_first = -1;
      if (sub + 1 == LANES) carry_last = INT_MAX;
      int firsts[E];
      int run = carry_first;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (starts & (1u << e)) run = sub * E + e;
        firsts[e] = run;
      }
      run = carry_last;
#pragma unroll
      for (int e = E - 1; e >= 0; --e) {
        const int p = sub * E + e;
        if (ends & (1u << e)) run = p;
        const int r2 = firsts[e] + run + 2;
        if (p < n) {
          s_rr += r2 * r2;
          s_rx += r2 * x[e];
        }
      }
    }
    const long long rr = group_sum<LANES>(static_cast<long long>(s_rr));
    const long long rx = group_sum<LANES>(static_cast<long long>(s_rx));
    if (voxel < v && sub == 0) {
      sums[voxel * 3] = sum_2r;
      sums[voxel * 3 + 1] = rr;
      sums[voxel * 3 + 2] = rx;
    }
  }
}

// Ascending bitonic sort of (keys, pay)[0, len) (len a power of two) by
// one warp in shared memory.
__device__ void warp_bitonic_sort(unsigned* keys, int* pay, int len,
                                  int lane) {
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < len; t += 32) {
        const int partner = t ^ stride;
        if (partner > t) {
          const unsigned lo = keys[t], hi = keys[partner];
          if ((lo > hi) == ((t & size) == 0)) {
            keys[t] = hi;
            keys[partner] = lo;
            const int px = pay[t];
            pay[t] = pay[partner];
            pay[partner] = px;
          }
        }
      }
      __syncwarp();
    }
  }
}

// The shared path: one warp a voxel, n > 1024.
__global__ void spearman_shared_kernel(const float* __restrict__ series,
                                       const int* __restrict__ xrank2,
                                       long long* __restrict__ sums,
                                       long long v, int n, int npow2) {
  extern __shared__ int smem_i[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  int* xr = smem_i;
  unsigned* keys = reinterpret_cast<unsigned*>(xr + n) + warp * 2 * npow2;
  int* pay = reinterpret_cast<int*>(keys + npow2);
  for (int j = threadIdx.x; j < n; j += blockDim.x) xr[j] = xrank2[j];
  __syncthreads();
  const long long voxel = static_cast<long long>(blockIdx.x) * warps + warp;
  if (voxel >= v) return;
  const float* y = series + voxel * n;
  for (int j = lane; j < npow2; j += 32) {
    const bool real = j < n;
    keys[j] = real ? sort_key(__ldcs(y + j), j) : kPadKey;
    pay[j] = real ? xr[j] : 0;
  }
  __syncwarp();
  warp_bitonic_sort(keys, pay, npow2, lane);

  // Forward: the first position of each position's run (a running max
  // of run starts), packed above the payload (2r_x ≤ 2n < 2¹⁶).
  int carry = -1;
  for (int base = 0; base < n; base += 32) {
    const int p = base + lane;
    int first = -1;
    if (p < n) first = (p == 0 || keys[p] != keys[p - 1]) ? p : -1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int other = __shfl_up_sync(kFullMask, first, off);
      if (lane >= off) first = max(first, other);
    }
    first = max(first, carry);
    carry = __shfl_sync(kFullMask, first, 31);
    if (p < n) pay[p] |= first << 16;
  }
  __syncwarp();
  // Backward: the last position of each run (a running min of run
  // ends), then 2r = first + last + 2 and the moments.
  long long s_rr = 0, s_rx = 0;
  carry = INT_MAX;
  for (int base = (n - 1) & ~31; base >= 0; base -= 32) {
    const int p = base + lane;
    int last = INT_MAX;
    if (p < n) last = (p == n - 1 || keys[p] != keys[p + 1]) ? p : INT_MAX;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int other = __shfl_down_sync(kFullMask, last, off);
      if (lane + off < 32) last = min(last, other);
    }
    last = min(last, carry);
    carry = __shfl_sync(kFullMask, last, 0);
    if (p < n) {
      const int packed = pay[p];
      const long long r = (packed >> 16) + last + 2;
      s_rr += r * r;
      s_rx += r * (packed & 0xffff);
    }
  }
  s_rr = warp_sum(s_rr);
  s_rx = warp_sum(s_rx);
  if (lane == 0) {
    sums[voxel * 3] = static_cast<long long>(n) * (n + 1);
    sums[voxel * 3 + 1] = s_rr;
    sums[voxel * 3 + 2] = s_rx;
  }
}

int g_sm_count = 0;

template <int LANES, int E, int PROBE>
cudaError_t launch_regs(const void* series, const void* xrank2, void* sums,
                        long long v, int n, cudaStream_t stream) {
  auto kernel = spearman_regs_kernel<LANES, E, PROBE>;
  const size_t smem =
      ((n + 1) & ~1) * sizeof(int) +
      (merges<PROBE>()
           ? (kBlockThreads / LANES) * merge_slots<LANES, E>() * sizeof(uint2)
           : 0);
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kBlockThreads, smem);
  if (err != cudaSuccess) return err;
  const long long groups = kBlockThreads / LANES;
  const long long needed = (v + groups - 1) / groups;
  const long long resident = static_cast<long long>(max(per_sm, 1)) *
                             g_sm_count;
  const long long blocks = needed < resident ? needed : resident;
  kernel<<<static_cast<unsigned>(blocks), kBlockThreads, smem, stream>>>(
      static_cast<const float*>(series), static_cast<const int*>(xrank2),
      static_cast<long long*>(sums), v, n);
  return cudaGetLastError();
}

cudaError_t launch_shared(const void* series, const void* xrank2, void* sums,
                          long long v, int n, cudaStream_t stream) {
  int npow2 = 32;
  while (npow2 < n) npow2 <<= 1;
  int warps;
  size_t smem;
  if (!launch_shape(n * sizeof(int), 2 * npow2 * sizeof(int), &warps,
                    &smem)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_shared(spearman_shared_kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (v + warps - 1) / warps;
  spearman_shared_kernel<<<static_cast<unsigned>(blocks), warps * 32, smem,
                           stream>>>(
      static_cast<const float*>(series), static_cast<const int*>(xrank2),
      static_cast<long long*>(sums), v, n, npow2);
  return cudaGetLastError();
}

int pow2_at_least(int n, int floor) {
  int p = floor;
  while (p < n) p <<= 1;
  return p;
}

// The shipped register path at LANES (8 or 32) lanes: E = pow2(n) /
// LANES.
template <int LANES>
cudaError_t launch_lanes(const void* series, const void* xrank2, void* sums,
                         long long v, int n, cudaStream_t stream) {
  const int e = pow2_at_least(n, LANES) / LANES;
  if constexpr (LANES == 8) {
    switch (e) {
      case 1:
        return launch_regs<8, 1, kShipped>(series, xrank2, sums, v, n, stream);
      case 2:
        return launch_regs<8, 2, kShipped>(series, xrank2, sums, v, n, stream);
      case 4:
        return launch_regs<8, 4, kShipped>(series, xrank2, sums, v, n, stream);
      case 8:
        return launch_regs<8, 8, kShipped>(series, xrank2, sums, v, n, stream);
      case 16:
        return launch_regs<8, 16, kShipped>(series, xrank2, sums, v, n,
                                            stream);
    }
  } else {
    switch (e) {
      case 8:
        return launch_regs<32, 8, kShipped>(series, xrank2, sums, v, n,
                                            stream);
      case 16:
        return launch_regs<32, 16, kShipped>(series, xrank2, sums, v, n,
                                             stream);
      case 32:
        return launch_regs<32, 32, kShipped>(series, xrank2, sums, v, n,
                                             stream);
    }
  }
  return cudaErrorInvalidValue;
}

cudaError_t prepare(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (g_sm_count == 0) {
    err = cudaDeviceGetAttribute(&g_sm_count, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  return err;
}

}  // namespace

extern "C" int correrender_spearman(const void* series, const void* xrank2,
                                    void* sums, long long v, int n,
                                    int device, void* stream) {
  cudaError_t err = prepare(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  if (n <= kNarrowMaxMembers) {
    return launch_lanes<8>(series, xrank2, sums, v, n, st);
  }
  if (n <= kRegisterMaxMembers) {
    return launch_lanes<32>(series, xrank2, sums, v, n, st);
  }
  return launch_shared(series, xrank2, sums, v, n, st);
}

// Variants of the register path for ops/cuda/ablate_spearman.py, not on
// any entry point's path: `lanes` a voxel with `probe` 0 (the shipped
// scheme), 1 (no sort), 2 (no tie scan) or 3 (the order by a bitonic
// network across the lanes' registers). Built: 8 lanes at E = 16
// (64 < n ≤ 128) with each probe; 16 lanes at E = 8 (64 < n ≤ 128);
// 32 lanes at E = 4 (64 < n ≤ 128, the shipped scheme) and at E = 32
// (512 < n ≤ 1024) with each probe. Other shapes are refused.
extern "C" int correrender_spearman_probe(const void* series,
                                          const void* xrank2, void* sums,
                                          long long v, int n, int lanes,
                                          int probe, int device,
                                          void* stream) {
  cudaError_t err = prepare(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > kRegisterMaxMembers) return cudaErrorInvalidValue;
  const int e = pow2_at_least(n, lanes) / lanes;
  if (lanes == 8 && e == 16) {
    if (probe == kShipped) {
      return launch_regs<8, 16, kShipped>(series, xrank2, sums, v, n, st);
    }
    if (probe == kNoSort) {
      return launch_regs<8, 16, kNoSort>(series, xrank2, sums, v, n, st);
    }
    if (probe == kNoTieScan) {
      return launch_regs<8, 16, kNoTieScan>(series, xrank2, sums, v, n, st);
    }
    if (probe == kBitonic) {
      return launch_regs<8, 16, kBitonic>(series, xrank2, sums, v, n, st);
    }
  }
  if (lanes == 16 && e == 8 && probe == kShipped) {
    return launch_regs<16, 8, kShipped>(series, xrank2, sums, v, n, st);
  }
  if (lanes == 32 && e == 4 && probe == kShipped) {
    return launch_regs<32, 4, kShipped>(series, xrank2, sums, v, n, st);
  }
  if (lanes == 32 && e == 32) {
    if (probe == kShipped) {
      return launch_regs<32, 32, kShipped>(series, xrank2, sums, v, n, st);
    }
    if (probe == kNoSort) {
      return launch_regs<32, 32, kNoSort>(series, xrank2, sums, v, n, st);
    }
    if (probe == kNoTieScan) {
      return launch_regs<32, 32, kNoTieScan>(series, xrank2, sums, v, n, st);
    }
    if (probe == kBitonic) {
      return launch_regs<32, 32, kBitonic>(series, xrank2, sums, v, n, st);
    }
  }
  return cudaErrorInvalidValue;
}
