// B7: Spearman rho by a per-voxel sort, with exact integer moments.
//
// Replaces correrender_tpu/ops/pallas/spearman_kernel.py::spearman_pallas
// (_spearman_flat). The TPU kernel counts each member's rank pairwise
// (n² compares, since Mosaic has no sort); here each warp sorts its
// voxel's series in shared memory (bitonic, n log² n) and reads the
// tie-averaged ranks off the sorted runs:
//
//     2·rank = first + last + 2   (0-based first and last of the run),
//
// an integer, the same as the TPU kernel's 2·#{y_j < y_i} +
// #{y_j == y_i} + 1. The kernel sums 2r, (2r)² and (2r)(2r_x) in 64-bit
// integers (the doubled reference ranks 2r_x come from the host), so
// the moments are exact; the wrapper assembles rho in float64. (In f32,
// as JAX sums them, Σr² ≈ n³/3 passes 2²⁴ at n ≈ 370.)
//
// NaN follows the XLA path that correlate_field runs on the CPU
// (argsort puts NaN last, in index order): the sort key puts NaN after
// +inf and orders NaNs by index, and a NaN equals nothing, so each is a
// run of its own.
//
// Bound on the H100: the sort's compares (n log² n / 4 per voxel)
// against n reads; at n = 100 the stack's bytes.
//
// Design: one warp per voxel (ksg_common.cuh); the doubled reference
// ranks sit in shared memory once per block. The sort key is the
// value's bits mapped to an unsigned total order, above the member
// index, in one 64-bit word.

#include <cuda_runtime.h>

#include <climits>

#include "ksg_common.cuh"

namespace {

using namespace correrender;

using Key = unsigned long long;

// The member's value in an unsigned total order (NaN last), above its
// index: ascending keys are the stable argsort order.
__device__ __forceinline__ Key sort_key(float v, int idx) {
  unsigned u = __float_as_uint(v);
  u = isnan(v) ? 0xffffffffu : ((u & 0x80000000u) ? ~u : (u | 0x80000000u));
  return (static_cast<Key>(u) << 32) | static_cast<unsigned>(idx);
}

__device__ __forceinline__ int key_index(Key k) {
  return static_cast<int>(k & 0xffffffffu);
}

// Ascending bitonic sort of a[0, len) (len a power of two) by one warp.
__device__ void warp_bitonic_sort(Key* a, int len, int lane) {
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < len; t += 32) {
        const int partner = t ^ stride;
        if (partner > t) {
          const Key lo = a[t], hi = a[partner];
          if ((lo > hi) == ((t & size) == 0)) {
            a[t] = hi;
            a[partner] = lo;
          }
        }
      }
      __syncwarp();
    }
  }
}

__global__ void spearman_kernel(const float* __restrict__ series,
                                const int* __restrict__ xrank2,
                                long long* __restrict__ sums, long long v,
                                int n, int npow2) {
  extern __shared__ Key keys_all[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  Key* keys = keys_all + warp * npow2;
  int* xr = reinterpret_cast<int*>(keys_all + warps * npow2);
  float* ys = reinterpret_cast<float*>(xr + n) + warp * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) xr[j] = xrank2[j];
  const long long voxel = static_cast<long long>(blockIdx.x) * warps + warp;
  const bool live = voxel < v;
  if (live) {
    const float* y = series + voxel * n;
    for (int j = lane; j < npow2; j += 32) {
      Key key = ~Key(0);  // padding sorts last
      if (j < n) {
        const float yj = __ldcs(y + j);
        ys[j] = yj;
        key = sort_key(yj, j);
      }
      keys[j] = key;
    }
  }
  __syncthreads();
  if (!live) return;
  warp_bitonic_sort(keys, npow2, lane);

  // Forward: the start of each position's run (a running max of run
  // starts), kept in the key's upper word; the index stays below.
  int carry = 0;
  for (int base = 0; base < n; base += 32) {
    const int p = base + lane;
    int first = -1, idx = 0;
    if (p < n) {
      idx = key_index(keys[p]);
      const bool start = p == 0 || !(ys[idx] == ys[key_index(keys[p - 1])]);
      first = start ? p : -1;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int other = __shfl_up_sync(kFullMask, first, off);
      if (lane >= off) first = max(first, other);
    }
    first = max(first, carry);
    carry = __shfl_sync(kFullMask, first, 31);
    __syncwarp();  // every lane has read keys[p - 1]
    if (p < n) keys[p] = (static_cast<Key>(first) << 32) | idx;
    __syncwarp();
  }
  // Backward: the end of each run (a running min of run ends), then
  // 2r = first + last + 2 and the moments.
  long long s_r = 0, s_rr = 0, s_rx = 0;
  carry = INT_MAX;
  for (int base = (n - 1) & ~31; base >= 0; base -= 32) {
    const int p = base + lane;
    int last = INT_MAX, idx = 0;
    if (p < n) {
      idx = key_index(keys[p]);
      const bool end =
          p == n - 1 || !(ys[idx] == ys[key_index(keys[p + 1])]);
      last = end ? p : INT_MAX;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int other = __shfl_down_sync(kFullMask, last, off);
      if (lane + off < 32) last = min(last, other);
    }
    last = min(last, carry);
    carry = __shfl_sync(kFullMask, last, 0);
    if (p < n) {
      const long long r = static_cast<long long>(keys[p] >> 32) + last + 2;
      s_r += r;
      s_rr += r * r;
      s_rx += r * xr[idx];
    }
  }
  s_r = warp_sum(s_r);
  s_rr = warp_sum(s_rr);
  s_rx = warp_sum(s_rx);
  if (lane == 0) {
    sums[voxel * 3] = s_r;
    sums[voxel * 3 + 1] = s_rr;
    sums[voxel * 3 + 2] = s_rx;
  }
}

}  // namespace

extern "C" int correrender_spearman(const void* series, const void* xrank2,
                                    void* sums, long long v, int n,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int npow2 = 32;
  while (npow2 < n) npow2 <<= 1;
  int warps;
  size_t smem;
  if (!launch_shape(n * sizeof(int),
                    npow2 * sizeof(Key) + n * sizeof(float), &warps, &smem)) {
    return cudaErrorInvalidValue;
  }
  err = allow_shared(spearman_kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (v + warps - 1) / warps;
  spearman_kernel<<<static_cast<unsigned>(blocks), warps * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(series), static_cast<const int*>(xrank2),
      static_cast<long long*>(sums), v, n, npow2);
  return cudaGetLastError();
}
