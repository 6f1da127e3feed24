// K1: fused one-pass Pearson correlation over the member axis.
//
// Replaces correrender_tpu/ops/pallas/pearson_kernel.py::pearson_pallas
// (_pearson_pallas_flat). Semantics: the reference's one-pass
// computePearson1 (Correlation.cpp:42-99),
//
//     r = (n·Σxy − Σx·Σy) / sqrt((n·Σxx − (Σx)²) · (n·Σyy − (Σy)²)),
//
// so a zero-variance series gives 0/0 = NaN, as in the reference.
//
// Bound on the H100: device-memory traffic. The kernel reads the
// (V, n) f32 stack exactly once (V·n·4 bytes, 6.25 GB at 250³ × 100:
// 1.884 ms at 3.35 TB/s) and writes V floats; it does about 5 flops per
// 4-byte load, far below the ~20 flop/byte where f32 arithmetic would
// become the limit. So the design is about keeping enough bytes in
// flight and spending few instructions per member.
//
// Design (the tiled regime): the stack is member-last, so a tile of T
// voxels is one contiguous run of T·n·4 bytes. A persistent grid (as
// many blocks as stay resident) strides over the tiles; thread 0 of each
// block streams them into a ring of kStages shared-memory buffers with
// 1D bulk copies (cp.async.bulk, the TMA's non-tensor form) completing
// on one mbarrier per stage, so the next tiles' bytes are in flight
// while the current one is reduced. T is a multiple of 8, so every
// tile starts 16-byte aligned; the ragged last tile copies its 16-byte
// multiple in bulk and its last 4, 8 or 12 bytes by plain loads, and
// nothing is read past the end. The reference series sits in shared
// memory, and the block's prologue sums Σx and Σx² from it. LANES lanes
// reduce one voxel (4 up to kNarrowMaxMembers members, a warp above),
// so a voxel costs log2(LANES) shuffle rounds. A group starts its walk
// over the row at an offset chosen so that the warp's LANES-wide groups
// read 32 distinct banks whatever n ≥ 32 is (rows are n floats apart).
// Plain f32 FMAs, no tensor cores: the TPU kernel needed
// Precision.HIGHEST because a single bf16 pass cost 3.4e-4; here there
// is no reduced-precision pass to avoid.
//
// The direct regime (the first design, made persistent): one warp per
// voxel, its lanes striding over the members straight from device
// memory. It takes a stack whose base is not 16-byte aligned (an offset
// view; bulk copies need 16-byte alignment) and n above
// kTiledMaxMembers, where a stage of 8 rows would no longer fit the
// ring.

#include <cstdint>

#include <cuda_runtime.h>

#include "ksg_common.cuh"

namespace {

using correrender::allow_shared;
using correrender::kFullMask;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
constexpr int kNarrowLanes = 4;
constexpr int kNarrowMaxMembers = 128;
// A tile holds as many LANES-wide passes of the block as fit this many
// bytes (at least one pass).
constexpr int kTileTargetBytes = 32 * 1024;
constexpr int kTiledMaxMembers = 2048;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Arrives on `bar` and adds `bytes` to the transaction count its phase
// waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory into shared memory; completion counts on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float pearson_r(int n, float sx, float sxx,
                                           float sy, float syy, float sxy) {
  const float nn = static_cast<float>(n);
  const float num = nn * sxy - sx * sy;
  const float den = sqrtf((nn * sxx - sx * sx) * (nn * syy - sy * sy));
  return num / den;
}

// Σx and Σx² of the reference series `x` (n floats), summed by the
// block's first warp in a fixed order; every thread returns them.
__device__ __forceinline__ float2 reference_sums(const float* x, int n,
                                                 float2* shared_out) {
  if (threadIdx.x < 32) {
    float sx = 0.f, sxx = 0.f;
    for (int j = threadIdx.x; j < n; j += 32) {
      const float xj = x[j];
      sx += xj;
      sxx = fmaf(xj, xj, sxx);
    }
    sx = correrender::warp_sum(sx);
    sxx = correrender::warp_sum(sxx);
    if (threadIdx.x == 0) *shared_out = make_float2(sx, sxx);
  }
  __syncthreads();
  return *shared_out;
}

struct TileShape {
  int voxels;         // T: a multiple of the block's groups (≥ 8)
  uint32_t stride;    // bytes between stage buffers (128-aligned)
};

template <int LANES>
TileShape tile_shape(int n, int target_bytes) {
  constexpr int groups = kThreads / LANES;
  const long long pass_bytes = static_cast<long long>(groups) * n * 4;
  const long long passes =
      pass_bytes >= target_bytes ? 1 : target_bytes / pass_bytes;
  TileShape shape;
  shape.voxels = static_cast<int>(groups * passes);
  shape.stride = static_cast<uint32_t>(
      (static_cast<long long>(shape.voxels) * n * 4 + 127) / 128 * 128);
  return shape;
}

// Shared-memory layout of the tiled kernel: STAGES stage buffers, the
// reference series, then one mbarrier per stage.
__host__ __device__ inline size_t ref_offset(int stages, uint32_t stride) {
  return static_cast<size_t>(stages) * stride;
}
__host__ __device__ inline size_t bar_offset(int stages, uint32_t stride,
                                             int n) {
  return ref_offset(stages, stride) + (static_cast<size_t>(n) * 4 + 15) / 16 * 16;
}

template <int LANES, int STAGES>
__global__ void __launch_bounds__(kThreads)
pearson_tiled_kernel(const float* __restrict__ series,
                     const float* __restrict__ ref, float* __restrict__ out,
                     long long v, int n, int tile_voxels, uint32_t stride,
                     long long tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float2 ref_sums;
  float* xs = reinterpret_cast<float*>(smem + ref_offset(STAGES, stride));
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + bar_offset(STAGES, stride, n));
  const int tid = threadIdx.x;

  // Thread 0 streams tile `tile` into stage `stage`.
  auto issue = [&](long long tile, int stage) {
    const long long first = tile * tile_voxels;
    const long long count =
        v - first < tile_voxels ? v - first : static_cast<long long>(tile_voxels);
    const uint32_t bytes = static_cast<uint32_t>(count * n * 4);
    const uint32_t bulk = bytes & ~15u;
    const float* src = series + first * n;
    float* dst = reinterpret_cast<float*>(smem + stage * stride);
    // The ragged end (at most 3 floats of the last tile) by plain loads,
    // made visible by the arrive's release.
    for (uint32_t b = bulk / 4; b < bytes / 4; ++b) dst[b] = src[b];
    // Generic-proxy accesses of the buffer before the async proxy's
    // writes into it.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive_expect_tx(&bars[stage], bulk);
    if (bulk != 0) bulk_load(dst, src, bulk, &bars[stage]);
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int j = tid; j < n; j += kThreads) xs[j] = ref[j];
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      const long long tile = blockIdx.x + static_cast<long long>(s) * gridDim.x;
      if (tile < tiles) issue(tile, s);
    }
  }
  const float2 sums = reference_sums(xs, n, &ref_sums);

  constexpr int groups = kThreads / LANES;
  const int lane = tid % LANES;
  const int group = tid / LANES;
  // Group g of a warp starts its walk at member rot, so that its lane l
  // reads bank (g·n + rot + l) mod 32 = (g·LANES + l) mod 32. A row
  // shorter than 32 members starts at member 0 (the rotation would wrap
  // inside it).
  const int g_in_warp = (tid & 31) / LANES;
  const int rot =
      n < 32 ? 0 : ((g_in_warp * (LANES - n)) % 32 + 32) % 32;

  int it = 0;
  for (long long tile = blockIdx.x; tile < tiles;
       tile += gridDim.x, ++it) {
    const int stage = it % STAGES;
    mbar_wait(&bars[stage], static_cast<uint32_t>(it / STAGES) & 1u);
    const float* y = reinterpret_cast<const float*>(smem + stage * stride);
    const long long first = tile * tile_voxels;
    const int count = static_cast<int>(
        v - first < tile_voxels ? v - first : static_cast<long long>(tile_voxels));
    for (int base = 0; base < tile_voxels; base += groups) {
      const int local = base + group;
      const bool valid = local < count;
      float sy = 0.f, syy = 0.f, sxy = 0.f;
      if (valid) {
        const float* row = y + local * n;
#pragma unroll 4
        for (int j = lane; j < n; j += LANES) {
          int jj = j + rot;
          jj = jj >= n ? jj - n : jj;
          const float yj = row[jj];
          const float xj = xs[jj];
          sy += yj;
          syy = fmaf(yj, yj, syy);
          sxy = fmaf(xj, yj, sxy);
        }
      }
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1) {
        sy += __shfl_xor_sync(kFullMask, sy, off);
        syy += __shfl_xor_sync(kFullMask, syy, off);
        sxy += __shfl_xor_sync(kFullMask, sxy, off);
      }
      if (valid && lane == 0) {
        out[first + local] = pearson_r(n, sums.x, sums.y, sy, syy, sxy);
      }
    }
    __syncthreads();  // every thread is done with this stage's buffer
    if (tid == 0) {
      const long long next = tile + static_cast<long long>(STAGES) * gridDim.x;
      if (next < tiles) issue(next, stage);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
pearson_direct_kernel(const float* __restrict__ series,
                      const float* __restrict__ ref, float* __restrict__ out,
                      long long v, int n) {
  __shared__ float2 ref_sums;
  const float2 sums = reference_sums(ref, n, &ref_sums);
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long voxel =
           static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       voxel < v; voxel += warps) {
    const float* y = series + voxel * n;
    float sy = 0.f, syy = 0.f, sxy = 0.f;
#pragma unroll 4
    for (int j = lane; j < n; j += 32) {
      const float yj = __ldcs(y + j);
      const float xj = __ldg(ref + j);
      sy += yj;
      syy = fmaf(yj, yj, syy);
      sxy = fmaf(xj, yj, sxy);
    }
    sy = correrender::warp_sum(sy);
    syy = correrender::warp_sum(syy);
    sxy = correrender::warp_sum(sxy);
    if (lane == 0) out[voxel] = pearson_r(n, sums.x, sums.y, sy, syy, sxy);
  }
}

int g_sm_count = 0;

cudaError_t prepare(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (g_sm_count == 0) {
    err = cudaDeviceGetAttribute(&g_sm_count, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  return err;
}

template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, long long needed,
                            unsigned* blocks) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long resident =
      static_cast<long long>(per_sm > 0 ? per_sm : 1) * g_sm_count;
  *blocks = static_cast<unsigned>(needed < resident ? needed : resident);
  return cudaSuccess;
}

template <int LANES, int STAGES>
cudaError_t launch_tiled(const void* series, const void* ref, void* out,
                         long long v, int n, int target_bytes,
                         cudaStream_t stream) {
  const TileShape shape = tile_shape<LANES>(n, target_bytes);
  const size_t smem = bar_offset(STAGES, shape.stride, n) + STAGES * 8;
  if (smem > correrender::kMaxSharedBytes) return cudaErrorInvalidValue;
  auto kernel = pearson_tiled_kernel<LANES, STAGES>;
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (v + shape.voxels - 1) / shape.voxels;
  unsigned blocks = 0;
  err = resident_blocks(kernel, smem, tiles, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(series), static_cast<const float*>(ref),
      static_cast<float*>(out), v, n, shape.voxels, shape.stride, tiles);
  return cudaGetLastError();
}

cudaError_t launch_direct(const void* series, const void* ref, void* out,
                          long long v, int n, cudaStream_t stream) {
  unsigned blocks = 0;
  cudaError_t err = resident_blocks(pearson_direct_kernel, 0,
                                    (v + kWarps - 1) / kWarps, &blocks);
  if (err != cudaSuccess) return err;
  pearson_direct_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(series), static_cast<const float*>(ref),
      static_cast<float*>(out), v, n);
  return cudaGetLastError();
}

bool tiled_regime(const void* series, int n) {
  return n >= 1 && n <= kTiledMaxMembers &&
         reinterpret_cast<uintptr_t>(series) % 16 == 0;
}

}  // namespace

extern "C" int correrender_pearson(const void* series, const void* ref,
                                   void* out, long long v, int n, int device,
                                   void* stream) {
  cudaError_t err = prepare(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  if (!tiled_regime(series, n)) {
    return launch_direct(series, ref, out, v, n, st);
  }
  if (n <= kNarrowMaxMembers) {
    return launch_tiled<kNarrowLanes, kStages>(series, ref, out, v, n,
                                               kTileTargetBytes, st);
  }
  return launch_tiled<32, kStages>(series, ref, out, v, n, kTileTargetBytes,
                                   st);
}

// Variants for ops/cuda/ablate_fast_path.py, not on any entry point's
// path: `lanes` 0 is the direct regime (one warp a voxel from device
// memory, whatever the alignment); 4, 8, 16 or 32 lanes a voxel with 2,
// 3 or 4 stages and tiles of about `tile_bytes` take the tiled regime
// (16-byte aligned series, n ≤ 2048). Other shapes are refused.
extern "C" int correrender_pearson_probe(const void* series, const void* ref,
                                         void* out, long long v, int n,
                                         int lanes, int stages,
                                         int tile_bytes, int device,
                                         void* stream) {
  cudaError_t err = prepare(device);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  if (lanes == 0) return launch_direct(series, ref, out, v, n, st);
  if (!tiled_regime(series, n) || tile_bytes < 16) return cudaErrorInvalidValue;
#define CORRERENDER_PEARSON_PROBE(L, S)                                      \
  if (lanes == L && stages == S) {                                          \
    return launch_tiled<L, S>(series, ref, out, v, n, tile_bytes, st);       \
  }
  CORRERENDER_PEARSON_PROBE(4, 2)
  CORRERENDER_PEARSON_PROBE(4, 3)
  CORRERENDER_PEARSON_PROBE(4, 4)
  CORRERENDER_PEARSON_PROBE(8, 3)
  CORRERENDER_PEARSON_PROBE(16, 3)
  CORRERENDER_PEARSON_PROBE(32, 2)
  CORRERENDER_PEARSON_PROBE(32, 3)
  CORRERENDER_PEARSON_PROBE(32, 4)
#undef CORRERENDER_PEARSON_PROBE
  return cudaErrorInvalidValue;
}

extern "C" const char* correrender_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
