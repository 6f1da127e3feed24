// B1: one-pass Pearson moments of a member-major chunk.
//
// Replaces correrender_tpu/ops/pallas/moments_kernel.py::
// chunk_moments_flat. For an (E, V) chunk (float32 or bfloat16, upcast
// on read) and an (E,) float32 slice of the reference series it
// computes, per voxel, Σy, Σy² and Σxy in float32 registers and writes
// them as a (3, V) float32 array, or adds them to running sums once at
// the end (acc + Σ_chunk, the rounding of the streaming loop's
// `s_y + m[0]`). A zero member row paired with a zero reference entry
// adds nothing. Any E and V are taken: the TPU kernel's block rules
// (V a multiple of the voxel tile, E of 8) do not apply.
//
// Bound on the H100: device-memory traffic. The chunk is read once
// (E·V·4 or E·V·2 bytes) and the sums are written (and read, when
// accumulating) once; five flops per element read.
//
// Rounding: the sums run over the members in order, each product and
// sum rounded on its own (__fmul_rn / __fadd_rn, never contracted into
// an FMA), as the plain version adds row after row; kernel and plain
// version agree to the bit.
//
// Design: each thread owns VEC consecutive voxels and reads one 16-byte
// vector of them for each member in turn (a float4, or eight bfloat16
// values unpacked by shifts), with the streaming cache hint: a chunk is
// read once. A warp reads 512 contiguous bytes of one member row per
// load. The reference slice passes through shared memory in tiles, so
// any E fits. The member loop is unrolled so that several rows' loads
// are in flight at once. Where V is not a multiple of VEC, or the chunk
// is not 16-byte aligned, the same kernel reads scalars instead.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRefTile = 1024;

__device__ __forceinline__ float bf16_to_float(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

// Row `row` of the chunk, voxels [v0, v0 + VEC), into y (0 past the end).
template <typename T, int VEC, bool kVector>
__device__ __forceinline__ void load_row(const T* __restrict__ row,
                                         long long v0, long long v,
                                         float (&y)[VEC]);

template <>
__device__ __forceinline__ void load_row<float, 4, true>(
    const float* __restrict__ row, long long v0, long long, float (&y)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(row + v0));
  y[0] = q.x;
  y[1] = q.y;
  y[2] = q.z;
  y[3] = q.w;
}

template <>
__device__ __forceinline__ void load_row<unsigned short, 8, true>(
    const unsigned short* __restrict__ row, long long v0, long long,
    float (&y)[8]) {
  const uint4 q = __ldcs(reinterpret_cast<const uint4*>(row + v0));
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little endian: element 2i is the low half
    y[2 * i] = __uint_as_float(w[i] << 16);
    y[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <>
__device__ __forceinline__ void load_row<float, 4, false>(
    const float* __restrict__ row, long long v0, long long v, float (&y)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = v0 + j < v ? __ldcs(row + v0 + j) : 0.f;
}

template <>
__device__ __forceinline__ void load_row<unsigned short, 8, false>(
    const unsigned short* __restrict__ row, long long v0, long long v,
    float (&y)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    y[j] = v0 + j < v ? bf16_to_float(__ldcs(row + v0 + j)) : 0.f;
  }
}

template <typename T, int VEC, bool kVector>
__global__ void __launch_bounds__(kThreads) moments_kernel(
    const T* __restrict__ chunk, const float* __restrict__ ref,
    const float* acc, float* out, long long v, int e) {  // out may be acc
  __shared__ float sref[kRefTile];
  const long long v0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  float sy[VEC], syy[VEC], sxy[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) sy[j] = syy[j] = sxy[j] = 0.f;

  for (int e0 = 0; e0 < e; e0 += kRefTile) {
    const int ne = min(kRefTile, e - e0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < ne; i += kThreads) sref[i] = ref[e0 + i];
    __syncthreads();
    if (v0 < v) {
      const T* __restrict__ row = chunk + static_cast<long long>(e0) * v;
#pragma unroll 8
      for (int m = 0; m < ne; ++m) {
        float y[VEC];
        load_row<T, VEC, kVector>(row + static_cast<long long>(m) * v, v0, v,
                                  y);
        const float x = sref[m];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          sy[j] = __fadd_rn(sy[j], y[j]);
          syy[j] = __fadd_rn(syy[j], __fmul_rn(y[j], y[j]));
          sxy[j] = __fadd_rn(sxy[j], __fmul_rn(x, y[j]));
        }
      }
    }
  }
  if (v0 >= v) return;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const long long i = v0 + j;
    if (i < v) {
      if (acc != nullptr) {
        out[i] = __fadd_rn(acc[i], sy[j]);
        out[v + i] = __fadd_rn(acc[v + i], syy[j]);
        out[2 * v + i] = __fadd_rn(acc[2 * v + i], sxy[j]);
      } else {
        out[i] = sy[j];
        out[v + i] = syy[j];
        out[2 * v + i] = sxy[j];
      }
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* chunk, const void* ref, const void* acc,
                   void* out, long long v, int e, bool vector,
                   cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kThreads) * VEC;
  const unsigned blocks = static_cast<unsigned>((v + per_block - 1) / per_block);
  const T* c = static_cast<const T*>(chunk);
  const float* r = static_cast<const float*>(ref);
  const float* a = static_cast<const float*>(acc);
  float* o = static_cast<float*>(out);
  if (vector) {
    moments_kernel<T, VEC, true><<<blocks, kThreads, 0, stream>>>(c, r, a, o,
                                                                  v, e);
  } else {
    moments_kernel<T, VEC, false><<<blocks, kThreads, 0, stream>>>(c, r, a, o,
                                                                   v, e);
  }
  return cudaGetLastError();
}

}  // namespace

// chunk: (e, v) row-major, float32 (bf16 == 0) or bfloat16 (bf16 == 1);
// ref: (e,) float32; acc: (3, v) float32 running sums or null; out:
// (3, v) float32, which may be acc itself.
extern "C" int correrender_chunk_moments(const void* chunk, int bf16,
                                         const void* ref, const void* acc,
                                         void* out, long long v, int e,
                                         int device, void* stream) {
  if (v < 1 || e < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int vec = bf16 ? 8 : 4;
  const bool vector =
      v % vec == 0 && reinterpret_cast<unsigned long long>(chunk) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<unsigned short, 8>(chunk, ref, acc, out, v, e, vector, s)
              : launch<float, 4>(chunk, ref, acc, out, v, e, vector, s);
}
