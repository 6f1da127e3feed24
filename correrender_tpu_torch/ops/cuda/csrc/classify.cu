// K2 and B3: transfer-function classification.
//
// K2 (correrender_classify_cf) replaces
// correrender_tpu/ops/pallas/shearwarp_kernel.py::classify_to_cf: it
// classifies into the shear-warp compositor's bf16 layout.
// B3 (correrender_classify_volume) replaces
// correrender_tpu/ops/pallas/classify_kernel.py::classify_pallas: it
// classifies a field into (Z, Y, X, 4) float32.
//
// Both share lut_lerp, whose semantics follow the f32 reference
// render/classify.py:34-41, not the TPU kernels (which round the tent
// weights and the LUT to bf16, classify_kernel.py:39-43): u = clip((v −
// lo)/(hi − lo), 0, 1)·(R − 1), a linear lerp of the premultiplied LUT
// at u, NaN → transparent black, and a degenerate domain (hi ≤ lo) maps
// every finite value to bin 0 (the TPU kernels divide by zero there).
//
// Bound on the H100: device-memory traffic. K2 reads 4 bytes and writes
// 8 per voxel, B3 reads 4 and writes 16; the LUT (R·16 bytes) stays in
// L1. The lerp is direct (two LUT reads), where the TPU needed a two-hot
// matrix product because it has no fast gather.
//
// K2 is one thread per voxel of the slice-oriented volume (S, Yv, Xv).
// It reads the (Z, Y, X) field through the permute-and-flip strides of
// the camera's slice orientation, so no transposed copy of the field is
// made, rounds the four channels to bf16 and stores them as one 8-byte
// word, in the (S, Yv, Xv, 4) layout that K3 reads.
// B3 is a persistent grid-stride stream over a contiguous field (as many
// blocks as the card holds at once). Each warp classifies a chunk of 128
// voxels a step: lane t loads voxels t, t + 32, t + 64 and t + 96 (four
// coalesced 128-byte loads in flight), classifies them and stores each
// with a 16-byte streaming store (__stcs: written once, not read again
// here), so every store instruction writes 512 contiguous bytes, whole
// sectors; the last chunk's voxels past n are masked. Any 4-byte aligned
// base takes this path, an offset view included. The probe entry
// launches the other layout, 4 consecutive voxels a thread (one 16-byte
// load, four 16-byte stores 64 bytes apart across the warp, a scalar
// tail, a scalar loop for a base that is not 16-byte aligned): its store
// instructions write half sectors spread over 2 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float4 lut_lerp(float val,
                                           const float4* __restrict__ lutp,
                                           int res, float lo, float hi) {
  float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
  if (isnan(val)) return c;
  const float span = hi - lo;
  float u = 0.f;
  if (span > 0.f) {
    u = fminf(fmaxf((val - lo) / span, 0.f), 1.f) * static_cast<float>(res - 1);
  }
  const int i0 = min(static_cast<int>(floorf(u)), res - 1);
  const int i1 = min(i0 + 1, res - 1);
  const float f = u - static_cast<float>(i0);
  const float4 a = __ldg(lutp + i0);
  const float4 b = __ldg(lutp + i1);
  c.x = (1.f - f) * a.x + f * b.x;
  c.y = (1.f - f) * a.y + f * b.y;
  c.z = (1.f - f) * a.z + f * b.z;
  c.w = (1.f - f) * a.w + f * b.w;
  return c;
}

__global__ void classify_cf_kernel(const float* __restrict__ field,
                                   long long st_s, long long st_v,
                                   long long st_u, int yv, int xv,
                                   const float4* __restrict__ lutp, int res,
                                   float lo, float hi,
                                   uint2* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= yv * xv) return;
  const int s = blockIdx.y;
  const int iv = p / xv;
  const int iu = p - iv * xv;
  const float4 c = lut_lerp(field[s * st_s + iv * st_v + iu * st_u], lutp,
                            res, lo, hi);
  __nv_bfloat162 rg = __floats2bfloat162_rn(c.x, c.y);
  __nv_bfloat162 ba = __floats2bfloat162_rn(c.z, c.w);
  uint2 word;
  word.x = *reinterpret_cast<unsigned int*>(&rg);
  word.y = *reinterpret_cast<unsigned int*>(&ba);
  out[static_cast<long long>(s) * yv * xv + p] = word;
}

constexpr int kVolumeThreads = 256;
constexpr int kChunk = 128;  // voxels a warp classifies a step
// B3's layouts: warp-strided chunks (shipped), 4 consecutive voxels a
// thread from one 16-byte load (probe), and its scalar loop.
constexpr int kStrided = 0, kQuads = 1, kScalar = 2;

template <int LAYOUT>
__global__ void __launch_bounds__(kVolumeThreads) classify_volume_kernel(
    const float* __restrict__ field, long long n,
    const float4* __restrict__ lutp, int res, float lo, float hi,
    float4* __restrict__ out) {
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  if constexpr (LAYOUT == kStrided) {
    const long long warps = stride / 32;
    const int lane = threadIdx.x & 31;
    for (long long c = first / 32; c * kChunk < n; c += warps) {
      const long long base = c * kChunk + lane;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long i = base + 32 * j;
        v[j] = i < n ? __ldg(field + i) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long i = base + 32 * j;
        if (i < n) __stcs(out + i, lut_lerp(v[j], lutp, res, lo, hi));
      }
    }
  } else {
    long long head = 0;  // voxels before the scalar loop
    if constexpr (LAYOUT == kQuads) {
      const long long quads = n >> 2;
      const float4* __restrict__ field4 =
          reinterpret_cast<const float4*>(field);
      for (long long i = first; i < quads; i += stride) {
        const float4 v = __ldg(field4 + i);
        float4* __restrict__ o = out + 4 * i;
        __stcs(o, lut_lerp(v.x, lutp, res, lo, hi));
        __stcs(o + 1, lut_lerp(v.y, lutp, res, lo, hi));
        __stcs(o + 2, lut_lerp(v.z, lutp, res, lo, hi));
        __stcs(o + 3, lut_lerp(v.w, lutp, res, lo, hi));
      }
      head = quads << 2;
    }
    for (long long i = head + first; i < n; i += stride) {
      __stcs(out + i, lut_lerp(__ldg(field + i), lutp, res, lo, hi));
    }
  }
}

int g_sm_count = 0;

template <int LAYOUT>
cudaError_t launch_volume(const float* field, long long n, const float4* lutp,
                          int res, float lo, float hi, float4* out,
                          cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, classify_volume_kernel<LAYOUT>, kVolumeThreads, 0);
  if (err != cudaSuccess) return err;
  const long long threads = LAYOUT == kStrided ? (n + kChunk - 1) / kChunk * 32
                            : LAYOUT == kQuads ? (n + 3) / 4
                                               : n;
  const long long needed = (threads + kVolumeThreads - 1) / kVolumeThreads;
  const long long resident =
      static_cast<long long>(per_sm > 0 ? per_sm : 1) * g_sm_count;
  const unsigned blocks =
      static_cast<unsigned>(needed < resident ? needed : resident);
  classify_volume_kernel<LAYOUT><<<blocks, kVolumeThreads, 0, stream>>>(
      field, n, lutp, res, lo, hi, out);
  return cudaGetLastError();
}

// B3's launch: `layout` 0 is the shipped warp-strided stream, 1 the probe
// of 4 consecutive voxels a thread (its scalar loop where the base is not
// 16-byte aligned).
int launch_classify_volume(const void* field, long long n, const void* lutp,
                           int res, float lo, float hi, void* out, int layout,
                           int device, void* stream) {
  if (n < 1 || res < 1 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(field) % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (g_sm_count == 0) {
    err = cudaDeviceGetAttribute(&g_sm_count, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
  }
  const auto* f = static_cast<const float*>(field);
  const auto* l = static_cast<const float4*>(lutp);
  auto* o = static_cast<float4*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (layout == kStrided) {
    return launch_volume<kStrided>(f, n, l, res, lo, hi, o, s);
  }
  if (layout != kQuads) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(field) % 16 == 0) {
    return launch_volume<kQuads>(f, n, l, res, lo, hi, o, s);
  }
  return launch_volume<kScalar>(f, n, l, res, lo, hi, o, s);
}

}  // namespace

extern "C" int correrender_classify_cf(
    const void* field, long long offset, long long st_s, long long st_v,
    long long st_u, int s, int yv, int xv, const void* lutp, int res,
    float lo, float hi, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  constexpr int kThreads = 256;
  const dim3 grid((yv * xv + kThreads - 1) / kThreads, s);
  classify_cf_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(field) + offset, st_s, st_v, st_u, yv, xv,
      static_cast<const float4*>(lutp), res, lo, hi, static_cast<uint2*>(out));
  return cudaGetLastError();
}

extern "C" int correrender_classify_volume(const void* field, long long n,
                                           const void* lutp, int res,
                                           float lo, float hi, void* out,
                                           int device, void* stream) {
  return launch_classify_volume(field, n, lutp, res, lo, hi, out, kStrided,
                                device, stream);
}

// B3 with 4 consecutive voxels a thread, for chip_smoke.py only (`layout`
// 1; 0 is the shipped kernel): the same answer, another store pattern.
extern "C" int correrender_classify_volume_probe(
    const void* field, long long n, const void* lutp, int res, float lo,
    float hi, void* out, int layout, int device, void* stream) {
  return launch_classify_volume(field, n, lutp, res, lo, hi, out, layout,
                                device, stream);
}
