// Fused RMSNorm for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * (1 + scale)
// over the last dimension, accumulated in f32, written in x's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (`_rmsnorm_kernel`, pallas_call at :40).
//
// Bound on the card: bytes. The norm does ~4 flops per element and must read x
// once and write out once, so at gemma2-9b's prefill shape [4000, 3584] bf16 it
// moves 57 MB: >= 17 us at 3.35 TB/s. Design: one block per row; each thread
// reads 16-byte vectors (8 bf16 or 4 f32) when the row length allows, with a
// scalar path otherwise; the sum of squares is reduced with warp shuffles and a
// 32-slot shared-memory stage. The second pass re-reads the row, which a
// 7-14 KB row keeps in L1/L2, so device memory sees one read and one write.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// Sum over the block; every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

template <typename T, typename S, bool kVec>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                               T* __restrict__ out, int d, float eps) {
  __shared__ float red[32];
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const T* xr = x + (int64_t)blockIdx.x * d;
  T* outr = out + (int64_t)blockIdx.x * d;

  float ss = 0.f;
  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f32(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  const float inv = rsqrtf(block_sum(ss, red) / (float)d + eps);

  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* ov = reinterpret_cast<uint4*>(outr);
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 res;
      T* r = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < V; ++j)
        r[j] = from_f32<T>(to_f32(e[j]) * inv * (1.f + to_f32(scale[i * V + j])));
      ov[i] = res;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      outr[i] = from_f32<T>(to_f32(xr[i]) * inv * (1.f + to_f32(scale[i])));
  }
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* out, long long rows, int d,
                   float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && ((uintptr_t)x % 16) == 0 && ((uintptr_t)out % 16) == 0;
  const int units = vec ? d / V : d;
  int threads = ((units + 31) / 32) * 32;  // narrow rows: one warp
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  T* op = static_cast<T*>(out);
  if (vec)
    rmsnorm_kernel<T, S, true><<<(unsigned)rows, threads, 0, stream>>>(xp, sp, op, d, eps);
  else
    rmsnorm_kernel<T, S, false><<<(unsigned)rows, threads, 0, stream>>>(xp, sp, op, d, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out: [rows, d] contiguous; scale: [d]. dtype codes: 0 = float32, 1 = bfloat16.
// Returns the launch's cudaError_t (0 on success); the kernel runs asynchronously
// on `stream`.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out, long long rows,
                             int d, float eps, int x_dtype, int scale_dtype, void* stream) {
  if (rows <= 0 || d <= 0) return rows == 0 ? 0 : (int)cudaErrorInvalidValue;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32 && scale_dtype == kF32)
    return (int)launch<float, float>(x, scale, out, rows, d, eps, s);
  if (x_dtype == kF32 && scale_dtype == kBF16)
    return (int)launch<float, __nv_bfloat16>(x, scale, out, rows, d, eps, s);
  if (x_dtype == kBF16 && scale_dtype == kF32)
    return (int)launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, s);
  if (x_dtype == kBF16 && scale_dtype == kBF16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
