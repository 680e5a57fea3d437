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
//
// Backward (repro_rmsnorm_bwd): with r = rsqrt(mean(x^2) + eps) and g = dy (1 + scale),
//   dx = r g - x r^3 mean(g x),   dscale = sum over rows of dy x r.
// Bound on the card: bytes (x and dy read, dx written: 88 MB at [4096, 3584]
// bf16, >= 26 us). dx is per row; dscale sums over every row, which blocks
// cannot carry between them, so rmsnorm_bwd_kernel gives each block a run of
// rows and a shared-memory row of dscale partials (each column owned by one
// thread, no atomics) written to a [blocks, d] f32 buffer, and
// rmsnorm_dscale_kernel sums that buffer down its columns in a fixed order:
// dscale is the same from run to run. Loads are 16-byte vectors as in the
// forward; the second pass over a row re-reads it from L1/L2.
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

// Sums of two values over the block; every thread gets both.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red's previous readers are done
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 v = lane < (int)(blockDim.x >> 5) ? red[lane] : make_float2(0.f, 0.f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    }
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

template <typename T, typename S, bool kVec>
__global__ void rmsnorm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                                   const T* __restrict__ dy, T* __restrict__ dx,
                                   float* __restrict__ partial, long long rows, int d, float eps,
                                   int rows_per_block) {
  extern __shared__ float dsc[];  // [d]: this block's dscale partials
  __shared__ float2 red[33];
  constexpr int V = 16 / sizeof(T);
  constexpr int per = kVec ? V : 1;  // columns a unit
  const int units = kVec ? d / V : d;
  for (int u = threadIdx.x; u < units; u += blockDim.x)
    for (int j = 0; j < per; ++j) dsc[u * per + j] = 0.f;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  for (long long row = r0; row < r1; ++row) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    T* dxr = dx + row * d;
    float ss = 0.f, gx = 0.f;
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      uint4 xraw, graw;  // 16 bytes of the row, or one element in their first slot
      if (kVec) {
        xraw = reinterpret_cast<const uint4*>(xr)[u];
        graw = reinterpret_cast<const uint4*>(gr)[u];
      } else {
        *reinterpret_cast<T*>(&xraw) = xr[u];
        *reinterpret_cast<T*>(&graw) = gr[u];
      }
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* ge = reinterpret_cast<const T*>(&graw);
#pragma unroll
      for (int j = 0; j < per; ++j) {
        const float xf = to_f32(xe[j]);
        ss = fmaf(xf, xf, ss);
        gx = fmaf(to_f32(ge[j]) * (1.f + to_f32(scale[u * per + j])), xf, gx);
      }
    }
    const float2 sums = block_sum2(ss, gx, red);
    const float inv = rsqrtf(sums.x / (float)d + eps);
    const float c = sums.y / (float)d * inv * inv * inv;
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      uint4 xraw, graw, oraw;
      if (kVec) {
        xraw = reinterpret_cast<const uint4*>(xr)[u];
        graw = reinterpret_cast<const uint4*>(gr)[u];
      } else {
        *reinterpret_cast<T*>(&xraw) = xr[u];
        *reinterpret_cast<T*>(&graw) = gr[u];
      }
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* ge = reinterpret_cast<const T*>(&graw);
      T* oe = reinterpret_cast<T*>(&oraw);
#pragma unroll
      for (int j = 0; j < per; ++j) {
        const int col = u * per + j;
        const float xf = to_f32(xe[j]), gf = to_f32(ge[j]);
        oe[j] = from_f32<T>(inv * gf * (1.f + to_f32(scale[col])) - xf * c);
        dsc[col] = fmaf(gf, xf * inv, dsc[col]);
      }
      if (kVec)
        reinterpret_cast<uint4*>(dxr)[u] = oraw;
      else
        dxr[u] = oe[0];
    }
  }
  // each thread wrote only its own columns of dsc: no barrier before the copy
  for (int u = threadIdx.x; u < units; u += blockDim.x)
    for (int j = 0; j < per; ++j)
      partial[(long long)blockIdx.x * d + u * per + j] = dsc[u * per + j];
}

template <typename S>
__global__ void rmsnorm_dscale_kernel(const float* __restrict__ partial, S* __restrict__ dscale,
                                      int nblk, int d) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  float acc = 0.f;
  for (int b = 0; b < nblk; ++b) acc += partial[(long long)b * d + col];
  dscale[col] = from_f32<S>(acc);
}

template <typename T, typename S>
cudaError_t launch_bwd(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
                       float* partial, long long rows, int d, float eps, int rows_per_block,
                       int nblk, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && (((uintptr_t)x | (uintptr_t)dy | (uintptr_t)dx) % 16) == 0;
  const int units = vec ? d / V : d;
  int threads = ((units + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const size_t smem = sizeof(float) * (size_t)d;
  const auto kernel = vec ? rmsnorm_bwd_kernel<T, S, true> : rmsnorm_bwd_kernel<T, S, false>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)nblk, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, rows, d, eps, rows_per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_dscale_kernel<S><<<(unsigned)((d + 255) / 256), 256, 0, stream>>>(
      partial, static_cast<S*>(dscale), nblk, d);
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

// The backward: x, dy, dx: [rows, d] contiguous of x's dtype; scale, dscale: [d]
// of scale's dtype; partial: f32 [nblk, d] scratch, nblk = ceil(rows /
// rows_per_block) blocks of rows_per_block rows each. dtype codes as the
// forward. Returns the first failing launch's cudaError_t (0 on success).
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                                 void* dscale, void* partial, long long rows, int d, float eps,
                                 int rows_per_block, int nblk, int x_dtype, int scale_dtype,
                                 void* stream) {
  if (rows <= 0 || d <= 0) return rows == 0 ? 0 : (int)cudaErrorInvalidValue;
  if (rows_per_block <= 0 || nblk <= 0 || (long long)nblk * rows_per_block < rows ||
      d > 56 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  if (x_dtype == kF32 && scale_dtype == kF32)
    return (int)launch_bwd<float, float>(x, scale, dy, dx, dscale, part, rows, d, eps,
                                         rows_per_block, nblk, s);
  if (x_dtype == kF32 && scale_dtype == kBF16)
    return (int)launch_bwd<float, __nv_bfloat16>(x, scale, dy, dx, dscale, part, rows, d, eps,
                                                 rows_per_block, nblk, s);
  if (x_dtype == kBF16 && scale_dtype == kF32)
    return (int)launch_bwd<__nv_bfloat16, float>(x, scale, dy, dx, dscale, part, rows, d, eps,
                                                 rows_per_block, nblk, s);
  if (x_dtype == kBF16 && scale_dtype == kBF16)
    return (int)launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, scale, dy, dx, dscale, part, rows,
                                                         d, eps, rows_per_block, nblk, s);
  return (int)cudaErrorInvalidValue;
}
