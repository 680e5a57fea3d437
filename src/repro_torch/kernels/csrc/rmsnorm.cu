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
// bf16, >= 26 us; 176 MB in f32). dx is per row; dscale sums over every row,
// which blocks cannot carry between them. Design (rmsnorm_bwd_kernel): a
// persistent grid of at most a few blocks an SM, block b taking rows b, b +
// grid, ...; each thread owns the same VPT 16-byte units of every row (8 bf16
// or 4 f32 each; single elements where d is not a multiple of a unit), chosen
// so that about 16 elements a thread cover the row (d = 3584: 224 threads x 2
// bf16 units or x 4 f32 units, no thread idle; rows past 8192 f32 or 16384
// bf16 elements would take 8 units a thread, which spills registers, and take
// the wide path below instead). A thread keeps (1 + scale) and
// its dscale partials for its columns in registers for the whole run, and a
// row's x and dy in registers from the load to the dx store, so device memory
// sees one read of each; the next row's x and dy load while this row is
// reduced. One barrier a row: the two row sums go through a shared-memory
// stage in two halves used on alternate rows. At the end each block writes its
// partials as one row of an f32 [grid, d] buffer, and rmsnorm_dscale_kernel
// sums that buffer down its columns (8 warps a 32-column strip, then the 8
// partial sums) in a fixed order: no atomics, dscale the same bits every run.
// Rows too wide for that (past 8192 f32 or 16384 bf16 elements in 16-byte units,
// 4096 single elements: nemotron-4-340b's d = 18432 in f32 would need 576
// threads of 8 units, in bf16 288 threads of 8 units that spill) take
// rmsnorm_bwd_wide_kernel: 512 threads walk a row's units twice,
// once for the two row sums and once for dx (the second read of x and dy,
// 147 KB at d = 18432 in f32, comes mostly from L2), and the block's dscale
// partials stay in shared memory (d floats, up to 49152), each column owned by
// one thread, so every sum still runs in a fixed order and dscale keeps the
// same bits every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kBwdMaxThreads = 512;  // threads of a backward block at most
constexpr int kWideThreads = 512;    // threads of a wide-row backward block
constexpr int kWideMaxD = 49152;     // widest row of the wide path (192 KB of partials)

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

// The backward's row pass (see the header): VPT units a thread, a unit being
// 16 bytes of the row (kVec) or one element; units past the row are zeros.
template <typename T, typename S, bool kVec, int VPT>
__global__ void __launch_bounds__(kBwdMaxThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ partial, long long rows, int d,
                   float eps) {
  constexpr int PER = kVec ? 16 / sizeof(T) : 1;  // elements a unit
  constexpr int E = VPT * PER;                     // elements a thread
  __shared__ float2 red[2][32];                    // the row sums, alternate rows
  const int units = kVec ? d / PER : d;
  const int nt = blockDim.x, nw = nt >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float w[E], ds[E];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int u = threadIdx.x + j * nt;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      w[j * PER + e] = u < units ? 1.f + to_f32(scale[u * PER + e]) : 0.f;
      ds[j * PER + e] = 0.f;
    }
  }
  // this thread's units of row `row` (zeros past the row)
  auto load = [&](long long row, uint4 (&xv)[VPT], uint4 (&gv)[VPT]) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int u = threadIdx.x + j * nt;
      xv[j] = gv[j] = make_uint4(0u, 0u, 0u, 0u);
      if (u < units) {
        if (kVec) {
          xv[j] = reinterpret_cast<const uint4*>(xr)[u];
          gv[j] = reinterpret_cast<const uint4*>(gr)[u];
        } else {
          *reinterpret_cast<T*>(&xv[j]) = xr[u];
          *reinterpret_cast<T*>(&gv[j]) = gr[u];
        }
      }
    }
  };

  uint4 xn[VPT], gn[VPT];  // the next row's units, in flight
  long long row = blockIdx.x;
  if (row < rows) load(row, xn, gn);
  for (int it = 0; row < rows; row += gridDim.x, ++it) {
    uint4 xc[VPT], gc[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      xc[j] = xn[j];
      gc[j] = gn[j];
    }
    if (row + gridDim.x < rows) load(row + gridDim.x, xn, gn);
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const T* xe = reinterpret_cast<const T*>(&xc[j]);
      const T* ge = reinterpret_cast<const T*>(&gc[j]);
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const float xf = to_f32(xe[e]);
        ss = fmaf(xf, xf, ss);
        gx = fmaf(to_f32(ge[e]) * w[j * PER + e], xf, gx);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      gx += __shfl_xor_sync(0xffffffffu, gx, o);
    }
    // stage `it & 1` was last read two rows ago, before the previous barrier
    float2* stage = red[it & 1];
    if (lane == 0) stage[warp] = make_float2(ss, gx);
    __syncthreads();
    float2 sums = make_float2(0.f, 0.f);
    for (int i = 0; i < nw; ++i) {  // the same order in every thread
      sums.x += stage[i].x;
      sums.y += stage[i].y;
    }
    const float inv = rsqrtf(sums.x / (float)d + eps);
    const float c = sums.y / (float)d * inv * inv * inv;
    T* dxr = dx + row * d;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int u = threadIdx.x + j * nt;
      const T* xe = reinterpret_cast<const T*>(&xc[j]);
      const T* ge = reinterpret_cast<const T*>(&gc[j]);
      uint4 oraw;
      T* oe = reinterpret_cast<T*>(&oraw);
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const float xf = to_f32(xe[e]), gf = to_f32(ge[e]);
        oe[e] = from_f32<T>(inv * gf * w[j * PER + e] - xf * c);
        ds[j * PER + e] = fmaf(gf, xf * inv, ds[j * PER + e]);
      }
      if (u < units) {
        if (kVec)
          reinterpret_cast<uint4*>(dxr)[u] = oraw;
        else
          dxr[u] = oe[0];
      }
    }
  }
  float* part = partial + (long long)blockIdx.x * d;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int u = threadIdx.x + j * nt;
    if (u < units)
#pragma unroll
      for (int e = 0; e < PER; ++e) part[u * PER + e] = ds[j * PER + e];
  }
}

// The backward's row pass for wide rows (see the header): each thread takes
// units u = threadIdx.x + j * blockDim.x of every row, twice a row; the
// block's dscale partials live in shared memory, column u * PER + e owned by
// the thread of unit u; at the end they become the block's row of partials.
template <typename T, typename S, bool kVec>
__global__ void __launch_bounds__(kWideThreads)
rmsnorm_bwd_wide_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ partial, long long rows, int d, float eps) {
  constexpr int PER = kVec ? 16 / sizeof(T) : 1;  // elements a unit
  extern __shared__ float ds_s[];                  // [d]: this block's dscale partials
  __shared__ float2 red[2][32];                    // the row sums, alternate rows
  const int units = kVec ? d / PER : d;
  const int nt = blockDim.x, nw = nt >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int u = threadIdx.x; u < units; u += nt)
#pragma unroll
    for (int e = 0; e < PER; ++e) ds_s[u * PER + e] = 0.f;
  // unit u of a row, as PER elements of x and of dy
  auto load = [&](const T* xr, const T* gr, int u, uint4& xv, uint4& gv) {
    if (kVec) {
      xv = reinterpret_cast<const uint4*>(xr)[u];
      gv = reinterpret_cast<const uint4*>(gr)[u];
    } else {
      *reinterpret_cast<T*>(&xv) = xr[u];
      *reinterpret_cast<T*>(&gv) = gr[u];
    }
  };
  int it = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x, ++it) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    float ss = 0.f, gx = 0.f;
    for (int u = threadIdx.x; u < units; u += nt) {
      uint4 xv, gv;
      load(xr, gr, u, xv, gv);
      const T* xe = reinterpret_cast<const T*>(&xv);
      const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const float xf = to_f32(xe[e]);
        ss = fmaf(xf, xf, ss);
        gx = fmaf(to_f32(ge[e]) * (1.f + to_f32(scale[u * PER + e])), xf, gx);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      gx += __shfl_xor_sync(0xffffffffu, gx, o);
    }
    // stage `it & 1` was last read two rows ago, before the previous barrier
    float2* stage = red[it & 1];
    if (lane == 0) stage[warp] = make_float2(ss, gx);
    __syncthreads();
    float2 sums = make_float2(0.f, 0.f);
    for (int i = 0; i < nw; ++i) {  // the same order in every thread
      sums.x += stage[i].x;
      sums.y += stage[i].y;
    }
    const float inv = rsqrtf(sums.x / (float)d + eps);
    const float c = sums.y / (float)d * inv * inv * inv;
    T* dxr = dx + row * d;
    for (int u = threadIdx.x; u < units; u += nt) {
      uint4 xv, gv, oraw;
      load(xr, gr, u, xv, gv);
      const T* xe = reinterpret_cast<const T*>(&xv);
      const T* ge = reinterpret_cast<const T*>(&gv);
      T* oe = reinterpret_cast<T*>(&oraw);
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const float xf = to_f32(xe[e]), gf = to_f32(ge[e]);
        const float w = 1.f + to_f32(scale[u * PER + e]);
        oe[e] = from_f32<T>(inv * gf * w - xf * c);
        ds_s[u * PER + e] = fmaf(gf, xf * inv, ds_s[u * PER + e]);
      }
      if (kVec)
        reinterpret_cast<uint4*>(dxr)[u] = oraw;
      else
        dxr[u] = oe[0];
    }
  }
  float* part = partial + (long long)blockIdx.x * d;
  for (int u = threadIdx.x; u < units; u += nt)
#pragma unroll
    for (int e = 0; e < PER; ++e) part[u * PER + e] = ds_s[u * PER + e];
}

// dscale[col] = sum over the nblk rows of partial, in a fixed order: warp ty
// of a 32-column strip sums rows ty, ty + 8, ..., then warp 0 the 8 sums
template <typename S>
__global__ void __launch_bounds__(256)
rmsnorm_dscale_kernel(const float* __restrict__ partial, S* __restrict__ dscale, int nblk, int d) {
  __shared__ float sums[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + tx;
  float acc = 0.f;
  if (col < d) {
#pragma unroll 4
    for (int b = ty; b < nblk; b += 8) acc += partial[(long long)b * d + col];
  }
  sums[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < d) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) total += sums[i][tx];
    dscale[col] = from_f32<S>(total);
  }
}

template <typename T, typename S, bool kVec, int VPT>
cudaError_t launch_bwd_vpt(const void* x, const void* scale, const void* dy, void* dx,
                           void* dscale, float* partial, long long rows, int d, float eps,
                           int threads, int max_blocks, cudaStream_t stream) {
  const auto kernel = rmsnorm_bwd_kernel<T, S, kVec, VPT>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return err;
  // every block resident at once: the grid is one wave
  const long long resident = (long long)(per_sm > 1 ? per_sm : 1) * sms;
  const long long cap = max_blocks < resident ? max_blocks : resident;
  const long long nblk = rows < cap ? rows : cap;
  kernel<<<(unsigned)nblk, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, rows, d, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_dscale_kernel<S><<<(unsigned)((d + 31) / 32), 256, 0, stream>>>(
      partial, static_cast<S*>(dscale), (int)nblk, d);
  return cudaGetLastError();
}

template <typename T, typename S, bool kVec>
cudaError_t launch_bwd_wide(const void* x, const void* scale, const void* dy, void* dx,
                            void* dscale, float* partial, long long rows, int d, float eps,
                            int max_blocks, cudaStream_t stream) {
  const auto kernel = rmsnorm_bwd_wide_kernel<T, S, kVec>;
  const size_t smem = (size_t)d * sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWideThreads, smem);
  if (err != cudaSuccess) return err;
  // every block resident at once: the grid is one wave
  const long long resident = (long long)(per_sm > 1 ? per_sm : 1) * sms;
  const long long cap = max_blocks < resident ? max_blocks : resident;
  const long long nblk = rows < cap ? rows : cap;
  kernel<<<(unsigned)nblk, kWideThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, rows, d, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_dscale_kernel<S><<<(unsigned)((d + 31) / 32), 256, 0, stream>>>(
      partial, static_cast<S*>(dscale), (int)nblk, d);
  return cudaGetLastError();
}

// The units a thread takes: about 16 elements (2 bf16 or 4 f32 units, 8
// single elements), fewer for short rows so that at least 64 threads share
// a row, more where the row would need more than kBwdMaxThreads; 0 if even 8
// units a thread leave too many threads.
inline int bwd_units_per_thread(int units, int per) {
  int vpt = per > 1 ? 16 / per : 8;
  while (vpt > 1 && (units + vpt - 1) / vpt < 64) vpt /= 2;
  while (vpt < 8 && (units + vpt - 1) / vpt > kBwdMaxThreads) vpt *= 2;
  return (units + vpt - 1) / vpt > kBwdMaxThreads ? 0 : vpt;
}

template <typename T, typename S>
cudaError_t launch_bwd(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
                       float* partial, long long rows, int d, float eps, int max_blocks,
                       cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && (((uintptr_t)x | (uintptr_t)dy | (uintptr_t)dx) % 16) == 0;
  const int units = vec ? d / V : d;
  const int vpt = bwd_units_per_thread(units, vec ? V : 1);
  // too wide for the registers (no variant fits, or the 8-vector one,
  // which spills): the wide path
  if (vpt == 0 || (vec && vpt == 8)) {
    if (d > kWideMaxD) return cudaErrorInvalidValue;
    return vec ? launch_bwd_wide<T, S, true>(x, scale, dy, dx, dscale, partial, rows, d, eps,
                                             max_blocks, stream)
               : launch_bwd_wide<T, S, false>(x, scale, dy, dx, dscale, partial, rows, d, eps,
                                              max_blocks, stream);
  }
  const int threads = ((units + vpt - 1) / vpt + 31) / 32 * 32;
#define RMSNORM_BWD_CASE(VEC, N)                                                              \
  case N:                                                                                     \
    return launch_bwd_vpt<T, S, VEC, N>(x, scale, dy, dx, dscale, partial, rows, d, eps,      \
                                        threads, max_blocks, stream);
  if (vec) {
    switch (vpt) {
      RMSNORM_BWD_CASE(true, 1) RMSNORM_BWD_CASE(true, 2) RMSNORM_BWD_CASE(true, 4)
    }
  } else {
    switch (vpt) {
      RMSNORM_BWD_CASE(false, 1) RMSNORM_BWD_CASE(false, 2) RMSNORM_BWD_CASE(false, 4)
      RMSNORM_BWD_CASE(false, 8)
    }
  }
#undef RMSNORM_BWD_CASE
  return cudaErrorInvalidValue;
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
// of scale's dtype; partial: f32 [max_blocks, d] scratch (the row pass runs at
// most max_blocks blocks, one row of partials each). dtype codes as the
// forward. Rows of up to 16384 bf16 or 8192 f32 elements in 16-byte units
// (d a multiple of a unit, pointers on 16 bytes), else up to 4096 single
// elements, keep a row in registers; wider ones, up to 49152 elements, take
// the wide path; wider still return cudaErrorInvalidValue. Returns the first
// failing launch's cudaError_t (0 on success); the two kernels run
// asynchronously on `stream`.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                                 void* dscale, void* partial, long long rows, int d, float eps,
                                 int max_blocks, int x_dtype, int scale_dtype, void* stream) {
  if (rows <= 0 || d <= 0) return rows == 0 ? 0 : (int)cudaErrorInvalidValue;
  if (max_blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  if (x_dtype == kF32 && scale_dtype == kF32)
    return (int)launch_bwd<float, float>(x, scale, dy, dx, dscale, part, rows, d, eps,
                                         max_blocks, s);
  if (x_dtype == kF32 && scale_dtype == kBF16)
    return (int)launch_bwd<float, __nv_bfloat16>(x, scale, dy, dx, dscale, part, rows, d, eps,
                                                 max_blocks, s);
  if (x_dtype == kBF16 && scale_dtype == kF32)
    return (int)launch_bwd<__nv_bfloat16, float>(x, scale, dy, dx, dscale, part, rows, d, eps,
                                                 max_blocks, s);
  if (x_dtype == kBF16 && scale_dtype == kBF16)
    return (int)launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, scale, dy, dx, dscale, part, rows,
                                                         d, eps, max_blocks, s);
  return (int)cudaErrorInvalidValue;
}
