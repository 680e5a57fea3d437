// Fused RMSNorm for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * (1 + scale)
// over the last dimension, accumulated in f32, written in x's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (`_rmsnorm_kernel`, pallas_call at :40).
//
// Bound on the card: bytes. The norm does ~4 flops per element and must read x
// once and write out once: at gemma2-9b's prefill rows [4000, 3584] bf16 it
// moves 57 MB, >= 17 us at 3.35 TB/s; a decode step's [4, d] rows move a few
// KB and are bound by the launch and one round trip to memory. Design: a
// persistent grid, every block resident at once, block b taking rows b, b +
// grid, ...; a unit is 16 bytes of a row (8 bf16 or 4 f32) where d and the
// pointers allow, else one element (the scalar path). A row is held one of
// three ways, by its width:
// - up to 512 elements (rmsnorm_kernel<..., kWarp>): a warp a row, 8 rows a
//   block, each lane the least power of 2 of units that covers the row, the
//   sum by shuffles alone;
// - up to 512 threads of 16 elements, or of 32 past that (rmsnorm_kernel, the
//   block a row): each thread owns the same VPT units of every row, so the
//   main paths' widths (2560, 3584, 4096, 5120) fall evenly on 160-320
//   threads of 2 bf16 or 4 f32 units; its (1 + scale) stay in f32 registers
//   for the whole run, a row stays in registers from load to store (device
//   memory sees one read of x and one write of out), the next row's units
//   load while this row is reduced, and the warps' sums meet in a
//   shared-memory stage in two halves used on alternate rows: one barrier a
//   row;
// - wider (rmsnorm_smem_kernel: nemotron-4-340b's 18432, 576 threads of 32
//   elements): a row is staged whole in shared memory, in up to 3 buffers of
//   a row, by one 1-D bulk copy (TMA) that completes on an mbarrier, the
//   next rows' copies in flight while this row is reduced and written; each
//   thread reads its units from the buffer for the sum and again for the
//   output. Past 1024 threads of 32 elements (32768) 1024 threads walk the
//   row and read (1 + scale) each row; past two buffers (28928 f32, 57856
//   bf16 elements) one buffer is refilled after a second barrier a row.
// A row's sum runs in an order fixed by d, the dtype and the path, not by the
// grid or the block that takes the row: every call gives the same bits. Rows
// of up to 57856 elements in f32 and 115712 in bf16 (one row in shared
// memory).
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

#include <map>
#include <mutex>
#include <tuple>

#include "hopper.cuh"

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kNarrowD = 512;              // widest row that a warp takes
constexpr int kFwdWarpRows = 8;            // rows (warps) of a narrow-row block
constexpr int kFwdMaxThreads = 512;        // threads of a forward block in registers
constexpr int kFwdSmemMaxThreads = 1024;   // threads of a forward block in shared memory
constexpr int kFwdMaxBufs = 3;             // row buffers of a forward block in shared memory
constexpr size_t kFwdSmemBytes = 231424;   // their bytes at most (227 KB less 1 KB static)
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

// Sum over a warp; every lane gets the same bits (each step adds the same
// two values in every lane, and a + b == b + a).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (1 + scale) in f32 at this thread's units u = t + j * nt of a row, a unit
// being PER elements; zeros past the row. Read once a block, so one element
// at a time: scale may start anywhere.
template <typename S, int PER, int VPT>
__device__ __forceinline__ void load_weights(float (&w)[VPT * PER], const S* __restrict__ scale,
                                             int t, int nt, int units) {
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int u = t + j * nt;
#pragma unroll
    for (int e = 0; e < PER; ++e) w[j * PER + e] = u < units ? 1.f + to_f32(scale[u * PER + e]) : 0.f;
  }
}

// A unit of a row: 16 bytes (kVec: 8 bf16 or 4 f32), else one element.
template <typename T, bool kVec> struct Unit { using type = uint4; };
template <typename T> struct Unit<T, false> { using type = T; };

// Sum of squares of one unit's PER elements, added to ss in order.
template <typename T, int PER, typename U>
__device__ __forceinline__ float unit_squares(const U& raw, float ss) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const float f = to_f32(e[i]);
    ss = fmaf(f, f, ss);
  }
  return ss;
}

// x * inv * (1 + scale) of one unit, in x's type.
template <typename T, int PER, typename U>
__device__ __forceinline__ U unit_normed(const U& raw, float inv, const float* w) {
  const T* e = reinterpret_cast<const T*>(&raw);
  U res;
  T* r = reinterpret_cast<T*>(&res);
#pragma unroll
  for (int i = 0; i < PER; ++i) r[i] = from_f32<T>(to_f32(e[i]) * inv * w[i]);
  return res;
}

// The forward with a row in registers (see the header): each of a row's nt
// threads owns units u = t + j * nt, j < VPT, of every row it takes; a unit
// is 16 bytes (kVec) or one element. kWarp: a warp a row, the block's warps
// on rows of their own, the sum by shuffles alone; else the whole block a
// row, and the warps' sums meet in a shared-memory stage, one barrier a row.
template <typename T, typename S, bool kVec, int VPT, bool kWarp>
__global__ void __launch_bounds__(kFwdMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out,
               long long rows, int d, float eps) {
  constexpr int PER = kVec ? 16 / sizeof(T) : 1;  // elements a unit
  __shared__ float red[2][32];                     // block rows: the warps' sums, alternate rows
  const int units = kVec ? d / PER : d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int t = kWarp ? lane : threadIdx.x;  // this thread's place in its row
  const int nt = kWarp ? 32 : blockDim.x;    // threads a row
  const long long step = kWarp ? (long long)gridDim.x * nw : gridDim.x;
  using U = typename Unit<T, kVec>::type;
  // this thread's units of row `row` (zeros past the row)
  auto load = [&](long long row, U (&xv)[VPT]) {
    const U* xr = reinterpret_cast<const U*>(x + row * d);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int u = t + j * nt;
      xv[j] = u < units ? xr[u] : U{};
    }
  };

  U xn[VPT];  // the next row's units, in flight
  long long row = kWarp ? (long long)blockIdx.x * nw + warp : blockIdx.x;
  if (row < rows) load(row, xn);  // the first row's loads go out before the weights'
  float w[VPT * PER];
  load_weights<S, PER, VPT>(w, scale, t, nt, units);
  for (int it = 0; row < rows; row += step, ++it) {
    U xc[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) xc[j] = xn[j];
    if (row + step < rows) load(row + step, xn);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) ss = unit_squares<T, PER>(xc[j], ss);
    ss = warp_sum(ss);
    if (!kWarp) {
      // stage `it & 1` was last read two rows ago, before the previous barrier
      float* stage = red[it & 1];
      if (lane == 0) stage[warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int i = 0; i < nw; ++i) ss += stage[i];  // the same order in every thread
    }
    const float inv = rsqrtf(ss / (float)d + eps);
    T* outr = out + row * d;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int u = t + j * nt;
      if (u < units) reinterpret_cast<U*>(outr)[u] = unit_normed<T, PER>(xc[j], inv, &w[j * PER]);
    }
  }
}

// Stages row `xr` in shared memory at `dst`: 16-byte rows by one bulk copy
// that thread 0 starts and that completes on `bar`; other rows by each
// thread copying its own elements (VPT of them, or every nt-th where VPT is
// 0), which no other thread reads.
template <typename T, bool kVec, int VPT>
__device__ __forceinline__ void stage_row(unsigned char* dst, const T* xr, uint32_t row_bytes,
                                          uint64_t* bar, int units, int nt) {
  if (kVec) {
    if (threadIdx.x == 0) {
      const uint32_t b = hopper::smem_u32(bar);
      hopper::mbar_expect_tx(b, row_bytes);
      hopper::bulk_load(hopper::smem_u32(dst), xr, row_bytes, b);
    }
  } else if (VPT > 0) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int u = threadIdx.x + j * nt;
      if (u < units) reinterpret_cast<T*>(dst)[u] = xr[u];
    }
  } else {
    for (int u = threadIdx.x; u < units; u += nt) reinterpret_cast<T*>(dst)[u] = xr[u];
  }
}

// The forward for rows too wide for the registers (see the header): block b
// takes rows b, b + grid, ...; each row is staged whole (stage_row) in one of
// nbuf shared-memory buffers, nbuf - 1 rows ahead (with one buffer, after a
// second barrier a row). Each thread owns units u = threadIdx.x + j *
// blockDim.x, j < VPT, and holds their (1 + scale) in registers, or, where
// VPT is 0 (rows past 32 elements a thread), every blockDim.x-th unit, its
// (1 + scale) read from scale each row. It reads its units from the buffer
// once for the sum and once for the output.
template <typename T, typename S, bool kVec, int VPT>
__global__ void __launch_bounds__(kFwdSmemMaxThreads)
rmsnorm_smem_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out,
                    long long rows, int d, float eps, int nbuf) {
  constexpr int PER = kVec ? 16 / sizeof(T) : 1;  // elements a unit
  extern __shared__ __align__(128) unsigned char rows_s[];  // nbuf buffers of a row each
  __shared__ __align__(8) uint64_t full[kFwdMaxBufs];        // kVec: buffer b's copy has landed
  __shared__ float red[2][32];                               // the warps' sums, alternate rows
  const int units = kVec ? d / PER : d;
  const uint32_t row_bytes = (uint32_t)d * sizeof(T);
  const int nt = blockDim.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = nt >> 5;
  const long long step = gridDim.x;
  using U = typename Unit<T, kVec>::type;
  if (kVec && threadIdx.x == 0) {
    for (int k = 0; k < nbuf; ++k) hopper::mbar_init(hopper::smem_u32(&full[k]), 1);
    hopper::fence_barrier_init();
  }
  // the first rows' copies go out before the weights' loads
  for (int k = 0; k < (nbuf > 1 ? nbuf - 1 : 1) && blockIdx.x + k * step < rows; ++k)
    stage_row<T, kVec, VPT>(rows_s + (size_t)k * row_bytes, x + (blockIdx.x + k * step) * d,
                            row_bytes, &full[k], units, nt);
  __syncthreads();  // the barriers' initialisation, before any thread waits on them
  float w[VPT > 0 ? VPT * PER : 1];
  if constexpr (VPT > 0) load_weights<S, PER, VPT>(w, scale, threadIdx.x, nt, units);
  int b = 0;
  uint32_t parity = 0;  // of buffer b's copy this round
  int it = 0;
  for (long long row = blockIdx.x; row < rows; row += step, ++it) {
    if (kVec) hopper::mbar_wait(hopper::smem_u32(&full[b]), parity);
    const U* buf = reinterpret_cast<const U*>(rows_s + (size_t)b * row_bytes);
    float ss = 0.f;
    if constexpr (VPT > 0) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int u = threadIdx.x + j * nt;
        if (u < units) ss = unit_squares<T, PER>(buf[u], ss);
      }
    } else {
      for (int u = threadIdx.x; u < units; u += nt)
        ss = unit_squares<T, PER>(buf[u], ss);
    }
    ss = warp_sum(ss);
    float* stage = red[it & 1];  // last read two rows ago, before the previous barrier
    if (lane == 0) stage[warp] = ss;
    __syncthreads();
    // every thread is done with the buffer of the row before: refill it,
    // nbuf - 1 rows ahead of this one
    if (nbuf > 1 && row + (nbuf - 1) * step < rows) {
      const int k = b == 0 ? nbuf - 1 : b - 1;
      stage_row<T, kVec, VPT>(rows_s + (size_t)k * row_bytes, x + (row + (nbuf - 1) * step) * d,
                              row_bytes, &full[k], units, nt);
    }
    ss = 0.f;
    for (int i = 0; i < nw; ++i) ss += stage[i];  // the same order in every thread
    const float inv = rsqrtf(ss / (float)d + eps);
    U* outr = reinterpret_cast<U*>(out + row * d);
    if constexpr (VPT > 0) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int u = threadIdx.x + j * nt;
        if (u < units) outr[u] = unit_normed<T, PER>(buf[u], inv, &w[j * PER]);
      }
    } else {
      for (int u = threadIdx.x; u < units; u += nt) {
        float wu[PER];
#pragma unroll
        for (int e = 0; e < PER; ++e) wu[e] = 1.f + to_f32(scale[u * PER + e]);
        outr[u] = unit_normed<T, PER>(buf[u], inv, wu);
      }
    }
    if (nbuf == 1) {
      __syncthreads();  // every thread is done with the one buffer
      if (row + step < rows)
        stage_row<T, kVec, VPT>(rows_s, x + (row + step) * d, row_bytes, &full[0], units, nt);
    }
    if (++b == nbuf) {
      b = 0;
      parity ^= 1u;
    }
  }
}

// Blocks of `kernel` at `threads` and `smem` bytes that are resident at
// once on the current card, at most `cap`: a persistent grid is one wave.
// Found once for each kernel, block shape and card, then read from a table
// under a lock (pool threads launch concurrently), so that a launch costs
// no occupancy query.
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, size_t smem, long long cap, long long* nblk) {
  static std::mutex lock;
  static std::map<std::tuple<const void*, int, size_t, int>, long long> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), threads, smem, dev);
  std::lock_guard<std::mutex> hold(lock);
  auto it = known.find(key);
  if (it == known.end()) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    it = known.emplace(key, (long long)(per_sm > 1 ? per_sm : 1) * sms).first;
  }
  *nblk = cap < it->second ? cap : it->second;
  return cudaSuccess;
}

template <typename T, typename S, bool kVec, int VPT, bool kWarp>
cudaError_t launch_vpt(const void* x, const void* scale, void* out, long long rows, int d,
                       float eps, int threads, cudaStream_t stream) {
  const auto kernel = rmsnorm_kernel<T, S, kVec, VPT, kWarp>;
  const long long groups = kWarp ? (rows + threads / 32 - 1) / (threads / 32) : rows;
  long long nblk = 0;
  cudaError_t err = resident_blocks(kernel, threads, 0, groups, &nblk);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)nblk, threads, 0, stream>>>(static_cast<const T*>(x),
                                                  static_cast<const S*>(scale),
                                                  static_cast<T*>(out), rows, d, eps);
  return cudaGetLastError();
}

template <typename T, typename S, bool kVec, int VPT>
cudaError_t launch_smem_vpt(const void* x, const void* scale, void* out, long long rows, int d,
                            float eps, int threads, int nbuf, cudaStream_t stream) {
  const auto kernel = rmsnorm_smem_kernel<T, S, kVec, VPT>;
  const size_t smem = nbuf * (size_t)d * sizeof(T);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  long long nblk = 0;
  if (err == cudaSuccess) err = resident_blocks(kernel, threads, smem, rows, &nblk);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)nblk, threads, smem, stream>>>(static_cast<const T*>(x),
                                                     static_cast<const S*>(scale),
                                                     static_cast<T*>(out), rows, d, eps, nbuf);
  return cudaGetLastError();
}

// Rows staged in shared memory: 32 elements a thread, or, past
// kFwdSmemMaxThreads such threads, kFwdSmemMaxThreads threads that walk the
// row; as many row buffers as fit, up to kFwdMaxBufs.
template <typename T, typename S, bool kVec>
cudaError_t launch_smem(const void* x, const void* scale, void* out, long long rows, int d,
                        float eps, cudaStream_t stream) {
  constexpr int PER = kVec ? 16 / sizeof(T) : 1, VPT = 32 / PER;
  const int units = d / PER;
  const size_t row_bytes = (size_t)d * sizeof(T);
  int nbuf = (int)(kFwdSmemBytes / row_bytes);
  nbuf = nbuf > kFwdMaxBufs ? kFwdMaxBufs : nbuf;
  if (nbuf < 1) return cudaErrorInvalidValue;
  const int threads = ((units + VPT - 1) / VPT + 31) / 32 * 32;
  if (threads <= kFwdSmemMaxThreads)
    return launch_smem_vpt<T, S, kVec, VPT>(x, scale, out, rows, d, eps, threads, nbuf, stream);
  return launch_smem_vpt<T, S, kVec, 0>(x, scale, out, rows, d, eps, kFwdSmemMaxThreads, nbuf,
                                        stream);
}

// The forward's path and shape for a row (see the header): a warp a row up
// to kNarrowD elements, the block a row in registers while at most
// kFwdMaxThreads threads of at most 32 elements cover it, else the row
// staged in shared memory.
template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* out, long long rows, int d, float eps,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && (((uintptr_t)x | (uintptr_t)out) % 16) == 0;
  const int per = vec ? V : 1;
  const int units = vec ? d / V : d;
#define RMSNORM_CASE(VEC, N, WARP)                                                       \
  case N:                                                                                \
    return launch_vpt<T, S, VEC, N, WARP>(x, scale, out, rows, d, eps, threads, stream);
  if (d <= kNarrowD) {  // a warp a row, VPT the least power of 2 that covers it
    const int threads = kFwdWarpRows * 32;
    int vpt = 1;
    while (vpt * 32 < units) vpt *= 2;
    if (vec) {
      switch (vpt) { RMSNORM_CASE(true, 1, true) RMSNORM_CASE(true, 2, true) RMSNORM_CASE(true, 4, true) }
    } else {
      switch (vpt) {
        RMSNORM_CASE(false, 1, true) RMSNORM_CASE(false, 2, true) RMSNORM_CASE(false, 4, true)
        RMSNORM_CASE(false, 8, true) RMSNORM_CASE(false, 16, true)
      }
    }
    return cudaErrorInvalidValue;
  }
  int vpt = 16 / per;  // 16 elements a thread, or 32 where that needs too many threads
  if ((units + vpt - 1) / vpt > kFwdMaxThreads) vpt *= 2;
  const int threads = ((units + vpt - 1) / vpt + 31) / 32 * 32;
  if (threads <= kFwdMaxThreads) {
    if (vec) {
      switch (vpt) {
        RMSNORM_CASE(true, 2, false) RMSNORM_CASE(true, 4, false) RMSNORM_CASE(true, 8, false)
      }
    } else {
      switch (vpt) { RMSNORM_CASE(false, 16, false) RMSNORM_CASE(false, 32, false) }
    }
    return cudaErrorInvalidValue;
  }
#undef RMSNORM_CASE
  return vec ? launch_smem<T, S, true>(x, scale, out, rows, d, eps, stream)
             : launch_smem<T, S, false>(x, scale, out, rows, d, eps, stream);
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
  long long nblk = 0;
  cudaError_t err =
      resident_blocks(kernel, threads, 0, rows < max_blocks ? rows : max_blocks, &nblk);
  if (err != cudaSuccess) return err;
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
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  long long nblk = 0;
  if (err == cudaSuccess)
    err = resident_blocks(kernel, kWideThreads, smem, rows < max_blocks ? rows : max_blocks,
                          &nblk);
  if (err != cudaSuccess) return err;
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
// Rows of up to 57856 elements in f32, 115712 in bf16; wider return
// cudaErrorInvalidValue.
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
