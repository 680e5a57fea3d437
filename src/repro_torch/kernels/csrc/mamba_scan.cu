// Selective-scan recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t from a
// zero state, over a, b: [B, S, E, N] float32 (contiguous). Writes every state
// h_all [B, S, E, N] and the last one h_last [B, E, N].
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py::mamba_scan
// (`_scan_kernel`, pallas_call at :73), which walks the sequence in VMEM tiles
// of [chunk, block_e, N] with the state carried in registers.
//
// Bound on the card: bytes. Each element costs one fma and 12 bytes of traffic
// (a and b read once, h written once), so at falcon-mamba-7b's prefill shape
// [4, 1024, 8192, 16] the kernel moves 6.45 GB: >= 1.92 ms at 3.35 TB/s, while
// its 1.07e9 flops take 0.016 ms at the f32 rate. Design: one thread owns V
// consecutive (b, e, n) channels (V = 4 through 16-byte vectors when E*N and
// the pointers allow, else V = 1) and walks t = 0..S-1 with h = fmaf(a, h, b).
// Neighbouring threads own neighbouring channels, and the layout puts a step's
// channels next to each other, so every load and store of a warp is coalesced.
// The loads of U steps do not depend on h: they are issued together before
// the fmas, so each thread keeps 2*U requests in flight. a and b are read with
// streaming loads and h_all written with streaming stores: nothing is read
// twice, so nothing is worth keeping in L2. The sequence loop replaces the
// TPU's sequential grid. At the main shape B*E*N/V = 131,072 threads make 512
// blocks; ptxas gives the vector instance 86 registers, so 2 blocks fit an
// SM's register file and 264 blocks run at once: two waves, the second of
// 248 blocks. Offsets are 64-bit: a alone is 2.15 GB there.
//
// The backward (repro_mamba_scan_bwd), the port's own: the Pallas kernel has
// none and the reference differentiates its jnp scan. From the forward's a
// and h_all and the gradients dh_all, dh_last it runs the recurrence in
// reverse:
//   g_{S-1} = dh_all_{S-1} + dh_last,   g_t = dh_all_t + a_{t+1} g_{t+1},
//   da_t = g_t h_{t-1} (h_{-1} = 0, so da_0 = 0),   db_t = g_t.
// Bound on the card: bytes. Each element reads a, h_all and dh_all once and
// writes da and db once, 20 bytes, so at falcon-mamba-7b's training shape
// [4, 1024, 8192, 16] it moves 10.7 GB: >= 3.2 ms at 3.35 TB/s, against
// 0.016 ms of fmas. Design: the forward's layout walked backwards. One thread
// owns V consecutive channels (16-byte vectors where the pointers and E*N
// allow) and walks t = S-1 .. 0 with g = fmaf(a_{t+1}, g, dh_t); the loads of
// U steps (dh_t, a_t, h_{t-1}) do not depend on g and are issued together
// first, streaming, as the forward's. No two threads share a channel and
// nothing is reduced across threads, so the gradients are the same bits on
// every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ float ld(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float4 ld(const float4* p) { return __ldcs(p); }
__device__ __forceinline__ void st(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void st(float4* p, float4 v) { __stcs(p, v); }

__device__ __forceinline__ float step(float a, float h, float b) { return fmaf(a, h, b); }
__device__ __forceinline__ float mul(float a, float b) { return a * b; }
__device__ __forceinline__ float4 mul(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ void set_one(float& v) { v = 1.f; }
__device__ __forceinline__ void set_one(float4& v) { v = make_float4(1.f, 1.f, 1.f, 1.f); }
__device__ __forceinline__ float4 step(float4 a, float4 h, float4 b) {
  return make_float4(fmaf(a.x, h.x, b.x), fmaf(a.y, h.y, b.y), fmaf(a.z, h.z, b.z),
                     fmaf(a.w, h.w, b.w));
}

// a, b, h_all: [batch, seq, chans] viewed as vectors of V floats, chans = E*N
// (a multiple of V); h_last: [batch, chans].
template <int V>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const typename Vec<V>::T* __restrict__ a,
                  const typename Vec<V>::T* __restrict__ b,
                  typename Vec<V>::T* __restrict__ h_all,
                  typename Vec<V>::T* __restrict__ h_last,
                  int64_t batch, int64_t seq, int64_t chans) {
  using T = typename Vec<V>::T;
  const int64_t cv = chans / V;  // vectors per step
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= batch * cv) return;
  const int64_t bi = g / cv, r = g - bi * cv;
  const int64_t base = bi * seq * cv + r;
  T h{};  // the zero initial state
  int64_t t = 0;
  for (; t + kUnroll <= seq; t += kUnroll) {
    T av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = base + (t + u) * cv;
      av[u] = ld(a + off);
      bv[u] = ld(b + off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = step(av[u], h, bv[u]);
      st(h_all + base + (t + u) * cv, h);
    }
  }
  for (; t < seq; ++t) {
    const int64_t off = base + t * cv;
    h = step(ld(a + off), h, ld(b + off));
    st(h_all + off, h);
  }
  h_last[g] = h;
}

// a, h_all, dh_all, da, db: [batch, seq, chans] viewed as vectors of V
// floats; dh_last: [batch, chans]. The reverse scan of the header.
template <int V>
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_kernel(const typename Vec<V>::T* __restrict__ a,
                      const typename Vec<V>::T* __restrict__ h_all,
                      const typename Vec<V>::T* __restrict__ dh_all,
                      const typename Vec<V>::T* __restrict__ dh_last,
                      typename Vec<V>::T* __restrict__ da,
                      typename Vec<V>::T* __restrict__ db,
                      int64_t batch, int64_t seq, int64_t chans) {
  using T = typename Vec<V>::T;
  const int64_t cv = chans / V;  // vectors per step
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= batch * cv) return;
  const int64_t bi = g / cv, r = g - bi * cv;
  const int64_t base = bi * seq * cv + r;
  T grad = dh_last[g], a_next;  // g_{t+1}'s share of g_t is a_{t+1} g_{t+1}
  set_one(a_next);              // and g_{S-1} takes dh_last whole
  int64_t t = seq - 1;
  for (; t + 1 >= kUnroll; t -= kUnroll) {
    T av[kUnroll], dv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = base + (t - u) * cv;
      av[u] = ld(a + off);
      dv[u] = ld(dh_all + off);
      hv[u] = t - u > 0 ? ld(h_all + off - cv) : T{};
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = base + (t - u) * cv;
      grad = step(a_next, grad, dv[u]);
      st(db + off, grad);
      st(da + off, mul(grad, hv[u]));
      a_next = av[u];
    }
  }
  for (; t >= 0; --t) {
    const int64_t off = base + t * cv;
    grad = step(a_next, grad, ld(dh_all + off));
    st(db + off, grad);
    st(da + off, t > 0 ? mul(grad, ld(h_all + off - cv)) : T{});
    a_next = ld(a + off);
  }
}

template <int V>
cudaError_t launch(const void* a, const void* b, void* h_all, void* h_last, int64_t batch,
                   int64_t seq, int64_t chans, cudaStream_t stream) {
  using T = typename Vec<V>::T;
  const int64_t threads = batch * (chans / V);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  mamba_scan_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h_all),
      static_cast<T*>(h_last), batch, seq, chans);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_bwd(const void* a, const void* h_all, const void* dh_all,
                       const void* dh_last, void* da, void* db, int64_t batch, int64_t seq,
                       int64_t chans, cudaStream_t stream) {
  using T = typename Vec<V>::T;
  const int64_t threads = batch * (chans / V);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  mamba_scan_bwd_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(h_all), static_cast<const T*>(dh_all),
      static_cast<const T*>(dh_last), static_cast<T*>(da), static_cast<T*>(db), batch, seq,
      chans);
  return cudaGetLastError();
}

}  // namespace

// a, b, h_all: [batch, seq, chans] float32 contiguous, chans = E*N; h_last:
// [batch, chans]. Returns the launch's cudaError_t (0 on success); the kernel
// runs asynchronously on `stream`.
extern "C" int repro_mamba_scan(const void* a, const void* b, void* h_all, void* h_last,
                                long long batch, long long seq, long long chans,
                                void* stream) {
  if (batch < 0 || seq < 1 || chans < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || chans == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = chans % 4 == 0 && ((uintptr_t)a % 16) == 0 && ((uintptr_t)b % 16) == 0 &&
                   ((uintptr_t)h_all % 16) == 0 && ((uintptr_t)h_last % 16) == 0;
  if (vec) return (int)launch<4>(a, b, h_all, h_last, batch, seq, chans, s);
  return (int)launch<1>(a, b, h_all, h_last, batch, seq, chans, s);
}

// The backward: a, h_all (the forward's), dh_all, da, db: [batch, seq, chans]
// float32 contiguous; dh_last: [batch, chans]. Writes da and db; returns the
// launch's cudaError_t (0 on success); the kernel runs asynchronously on
// `stream`.
extern "C" int repro_mamba_scan_bwd(const void* a, const void* h_all, const void* dh_all,
                                    const void* dh_last, void* da, void* db, long long batch,
                                    long long seq, long long chans, void* stream) {
  if (batch < 0 || seq < 1 || chans < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || chans == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t ptrs = (uintptr_t)a | (uintptr_t)h_all | (uintptr_t)dh_all |
                         (uintptr_t)dh_last | (uintptr_t)da | (uintptr_t)db;
  if (chans % 4 == 0 && ptrs % 16 == 0)
    return (int)launch_bwd<4>(a, h_all, dh_all, dh_last, da, db, batch, seq, chans, s);
  return (int)launch_bwd<1>(a, h_all, dh_all, dh_last, da, db, batch, seq, chans, s);
}
