// Forward flash attention for Hopper (sm_90a): blocked causal attention with an
// online softmax, GQA, tanh logit softcap and a sliding window.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (kernel body :54-91, pallas_call at :93). Same arithmetic: scores scaled by
// 1/sqrt(D), softcap before the mask, top-left causal mask (q_pos starts at 0 even
// when Sq != Sk), window rule q - k < w, f32 accumulation, output in q's type.
// Masked scores count for nothing (the reference's -1e30 underflows to a weight
// of 0); a row that sees no key at all writes zeros (the reference would average
// V over the masked keys). K tiles outside the causal diagonal and left of the
// window are skipped (the loop bounds of flash_attention.py:84-86).
//
// Bound on the card: at gemma2-9b prefill, (B, Hq, Hkv, S, D) = (4, 16, 8, 1000, 256)
// causal, it reads q, k, v and writes o (~98 MB, >= 29 us at 3.35 TB/s) and does
// ~3.3e10 flops (>= 33 us at 989 TFLOP/s in bf16), so operations bound it: only
// the tensor cores, through wgmma, come near that rate. Two routes, by dtype:
//
// bfloat16: tensor cores (flash_tc_kernel). One block of three warpgroups per
// (q tile of 128 rows, q head, batch), q tiles ordered so that the heaviest (the
// bottom of the causal triangle) start first. Warpgroup 0 is the producer: it
// gives up registers (setmaxnreg 24) and one thread issues TMA loads, Q once and
// K, V tiles of BK keys (128 at D <= 128, 64 at D = 256) into a 2-stage ring with
// full barriers per stage for K and for V and an empty barrier per stage.
// Warpgroups 1 and 2 take 240 registers each and own 64 q rows apiece. Per K tile:
//   S = Q K^T  wgmma m64nBKk16 from shared memory, both operands K-major under
//              the 128-byte swizzle (64-byte at D = 32);
//   softmax    on the accumulator fragment in registers: scale, softcap
//              (cap * tanh(x / cap) as cap * (1 - 2 / (exp(2x / cap) + 1)), since
//              tanh.approx's 2^-11 error would move logits by up to cap * 2^-11),
//              the mask only on tiles that cross the diagonal, the window's edge
//              or the ragged Sk tail (as per-row key bounds), online row max and
//              sum in log2 units (two shuffles a row);
//   O += P V   P converted to bf16 in registers and fed to wgmma as its A
//              operand (the accumulator of two n8 chunks is the A fragment of
//              one k16 slice), V from shared memory MN-major (the transpose
//              bit); O stays in registers (64 x D f32: 128 a thread at D = 256).
// The softcap is a template parameter, so the uncapped kernel carries none of it.
// Shared memory: Q 128 x D, K and V 2 x BK x D, all bf16 (192 KB at D = 256,
// 160 KB at D = 128): one block an SM, its two consumer warpgroups keeping the
// tensor cores busy in turn. Operands are described to TMA as 4-d (D, S, H, B)
// with their own strides, so a ragged tile reads zeros past S inside its head
// and the output's TMA store clips it. The epilogue divides by l, converts to
// bf16, stages the tile in its own Q rows (swizzled) and stores it with TMA.
// The wgmma, TMA and mbarrier helpers live in hopper.cuh.
//
// float32: the CUDA-core kernel (flash_fwd_kernel), exact to f32 rounding
// (tensor cores would round its inputs to TF32). One block of 256 threads per
// (q tile of 64 rows, q head, batch). The Q tile is staged once in shared memory
// as f32 (pre-scaled); K and V stream through shared memory 32 keys at a time
// (137 KB of dynamic shared memory at D = 256). Thread (ty, tx) of a 16 x 16 grid
// owns q rows ty*4..ty*4+3: for S = QK^T it computes keys tx and tx+16, for
// O += PV head dims tx + 16j. The 16 threads sharing a row group sit in one
// half-warp, so row max and row sum are reduced with shuffles and the running
// (m, l) stay in registers. Rows of Q and K are padded by one float so the
// half-warp reads 16 distinct banks. Ragged Sq and Sk tails are masked
// (zero-filled tiles, k < Sk in the mask). Masked scores are -1e30. The kv head
// of q head h is h / (Hq / Hkv).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

// the CUDA-core route (float32)
constexpr int BQ = 64;        // q rows per block
constexpr int BK = 32;        // keys per K/V tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
                          (size_t)BQ * (BK + 1));
}

struct Strides {  // element strides of one [B, H, S, D] operand (D stride is 1)
  long long b, h, s;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int Hq, int Hkv, int Sq, int Sk, Strides qs, Strides ks,
                 Strides vs, int causal, int window, float softcap, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);          // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);          // [BK][D]
  float* Ps = Vs + BK * D;                // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int qr = q0 + r;
    Qs[r * (D + 1) + c] = qr < Sq ? to_f32(qb[qr * qs.s + c]) * scale : 0.f;
  }

  constexpr int DJ = D / 16;
  float acc[4][DJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // block pruning: causal upper bound at the diagonal, window lower bound at
  // the oldest key the first row of the tile can see
  const int nk = (Sk + BK - 1) / BK;
  int hi = nk;
  if (causal) hi = min(hi, (q0 + BQ + BK - 1) / BK);
  int lo = 0;
  if (window > 0) lo = max(q0 - window + 1, 0) / BK;

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's readers of Ks/Vs/Ps are done
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int kr = k0 + r;
      const bool in = kr < Sk;
      Ks[r * (D + 1) + c] = in ? to_f32(kb[kr * ks.s + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[kr * vs.s + c]) : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    const float* qrow = Qs + (ty * 4) * (D + 1);
    const float* k0row = Ks + tx * (D + 1);
    const float* k1row = Ks + (tx + 16) * (D + 1);
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kv0 = k0row[d], kv1 = k1row[d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = qrow[i * (D + 1) + d];
        s[i][0] = fmaf(qv, kv0, s[i][0]);
        s[i][1] = fmaf(qv, kv1, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        x = ok ? x : kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      const float p0 = expf(s[i][0] - m_new), p1 = expf(s[i][1] - m_new);
      float rs = p0 + p1;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
      Ps[(ty * 4 + i) * (BK + 1) + tx] = p0;
      Ps[(ty * 4 + i) * (BK + 1) + tx + 16] = p1;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * (BK + 1) + c];
      const float* vrow = Vs + c * D + tx;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = vrow[16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = o + ((long long)b * Hq + h) * (long long)Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[(long long)qr * D + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                   int Hkv, int Sq, int Sk, Strides qs, Strides ks, Strides vs, int causal,
                   int window, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap,
      1.f / sqrtf((float)D));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the tensor-core route (bfloat16)
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kTcRows = 128;     // q rows per block, 64 per consumer warpgroup
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tc {
  static constexpr int SPAN = D >= 64 ? 128 : 64;  // swizzle span, bytes
  static constexpr int CW = SPAN / 2;              // bf16 columns per chunk
  static constexpr int NC = D / CW;                // chunks per row
  static constexpr int BK = D >= 256 ? 64 : 128;   // keys per K/V tile
  static constexpr int Q_BYTES = kTcRows * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int Q_CHUNK = kTcRows * SPAN;   // bytes of one Q chunk
  static constexpr int KV_CHUNK = BK * SPAN;
  // Q, K ring, V ring, 7 barriers, and slack to align the tiles to 1024 B
  static constexpr size_t SMEM = Q_BYTES + 2 * kStages * KV_BYTES + 64 + 1024;
};

struct TcArgs {
  int Hq, Hkv, Sq, Sk, causal, window;
  float s_log2;    // 1/sqrt(D) * log2(e): score to log2 units (no softcap)
  float s_cap;     // 2/(sqrt(D) * cap) * log2(e): exponent of exp(2x) in tanh
  float cap_log2;  // cap * log2(e)
};

__device__ __forceinline__ float exp2_approx(float x) {  // 2^x, relative error ~2^-22
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The consumer warpgroups' half of the block: 64 q rows from `r0`.
template <int D, bool SOFTCAP>
__device__ __forceinline__ void tc_consume(const TcArgs& a, const CUtensorMap* to, uint32_t sQ,
                                           uint32_t sK, uint32_t sV, uint32_t bars,
                                           uint8_t* gQ, int cw, int q0, int h, int b,
                                           int kt_lo, int ntiles) {
  using C = Tc<D>;
  constexpr int BK = C::BK;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 64 * cw;
  const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
  const bool has_rows = r0 < a.Sq;
  const int r_last = min(r0 + 63, a.Sq - 1);
  // this warpgroup's keys: [lo_k, hi_k)
  const int lo_k = a.window > 0 ? max(r0 - a.window + 1, 0) : 0;
  const int hi_k = !has_rows ? 0 : a.causal ? min(a.Sk, r_last + 1) : a.Sk;

  const uint32_t q_full = bars;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  hopper::mbar_wait(q_full, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    const uint32_t k_full = bars + 8 + 8 * st, v_full = bars + 24 + 8 * st;
    const uint32_t empty = bars + 40 + 8 * st;
    const int k0 = (kt_lo + i) * BK;
    hopper::mbar_wait(k_full, ph);
    if (k0 < hi_k && k0 + BK > lo_k) {
      // S = Q K^T over D in k16 slices
      float s[BK / 2];
      const uint32_t kb = sK + st * C::KV_BYTES;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / (C::CW / 16), w = kk % (C::CW / 16);
        const uint64_t da = hopper::make_desc(sQ + c * C::Q_CHUNK + 64 * cw * C::SPAN + 32 * w,
                                              16, 8 * C::SPAN, C::SPAN);
        const uint64_t db = hopper::make_desc(kb + c * C::KV_CHUNK + 32 * w, 16, 8 * C::SPAN,
                                              C::SPAN);
        hopper::Wgmma<BK>::ss(s, da, db, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      // scores to log2 units: scale and softcap; the mask only on tiles that
      // cross the diagonal, the window's edge or the ragged Sk tail, each
      // row's visible keys being [k_lo, k_hi)
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        if (SOFTCAP) {
          // cap * tanh(x / (sqrt(D) cap)), tanh(u) = 1 - 2 / (exp(2u) + 1)
          const float ex = exp2_approx(s[e] * a.s_cap);
          s[e] = a.cap_log2 * (1.f - __fdividef(2.f, ex + 1.f));
        } else {
          s[e] *= a.s_log2;
        }
      }
      if (k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > r0) ||
          (a.window > 0 && r_last - k0 >= a.window)) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int k_hi = (a.causal ? min(a.Sk, row[r] + 1) : a.Sk) - k0 - 2 * t;
          const int k_lo = (a.window > 0 ? row[r] - a.window + 1 : INT_MIN / 2) - k0 - 2 * t;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int kp = 8 * j + c;  // key k0 + 2t + kp
              if (kp < k_lo || kp >= k_hi) s[4 * j + 2 * r + c] = -INFINITY;
            }
        }
      }
      // online softmax: each row's max over the quad of threads that hold it
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // nothing seen yet
        alpha[r] = exp2_approx(m[r] - m_use);
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          s[4 * j + 2 * r] = exp2_approx(s[4 * j + 2 * r] - m_use);
          s[4 * j + 2 * r + 1] = exp2_approx(s[4 * j + 2 * r + 1] - m_use);
          sum += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
        }
        l[r] = l[r] * alpha[r] + sum;  // this thread's columns; the quad sums at the end
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      // P as the bf16 A operand, one k16 slice per 8 accumulator entries
      uint32_t p[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // O += P V, V MN-major: chunks of SPAN bytes of D, LBO apart
      hopper::mbar_wait(v_full, ph);
      const uint32_t vb = sV + st * C::KV_BYTES;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = hopper::make_desc(vb + kk * 16 * C::SPAN, C::KV_CHUNK, 8 * C::SPAN,
                                              C::SPAN);
        hopper::Wgmma<D>::rs_tb(o, p[kk], db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
    } else {
      hopper::mbar_wait(v_full, ph);  // nothing to do here, but the stage is released in order
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty);
  }

  if (!has_rows) return;
  // epilogue: O / l in bf16, staged swizzled in this warpgroup's own Q rows,
  // stored with TMA (rows past Sq clipped)
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[r] = 1.f / fmaxf(sum, 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const int c = col / C::CW, byte = (col % C::CW) * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = 64 * cw + 16 * warp + g + 8 * r;
      const uint32_t off = c * C::Q_CHUNK + hopper::swizzle(rl, byte, C::SPAN);
      *reinterpret_cast<uint32_t*>(gQ + off) =
          pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    }
  }
  hopper::fence_proxy_async();
  hopper::named_barrier(1 + cw, 128);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < C::NC; ++c)
      hopper::tma_store_4d(to, sQ + c * C::Q_CHUNK + 64 * cw * C::SPAN, c * C::CW, r0, h, b);
    hopper::tma_store_commit();
    hopper::tma_store_wait_read();
  }
}

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                const TcArgs a) {
  using C = Tc<D>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;  // swizzled tiles start 1024-aligned
  uint8_t* gQ = smem_raw + (sQ - raw);
  const uint32_t sK = sQ + C::Q_BYTES, sV = sK + kStages * C::KV_BYTES;
  // barriers: q_full, k_full[2], v_full[2], empty[2]
  const uint32_t bars = sV + kStages * C::KV_BYTES;

  // heaviest q tiles first: block rows of the grid run in order
  const int nqt = (a.Sq + kTcRows - 1) / kTcRows;
  const int qt = nqt - 1 - (int)blockIdx.y;
  const int h = blockIdx.x % a.Hq, b = blockIdx.x / a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * kTcRows;
  // the block's K tiles: the diagonal of its last row, the window of its first
  const int q_last = min(q0 + kTcRows, a.Sq) - 1;
  const int hi_k = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int lo_k = a.window > 0 ? max(q0 - a.window + 1, 0) : 0;
  const int kt_lo = lo_k / BK;
  const int ntiles = max((hi_k + BK - 1) / BK - kt_lo, 0);

  if (threadIdx.x == 0) {
    hopper::mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bars + 8 + 8 * s, 1);
      hopper::mbar_init(bars + 24 + 8 * s, 1);
      hopper::mbar_init(bars + 40 + 8 * s, 8);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch(&tk);
      hopper::tma_prefetch(&tv);
      hopper::mbar_expect_tx(bars, C::Q_BYTES);
      for (int c = 0; c < C::NC; ++c)
        hopper::tma_load_4d(sQ + c * C::Q_CHUNK, &tq, bars, c * C::CW, q0, h, b);
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const uint32_t k_full = bars + 8 + 8 * st, v_full = bars + 24 + 8 * st;
        const int k0 = (kt_lo + i) * BK;
        hopper::mbar_wait(bars + 40 + 8 * st, ph ^ 1);  // stage released
        hopper::mbar_expect_tx(k_full, C::KV_BYTES);
        for (int c = 0; c < C::NC; ++c)
          hopper::tma_load_4d(sK + st * C::KV_BYTES + c * C::KV_CHUNK, &tk, k_full, c * C::CW, k0,
                              hk, b);
        hopper::mbar_expect_tx(v_full, C::KV_BYTES);
        for (int c = 0; c < C::NC; ++c)
          hopper::tma_load_4d(sV + st * C::KV_BYTES + c * C::KV_CHUNK, &tv, v_full, c * C::CW, k0,
                              hk, b);
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    tc_consume<D, SOFTCAP>(a, &to, sQ, sK, sV, bars, gQ, wg - 1, q0, h, b, kt_lo, ntiles);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                      int Sq, int Sk, Strides qs, Strides ks, Strides vs, int causal, int window,
                      float softcap, cudaStream_t stream) {
  using C = Tc<D>;
  constexpr uint64_t E = 2;  // bytes of a bf16
  CUtensorMap tq, tk, tv, to;
  const uint64_t qd[4] = {D, (uint64_t)Sq, (uint64_t)Hq, (uint64_t)B};
  // K and V of Sk = 0 are never read: a one-row tensor keeps the descriptor valid
  const uint64_t kd[4] = {D, (uint64_t)(Sk > 1 ? Sk : 1), (uint64_t)Hkv, (uint64_t)B};
  const uint64_t q_st[3] = {qs.s * E, qs.h * E, qs.b * E};
  const uint64_t k_st[3] = {ks.s * E, ks.h * E, ks.b * E};
  const uint64_t v_st[3] = {vs.s * E, vs.h * E, vs.b * E};
  const uint64_t o_st[3] = {D * E, (uint64_t)Sq * D * E, (uint64_t)Hq * Sq * D * E};
  if (!hopper::encode_bf16_4d(&tq, q, qd, q_st, C::CW, kTcRows, C::SPAN) ||
      !hopper::encode_bf16_4d(&tk, k, kd, k_st, C::CW, C::BK, C::SPAN) ||
      !hopper::encode_bf16_4d(&tv, v, kd, v_st, C::CW, C::BK, C::SPAN) ||
      !hopper::encode_bf16_4d(&to, o, qd, o_st, C::CW, 64, C::SPAN))
    return cudaErrorInvalidValue;
  const auto kernel = softcap > 0.f ? flash_tc_kernel<D, true> : flash_tc_kernel<D, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const float rs = 1.f / sqrtf((float)D);
  TcArgs a{Hq, Hkv, Sq, Sk, causal, window, rs * kLog2e,
           softcap > 0.f ? 2.f * rs / softcap * kLog2e : 0.f, softcap * kLog2e};
  const dim3 grid(B * Hq, (Sq + kTcRows - 1) / kTcRows);
  kernel<<<grid, kTcThreads, C::SMEM, stream>>>(tq, tk, tv, to, a);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(int D, const void* q, const void* k, const void* v, void* o, int B, int Hq,
                        int Hkv, int Sq, int Sk, Strides qs, Strides ks, Strides vs, int causal,
                        int window, float softcap, cudaStream_t s) {
  switch (D) {
    case 32: return launch_tc<32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 64: return launch_tc<64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 128: return launch_tc<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 256: return launch_tc<256>(q, k, v, o, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o, int B,
                       int Hq, int Hkv, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                       int causal, int window, float softcap, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 256: return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B, Hq, Sq, D], k/v: [B, Hkv, Sk, D] with unit stride along D and the given
// element strides for batch, head and sequence; o: contiguous [B, Hq, Sq, D].
// D in {32, 64, 128, 256}; dtype codes: 0 = float32 (CUDA cores), 1 = bfloat16
// (tensor cores: pointers 16-byte aligned and every stride a multiple of 8
// elements, as TMA needs). window <= 0 means no window; softcap <= 0 means no
// softcap. Returns the launch's cudaError_t (0 on success); the kernel runs
// asynchronously on `stream`.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                     long long q_sb, long long q_sh, long long q_ss,
                                     long long k_sb, long long k_sh, long long k_ss,
                                     long long v_sb, long long v_sh, long long v_ss,
                                     int causal, int window, float softcap, int dtype,
                                     void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;  // empty output: nothing to launch
  if (Hkv <= 0 || Hq % Hkv != 0 || Sk < 0 || Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)dispatch_d<float>(D, q, k, v, o, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
  if (dtype == kBF16) {
    const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
    const long long strides[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
    if (ptrs % 16) return (int)cudaErrorInvalidValue;
    for (long long st : strides)
      if (st < 0 || st % 8) return (int)cudaErrorInvalidValue;
    return (int)dispatch_tc(D, q, k, v, o, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
  }
  return (int)cudaErrorInvalidValue;
}
