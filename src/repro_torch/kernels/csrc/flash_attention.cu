// Flash attention for Hopper (sm_90a): blocked causal attention with an online
// softmax, GQA, tanh logit softcap and a sliding window; the forward (which can
// also write each row's log-sum-exp) and, at the end of the file, its backward.
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
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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
                 T* __restrict__ o, float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
                 Strides qs, Strides ks, Strides vs, int causal, int window, float softcap,
                 float scale) {
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
    // the row's log-sum-exp of its (scaled, capped) scores, for the backward
    if (lse != nullptr && tx == 0)
      lse[((long long)b * Hq + h) * Sq + qr] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Hq, int Hkv, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                   int causal, int window, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap,
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
constexpr float kLn2 = 0.6931471805599453f;

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
  float* lse;      // [B, Hq, Sq] natural-log log-sum-exp of each row, or null
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
    // m and the sum are in log2 units; the backward takes natural logs, as
    // the CUDA-core route writes them
    if (a.lse != nullptr && t == 0 && row[r] < a.Sq)
      a.lse[((long long)b * a.Hq + h) * a.Sq + row[r]] = (m[r] + log2f(fmaxf(sum, 1e-30f))) * kLn2;
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
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                      int Hq, int Hkv, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                      int causal, int window, float softcap, cudaStream_t stream) {
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
  TcArgs a{lse, Hq, Hkv, Sq, Sk, causal, window, rs * kLog2e,
           softcap > 0.f ? 2.f * rs / softcap * kLog2e : 0.f, softcap * kLog2e};
  const dim3 grid(B * Hq, (Sq + kTcRows - 1) / kTcRows);
  kernel<<<grid, kTcThreads, C::SMEM, stream>>>(tq, tk, tv, to, a);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(int D, const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int Hq, int Hkv, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                        int causal, int window, float softcap, cudaStream_t s) {
  switch (D) {
    case 32: return launch_tc<32>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 64: return launch_tc<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 128: return launch_tc<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 256: return launch_tc<256>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int Hq, int Hkv, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                       int causal, int window, float softcap, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 256: return launch<T, 256>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the backward (CUDA cores, float32 and bfloat16)
// ---------------------------------------------------------------------------
//
// What `_make_flash_cvjp`'s bwd computes (src/repro/models/layers.py:242-294),
// from the forward's saved (q, k, v, o, lse) and nothing of size Sq x Sk:
//   delta = rowsum(dO * O); P = exp(s - lse); dS = P * (dO V^T - delta), times
//   (1 - (s / cap)^2) under a softcap, zero where masked;
//   dQ = dS K / sqrt(D); dK = dS^T Q / sqrt(D), dV = P^T dO, summed over the
//   query heads that share a KV head.
// Bound on the card: operations. Five products of the visible (q, k) pairs
// against the forward's two (10 B Hq pairs D flops), which the f32 CUDA cores
// would run at best at 67 TFLOP/s. Design, simple and deterministic (no
// atomics): flash_bwd_delta_kernel writes delta (one warp a row); then
// flash_bwd_dkdv_kernel, one block of 256 threads per (KV tile of 32 keys, KV
// head, batch), keeps dK and dV of its tile in registers and walks the group's
// query heads and the q tiles that see the tile (causal diagonal, window),
// writing dK and dV once; then flash_bwd_dq_kernel, one block per (q tile of
// 32 rows, q head, batch), keeps dQ in registers and walks the visible KV
// tiles. Each pass recomputes S and dP of a tile (seven products in all).
// Tiles are staged in shared memory as f32, rows padded by 4 floats so that
// 16-byte loads of 8 neighbouring rows hit 32 distinct banks: Q (pre-scaled),
// dO, K, V (4 x 32 x 260 floats = 133 KB at D = 256) and P, dS (2 x 32 x 34).
// Thread (ty, tx) of a 16 x 16 grid computes the scores of rows 2ty, 2ty+1
// and keys tx, tx+16 from 16-byte loads along D (four FMAs a load), and
// accumulates rows 2ty, 2ty+1 of its output tile in the head dims
// VW tx + 16 VW m (VW = 4 consecutive dims, 2 at D = 32), again from 16-byte
// loads. The wide loads cut the load instructions, not the shared-memory
// bytes read per FMA (each Q and dO row serves the 16 threads of its row
// group), which likely bound the kernel: larger register tiles come next.
constexpr int BB = 32;         // q rows and keys of a backward tile
constexpr int kRowPad = 4;     // floats of padding per staged row
constexpr int kPS = BB + 2;    // row stride of the P and dS tiles (8-byte rows)

template <int D>
struct Bwd {
  static constexpr int LD = D + kRowPad;            // staged row stride, floats
  static constexpr int VW = D >= 64 ? 4 : 2;        // output dims a vector
  static constexpr int NM = D / (16 * VW);          // vectors a thread a row
  static constexpr size_t SMEM =
      sizeof(float) * (4 * (size_t)BB * LD + 2 * (size_t)BB * kPS + 2 * BB);
};

template <typename T>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                       float* __restrict__ delta, long long rows, int D) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* orow = o + row * D;
  const T* drow = dout + row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f32(orow[c]), to_f32(drow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// four consecutive elements as f32 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// VW consecutive f32 of shared memory
template <int VW>
__device__ __forceinline__ void lds(float (&v)[VW], const float* p) {
  if constexpr (VW == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  }
}

// VW consecutive outputs, as one store
template <typename T, int VW>
__device__ __forceinline__ void store_vec(T* dst, const float* v) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (VW == 4)
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    __nv_bfloat162 h[VW / 2];
#pragma unroll
    for (int e = 0; e < VW / 2; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    if constexpr (VW == 4)
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(h);
    else
      *reinterpret_cast<__nv_bfloat162*>(dst) = h[0];
  }
}

// rows [r0, r0 + BB) of a [S, D] operand into shared memory as f32 (times
// `mul`), zeros past S; 16-byte (f32) or 8-byte (bf16) loads
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int r0, int S, float mul) {
  constexpr int LD = Bwd<D>::LD, Q4 = D / 4;
  for (int idx = threadIdx.x; idx < BB * Q4; idx += kThreads) {
    const int r = idx / Q4, c = (idx % Q4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) {
      v = load4(src + (long long)(r0 + r) * D + c);
      v.x *= mul; v.y *= mul; v.z *= mul; v.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * LD + c) = v;
  }
}

struct BwdArgs {
  int Hq, Hkv, Sq, Sk, causal, window;
  float softcap, scale;
};

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// P and dS of one (q tile at q0, key tile at k0) into Ps, dSs [BB][kPS]
template <int D>
__device__ __forceinline__ void bwd_tile(const BwdArgs& a, const float* Qs, const float* dOs,
                                         const float* Ks, const float* Vs, const float* lse_s,
                                         const float* delta_s, float* Ps, float* dSs, int q0,
                                         int k0) {
  constexpr int LD = Bwd<D>::LD;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  const float* q0r = Qs + (2 * ty) * LD;
  const float* d0r = dOs + (2 * ty) * LD;
  const float* k0r = Ks + tx * LD;
  const float* k1r = Ks + (tx + 16) * LD;
  const float* v0r = Vs + tx * LD;
  const float* v1r = Vs + (tx + 16) * LD;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 kv0 = load4(k0r + d), kv1 = load4(k1r + d);
    const float4 vv0 = load4(v0r + d), vv1 = load4(v1r + d);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float4 qv = load4(q0r + i * LD + d), gv = load4(d0r + i * LD + d);
      s[i][0] = dot4(qv, kv0, s[i][0]);
      s[i][1] = dot4(qv, kv1, s[i][1]);
      dp[i][0] = dot4(gv, vv0, dp[i][0]);
      dp[i][1] = dot4(gv, vv1, dp[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * ty + i, qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tx + 16 * j, kpos = k0 + c;
      float x = s[i][j];
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      bool ok = qpos < a.Sq && kpos < a.Sk;
      if (a.causal) ok = ok && kpos <= qpos;
      if (a.window > 0) ok = ok && (qpos - kpos) < a.window;
      const float p = ok ? expf(x - lse_s[r]) : 0.f;
      float ds = p * (dp[i][j] - delta_s[r]);
      if (a.softcap > 0.f) {
        const float t = x / a.softcap;
        ds *= 1.f - t * t;
      }
      Ps[r * kPS + c] = p;
      dSs[r * kPS + c] = ok ? ds : 0.f;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)  // D = 256 fits one block an SM
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      const BwdArgs a) {
  using C = Bwd<D>;
  constexpr int LD = C::LD, VW = C::VW, NM = C::NM;
  extern __shared__ float4 bwd_smem[];  // 16-byte aligned rows
  float* Qs = reinterpret_cast<float*>(bwd_smem);  // [BB][LD], pre-scaled
  float* dOs = Qs + BB * LD;         // [BB][LD]
  float* Ks = dOs + BB * LD;         // [BB][LD]
  float* Vs = Ks + BB * LD;          // [BB][LD]
  float* Ps = Vs + BB * LD;          // [BB][kPS]
  float* dSs = Ps + BB * kPS;        // [BB][kPS]
  float* lse_s = dSs + BB * kPS;
  float* delta_s = lse_s + BB;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = blockIdx.x * BB, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const long long kv_off = ((long long)b * a.Hkv + hk) * a.Sk * D;
  stage_rows<T, D>(Ks, k + kv_off, k0, a.Sk, 1.f);
  stage_rows<T, D>(Vs, v + kv_off, k0, a.Sk, 1.f);

  float acc_k[2][NM * VW], acc_v[2][NM * VW];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NM * VW; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // the q rows that see a key of this tile: from the diagonal (causal) to
  // the window's reach of its last key
  const int lo_q = a.causal ? k0 : 0;
  int hi_q = a.Sq;
  if (a.window > 0) hi_q = min(hi_q, k0 + BB - 1 + a.window);
  const int qt_lo = lo_q / BB, qt_hi = hi_q > lo_q ? (hi_q + BB - 1) / BB : qt_lo;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long q_off = ((long long)b * a.Hq + h) * a.Sq;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * BB;
      __syncthreads();  // the previous tile's readers are done
      stage_rows<T, D>(Qs, q + q_off * D, q0, a.Sq, a.scale);
      stage_rows<T, D>(dOs, dout + q_off * D, q0, a.Sq, 1.f);
      if (threadIdx.x < BB) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < a.Sq ? lse[q_off + r] : 0.f;
        delta_s[threadIdx.x] = r < a.Sq ? delta[q_off + r] : 0.f;
      }
      __syncthreads();
      bwd_tile<D>(a, Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0);
      __syncthreads();
      // dV[j] += P[i, j] dO[i]; dK[j] += dS[i, j] Q[i] (Q carries 1/sqrt(D))
#pragma unroll 2
      for (int i = 0; i < BB; ++i) {
        const float2 p = *reinterpret_cast<const float2*>(Ps + i * kPS + 2 * ty);
        const float2 ds = *reinterpret_cast<const float2*>(dSs + i * kPS + 2 * ty);
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          float dov[VW], qv[VW];
          lds<VW>(dov, dOs + i * LD + VW * tx + 16 * VW * m);
          lds<VW>(qv, Qs + i * LD + VW * tx + 16 * VW * m);
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            acc_v[0][m * VW + e] = fmaf(p.x, dov[e], acc_v[0][m * VW + e]);
            acc_v[1][m * VW + e] = fmaf(p.y, dov[e], acc_v[1][m * VW + e]);
            acc_k[0][m * VW + e] = fmaf(ds.x, qv[e], acc_k[0][m * VW + e]);
            acc_k[1][m * VW + e] = fmaf(ds.y, qv[e], acc_k[1][m * VW + e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = k0 + 2 * ty + i;
    if (kr >= a.Sk) continue;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const long long at = kv_off + (long long)kr * D + VW * tx + 16 * VW * m;
      store_vec<T, VW>(dk + at, &acc_k[i][m * VW]);
      store_vec<T, VW>(dv + at, &acc_v[i][m * VW]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)  // D = 256 fits one block an SM
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, const BwdArgs a) {
  using C = Bwd<D>;
  constexpr int LD = C::LD, VW = C::VW, NM = C::NM;
  extern __shared__ float4 bwd_smem[];
  float* Qs = reinterpret_cast<float*>(bwd_smem);
  float* dOs = Qs + BB * LD;
  float* Ks = dOs + BB * LD;
  float* Vs = Ks + BB * LD;
  float* Ps = Vs + BB * LD;
  float* dSs = Ps + BB * kPS;
  float* lse_s = dSs + BB * kPS;
  float* delta_s = lse_s + BB;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = blockIdx.x * BB, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const long long q_off = ((long long)b * a.Hq + h) * a.Sq;
  const long long kv_off = ((long long)b * a.Hkv + hk) * a.Sk * D;
  stage_rows<T, D>(Qs, q + q_off * D, q0, a.Sq, a.scale);
  stage_rows<T, D>(dOs, dout + q_off * D, q0, a.Sq, 1.f);
  if (threadIdx.x < BB) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < a.Sq ? lse[q_off + r] : 0.f;
    delta_s[threadIdx.x] = r < a.Sq ? delta[q_off + r] : 0.f;
  }

  float acc[2][NM * VW];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NM * VW; ++c) acc[i][c] = 0.f;

  // the keys this tile's rows see: up to the diagonal of its last row, back
  // to the window of its first
  const int hi_k = a.causal ? min(a.Sk, q0 + BB) : a.Sk;
  const int lo_k = a.window > 0 ? max(q0 - a.window + 1, 0) : 0;
  const int kt_lo = lo_k / BB, kt_hi = hi_k > lo_k ? (hi_k + BB - 1) / BB : kt_lo;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BB;
    __syncthreads();
    stage_rows<T, D>(Ks, k + kv_off, k0, a.Sk, 1.f);
    stage_rows<T, D>(Vs, v + kv_off, k0, a.Sk, 1.f);
    __syncthreads();
    bwd_tile<D>(a, Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0);
    __syncthreads();
    // dQ[i] += dS[i, j] K[j]
#pragma unroll 2
    for (int j = 0; j < BB; ++j) {
      const float s0 = dSs[(2 * ty) * kPS + j], s1 = dSs[(2 * ty + 1) * kPS + j];
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        float kv[VW];
        lds<VW>(kv, Ks + j * LD + VW * tx + 16 * VW * m);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          acc[0][m * VW + e] = fmaf(s0, kv[e], acc[0][m * VW + e]);
          acc[1][m * VW + e] = fmaf(s1, kv[e], acc[1][m * VW + e]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = q0 + 2 * ty + i;
    if (qr >= a.Sq) continue;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      float out[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) out[e] = acc[i][m * VW + e] * a.scale;
      store_vec<T, VW>(dq + (q_off + qr) * D + VW * tx + 16 * VW * m, out);
    }
  }
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = Bwd<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const long long rows = (long long)B * a.Hq * a.Sq;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), dop, delta, rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.Sk > 0) {
    flash_bwd_dkdv_kernel<T, D><<<dim3((a.Sk + BB - 1) / BB, a.Hkv, B), kThreads, smem, stream>>>(
        qp, kp, vp, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dq_kernel<T, D><<<dim3((a.Sq + BB - 1) / BB, a.Hq, B), kThreads, smem, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dq), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(int D, const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* delta, void* dq, void* dk,
                         void* dv, int B, const BwdArgs& a, cudaStream_t s) {
  switch (D) {
    case 32: return launch_bwd<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, a, s);
    case 64: return launch_bwd<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, a, s);
    case 128: return launch_bwd<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, a, s);
    case 256: return launch_bwd<T, 256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace


// q: [B, Hq, Sq, D], k/v: [B, Hkv, Sk, D] with unit stride along D and the given
// element strides for batch, head and sequence; o: contiguous [B, Hq, Sq, D];
// lse: null, or contiguous f32 [B, Hq, Sq] that receives each row's natural-log
// log-sum-exp of its scaled (and capped) scores, which the backward reads.
// D in {32, 64, 128, 256}; dtype codes: 0 = float32 (CUDA cores), 1 = bfloat16
// (tensor cores: pointers 16-byte aligned and every stride a multiple of 8
// elements, as TMA needs). window <= 0 means no window; softcap <= 0 means no
// softcap. Returns the launch's cudaError_t (0 on success); the kernel runs
// asynchronously on `stream`.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
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
    return (int)dispatch_d<float>(D, q, k, v, o, static_cast<float*>(lse), B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
  if (dtype == kBF16) {
    const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
    const long long strides[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
    if (ptrs % 16) return (int)cudaErrorInvalidValue;
    for (long long st : strides)
      if (st < 0 || st % 8) return (int)cudaErrorInvalidValue;
    return (int)dispatch_tc(D, q, k, v, o, static_cast<float*>(lse), B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The backward of repro_flash_attention. q, o, dout, dq: contiguous [B, Hq, Sq, D];
// k, v, dk, dv: contiguous [B, Hkv, Sk, D], each starting on 16 bytes; lse: the
// forward's f32 [B, Hq, Sq];
// delta: f32 [B, Hq, Sq] scratch. All of one dtype (0 = float32, 1 = bfloat16),
// accumulated in f32. Returns the first failing launch's cudaError_t (0 on
// success); the three kernels run asynchronously on `stream`.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv, int B,
                                         int Hq, int Hkv, int Sq, int Sk, int D, int causal,
                                         int window, float softcap, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Sk < 0 || Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  // the tiles move in 16-byte (f32) or 8-byte (bf16) vectors
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)dout |
       (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) % 16)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{Hq, Hkv, Sq, Sk, causal, window, softcap, 1.f / sqrtf((float)D)};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)dispatch_bwd<float>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, a, s);
  if (dtype == kBF16)
    return (int)dispatch_bwd<__nv_bfloat16>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, a, s);
  return (int)cudaErrorInvalidValue;
}
