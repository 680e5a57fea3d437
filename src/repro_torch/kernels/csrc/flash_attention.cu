// Flash attention for Hopper (sm_90a): blocked causal attention with an online
// softmax, GQA, tanh logit softcap and a sliding window; the forward (which can
// also write each row's log-sum-exp) and, at the end of the file, its backward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (kernel body :54-91, pallas_call at :93). Same arithmetic: scores scaled by
// 1/sqrt(D), softcap before the mask, top-left causal mask (q_pos starts at 0 even
// when Sq != Sk), window rule q - k < w, f32 accumulation, output in q's type.
// Masked scores count for nothing: both routes mask them to -inf and guard the
// running max while a row has seen nothing, so a masked key weighs exactly 0. A
// row that sees no key at all (top-left causal with Sq > Sk and a window: rows
// from Sk + window - 1 on) writes o = 0 and lse = +inf on both routes, as the
// plain versions do; with lse = +inf, exp(s - lse) = 0, so both backwards pass
// such a row no gradient (ROADMAP C10; the reference's -1e30 mask would instead
// average V over the masked keys). K tiles outside the causal diagonal and left
// of the window are skipped (the loop bounds of flash_attention.py:84-86).
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
// K, V tiles of BK keys (128 at D <= 128, 64 at D = 192 and 256) into a 2-stage
// ring with full barriers per stage for K and for V and an empty barrier per
// stage. Tiles hold D in whole chunks of the swizzle span: D = 80 (160-byte
// rows, not a whole number of 128-byte atoms) is staged as 128 columns, the TMA
// boxes past the tensor's last dim filled with zeros (nothing is copied or
// padded in device memory); Q K^T takes only D's five k16 slices, P V runs at
// N = 128 and the columns past D are never stored; the scale stays 1/sqrt(80).
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
// 144 KB at D = 192, 160 KB at D = 128 and at D = 80 staged as 128): one block an SM, its two consumer warpgroups keeping the
// tensor cores busy in turn. Operands are described to TMA as 4-d (D, S, H, B)
// with their own strides, so a ragged tile reads zeros past S inside its head
// and the output's TMA store clips it. The epilogue divides by l, converts to
// bf16, stages the tile in its own Q rows (swizzled) and stores it with TMA.
// The wgmma, TMA and mbarrier helpers live in hopper.cuh.
//
// float32: the CUDA-core kernel (flash_fwd_kernel), exact to f32 rounding
// (tensor cores would round its inputs to TF32). Bound by operations at f32's
// 67 TFLOP/s: each SM sub-partition issues one warp instruction a clock and
// has 32 FMA lanes, so every instruction that is not an FMA (a shared load, an
// address, a shuffle) takes an FMA's slot. One block of 256 threads per (q
// tile of 64 rows, q head, batch), the heaviest q tiles (the bottom of the
// causal triangle) first. Q is staged once; K and V stream in tiles of 32 keys
// into two buffers by 16-byte cp.async, the next tile's copy in flight while
// this one is computed (208 KB of shared memory at D = 256: one block an SM;
// 110 KB at D = 128: two; 156 KB at D = 192, 72 KB at D = 80). Per K tile, three
// steps between barriers:
//   S = Q K^T   each half of the block takes 32 rows, each thread a 4 x 4
//               block over half of D (the partner lane has the other half;
//               one shuffle adds them): 8 float4 shared loads feed 64 FMAs,
//               rows padded by 4 floats so that a warp's loads fall in
//               distinct banks; S goes to a [64][36] tile;
//   softmax     four lanes a row, 8 keys each: scale, softcap, mask to -inf,
//               the row's running max and sum in registers, P written over
//               S and the row's rescale factor to shared memory;
//   O += P V    each thread 8 rows x D/32 dims (a warp 4 row groups x 8 dim
//               groups, so P's and V's loads hit distinct banks): per 4 keys,
//               8 float4 loads of P and 8 of V (D = 256) feed 256 FMAs; at
//               D = 80 single floats over 96 dims, the warps past D idle.
// O stays in registers (64 a thread at D = 256) and is written as float4s
// after O / l. Ragged Sq and Sk tails are zero-filled copies and masked; the kv
// head of q head h is h / (Hq / Hkv). Rows must start on 16 bytes (the wrapper
// copies a view whose strides do not).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

// ---------------------------------------------------------------------------
// the CUDA-core route (float32): tiles and helpers of the forward and the
// backward
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int BB = 32;       // keys of a CUDA-core tile (and q rows of a backward tile)
constexpr int kRowPad = 4;   // floats of padding per staged row
constexpr int kPS = BB + 4;  // row stride of the score tiles (16-byte rows)

template <int D>
__host__ __device__ constexpr int row_ld() {  // staged Q, K (and the backward's dO, V) row stride, floats
  return D + kRowPad;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Strides {  // element strides of one [B, H, S, D] operand (D stride is 1)
  long long b, h, s;
};

using hopper::cp_async16;
using hopper::cp_async_commit;

// rows [r0, r0 + R) of a [S, D] f32 operand whose rows are `stride` elements
// apart (each starting on 16 bytes) into shared memory (row stride LDS),
// zeros past S, as 16-byte cp.async copies (not waited for)
template <int D, int R = BB, int LDS = row_ld<D>()>
__device__ __forceinline__ void stage_async(float* dst, const float* src, int r0, int S,
                                            long long stride = D) {
  constexpr int Q4 = D / 4;
  for (int idx = threadIdx.x; idx < R * Q4; idx += kThreads) {
    const int r = idx / Q4, c = (idx % Q4) * 4;
    const bool in = r0 + r < S;
    cp_async16(dst + r * LDS + c, in ? src + (long long)(r0 + r) * stride + c : src, in);
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// VW consecutive f32 of shared memory
template <int VW>
__device__ __forceinline__ void lds(float (&v)[VW], const float* p) {
  if constexpr (VW == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (VW == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(float* dst, const float* v) {
  if constexpr (VW == 4) *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (VW == 2) *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  else *dst = v[0];
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The 4 x 4 block of A B^T at rows ra + 8i of A and rb + 8j of B (32-row
// tiles in shared memory): this lane sums the head dims of its split `sp`
// (16-dim runs 16 sp + 32 m), the partner lane (lane ^ 1) the others, and one
// shuffle a value adds the halves. Rows 8 apart and the two splits 16 floats
// apart put a warp's eight distinct 16-byte loads in distinct banks.
template <int D>
__device__ __forceinline__ void score_block(float (&s)[4][4], const float* A, const float* B,
                                            int ra, int rb, int sp) {
  constexpr int LD = row_ld<D>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
  for (int d0 = 16 * sp; d0 < D; d0 += 32) {
#pragma unroll
    for (int e = 0; e < 16; e += 4) {
      float4 x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = load4(A + (ra + 8 * i) * LD + d0 + e);
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = load4(B + (rb + 8 * j) * LD + d0 + e);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(x[i], y[j], s[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] += __shfl_xor_sync(0xffffffffu, s[i][j], 1);
}

// The score-phase coordinates of a thread in its half (128 threads): split,
// q-row block and key block; a warp covers 16 q rows x 16 keys.
struct ScoreLane {
  int sp, qb, kb;
  __device__ __forceinline__ ScoreLane() {
    const int h = threadIdx.x & 127, w = h >> 5, l = (h & 31) >> 1;
    sp = h & 1;
    qb = 4 * (w >> 1) + (l >> 2);
    kb = 4 * (w & 1) + (l & 3);
  }
};

// A half's 4 x 4 block of scores (both lanes of a split pair hold it; each
// writes the rows of its split) into a [BB][kPS] tile, as [q][k] or, with
// TRANSPOSED, [k][q]. Rows are selected, not indexed, so s stays in registers.
template <bool TRANSPOSED>
__device__ __forceinline__ void write_block(const float (&s)[4][4], const ScoreLane& L, float* dst) {
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int ql = L.qb + 8 * (ii + 2 * L.sp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kl = L.kb + 8 * j;
      dst[TRANSPOSED ? kl * kPS + ql : ql * kPS + kl] = L.sp ? s[ii + 2][j] : s[ii][j];
    }
  }
}

// --- the forward --------------------------------------------------------------

constexpr int FQ = 64;  // q rows of a forward block

template <int D>
struct Fwd {
  static constexpr int LD = row_ld<D>();
  // O += P V: each thread 8 rows x VW * NM dims, a warp 4 row groups x 8
  // dim groups: dims VW dg + 32 VW m, the widest vectors that tile D; where
  // 32 VW does not divide D (D = 80: 96 dims covered), the dims past D are
  // skipped by whole warps
  static constexpr int VW = D % 128 == 0 ? 4 : D % 64 == 0 ? 2 : 1;
  static constexpr int NM = (D + 32 * VW - 1) / (32 * VW);
  // Q; K and V, two buffers each; the score tile; each row's rescale
  // factor and sum
  static constexpr size_t SMEM = sizeof(float) * ((size_t)FQ * LD + 2 * (size_t)BB * LD +
                                                  2 * (size_t)BB * D + (size_t)FQ * kPS + 2 * FQ);
  static constexpr int MIN_BLOCKS = D <= 128 ? 2 : 1;
  static_assert(SMEM * MIN_BLOCKS <= 232448, "CUDA-core forward tiles exceed shared memory");
};

struct FwdArgs {
  float* lse;  // [B, Hq, Sq] natural-log log-sum-exp of each row, or null
  int Hq, Hkv, Sq, Sk, causal, window;
  float softcap, scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads, Fwd<D>::MIN_BLOCKS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, const FwdArgs a,
                 const Strides qs, const Strides ks, const Strides vs) {
  using C = Fwd<D>;
  constexpr int LD = C::LD, VW = C::VW, NM = C::NM;
  extern __shared__ float4 fwd_smem[];  // 16-byte aligned rows
  float* Qs = reinterpret_cast<float*>(fwd_smem);  // [FQ][LD]
  float* Ks = Qs + FQ * LD;                        // two buffers of [BB][LD]
  float* Vs = Ks + 2 * BB * LD;                    // two buffers of [BB][D]
  float* Ss = Vs + 2 * BB * D;                     // [FQ][kPS]: S, then P
  float* alpha_s = Ss + FQ * kPS;                  // [FQ]
  float* l_s = alpha_s + FQ;                       // [FQ]

  // heaviest q tiles first: block rows of the grid run in order
  const int nqt = (a.Sq + FQ - 1) / FQ;
  const int q0 = (nqt - 1 - (int)blockIdx.y) * FQ;
  const int h = blockIdx.x % a.Hq, b = blockIdx.x / a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  // the block's K tiles: up to the diagonal of its last row, back to the
  // window of its first
  const int q_last = min(q0 + FQ, a.Sq) - 1;
  const int hi_k = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int lo_k = a.window > 0 ? max(q0 - a.window + 1, 0) : 0;
  const int kt_lo = lo_k / BB;
  const int n = hi_k > lo_k ? (hi_k + BB - 1) / BB - kt_lo : 0;

  auto stage = [&](int i) {  // K and V tile i into buffer i % 2
    const int k0 = (kt_lo + i) * BB, st = i & 1;
    stage_async<D>(Ks + st * BB * LD, kb, k0, a.Sk, ks.s);
    stage_async<D, BB, D>(Vs + st * BB * D, vb, k0, a.Sk, vs.s);
  };
  stage_async<D, FQ>(Qs, q + b * qs.b + h * qs.h, q0, a.Sq, qs.s);
  if (n > 0) stage(0);
  cp_async_commit();

  const int tid = threadIdx.x, half = tid >> 7;
  const ScoreLane L;
  // the softmax: four lanes a row (row sr, keys sc .. sc + 7), each holding
  // the row's running max and sum
  const int sr = tid >> 2, sc = 8 * (tid & 3);
  float m_run = -INFINITY, l_run = 0.f;
  // O: rows rg + 8 i, dims VW dg + 32 VW m
  const int lane = tid & 31, w = tid >> 5;
  const int rg = 4 * (w >> 2) + (lane >> 3), dg = 8 * (w & 3) + (lane & 7);
  float acc[8][NM * VW];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < NM * VW; ++c) acc[r][c] = 0.f;

  for (int i = 0; i < n; ++i) {
    hopper::cp_async_wait<0>();
    __syncthreads();  // tile i landed; every reader of tile i - 1 is done
    if (i + 1 < n) stage(i + 1);
    cp_async_commit();
    const int st = i & 1, k0 = (kt_lo + i) * BB;
    const float* Vt = Vs + st * BB * D;

    // S = Q K^T, each half of the block 32 rows
    {
      float s[4][4];
      score_block<D>(s, Qs + half * BB * LD, Ks + st * BB * LD, L.qb, L.kb, L.sp);
      write_block<false>(s, L, Ss + half * BB * kPS);
    }
    __syncthreads();

    // online softmax of row sr: scale, softcap, mask to -inf; the running
    // max is guarded while the row has seen nothing (m_use), so a masked
    // key weighs exactly 0 and a row with no key keeps l = 0
    {
      float* srow = Ss + sr * kPS + sc;
      const float4 s0 = load4(srow), s1 = load4(srow + 4);
      float x[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const int qpos = q0 + sr;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float t = x[j] * a.scale;
        if (a.softcap > 0.f) t = a.softcap * tanhf(t / a.softcap);
        const int kpos = k0 + sc + j;
        bool ok = kpos < a.Sk;
        if (a.causal) ok = ok && kpos <= qpos;
        if (a.window > 0) ok = ok && qpos - kpos < a.window;
        x[j] = ok ? t : -INFINITY;
        mx = fmaxf(mx, x[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_run - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x[j] = expf(x[j] - m_use);
        sum += x[j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      *reinterpret_cast<float4*>(srow) = make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(srow + 4) = make_float4(x[4], x[5], x[6], x[7]);
      if ((tid & 3) == 0) alpha_s[sr] = alpha;
    }
    __syncthreads();  // P and the rescale factors complete

    // O = alpha O + P V: per 4 keys, 8 float4 loads of P and 4 NM of V
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float al = alpha_s[rg + 8 * r];
#pragma unroll
      for (int c = 0; c < NM * VW; ++c) acc[r][c] *= al;
    }
#pragma unroll 2
    for (int c4 = 0; c4 < BB; c4 += 4) {
      float p[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 t = load4(Ss + (rg + 8 * r) * kPS + c4);
        p[r][0] = t.x; p[r][1] = t.y; p[r][2] = t.z; p[r][3] = t.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = Vt + (c4 + cc) * D + VW * dg;
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          if (VW * dg + 32 * VW * m >= D) continue;  // past D: whole warps
          float xv[VW];
          lds<VW>(xv, vrow + 32 * VW * m);
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int e = 0; e < VW; ++e)
              acc[r][m * VW + e] = fmaf(p[r][cc], xv[e], acc[r][m * VW + e]);
        }
      }
    }
  }

  // each row's sum; O / l, and lse = m + log(l), or o = 0 and lse = +inf for
  // a row that saw no key
  if ((tid & 3) == 0) {
    l_s[sr] = l_run;
    const int qr = q0 + sr;
    if (a.lse != nullptr && qr < a.Sq)
      a.lse[((long long)b * a.Hq + h) * a.Sq + qr] = l_run > 0.f ? m_run + logf(l_run) : INFINITY;
  }
  __syncthreads();
  float* ob = o + ((long long)b * a.Hq + h) * (long long)a.Sq * D;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int qr = q0 + rg + 8 * r;
    if (qr >= a.Sq) continue;
    const float l = l_s[rg + 8 * r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      if (VW * dg + 32 * VW * m >= D) continue;
      float o4[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) o4[e] = acc[r][m * VW + e] * inv;
      store_vec<VW>(ob + (long long)qr * D + VW * dg + 32 * VW * m, o4);
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int Hq, int Hkv, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                       int causal, int window, float softcap, cudaStream_t stream) {
  constexpr size_t smem = Fwd<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const FwdArgs a{lse, Hq, Hkv, Sq, Sk, causal, window, softcap, 1.f / sqrtf((float)D)};
  const dim3 grid(B * Hq, (Sq + FQ - 1) / FQ);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), a, qs, ks, vs);
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
  // D in whole chunks: D = 80 is staged as 128 columns, the TMA boxes past
  // D filled with zeros, which add nothing to Q K^T (its k16 slices stop at
  // D) and give O columns that are never stored
  static constexpr int DP = (D + CW - 1) / CW * CW;
  static constexpr int NC = DP / CW;               // chunks per row
  static constexpr int BK = D >= 192 ? 64 : 128;   // keys per K/V tile
  static constexpr int Q_BYTES = kTcRows * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;
  static constexpr int Q_CHUNK = kTcRows * SPAN;   // bytes of one Q chunk
  static constexpr int KV_CHUNK = BK * SPAN;
  // Q, K ring, V ring, 7 barriers, and slack to align the tiles to 1024 B
  static constexpr size_t SMEM = Q_BYTES + 2 * kStages * KV_BYTES + 64 + 1024;
  static_assert(SMEM <= 232448, "tensor-core forward tiles exceed shared memory");
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
  constexpr int DP = C::DP;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
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
      for (int j = 0; j < DP / 8; ++j) {
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
        hopper::Wgmma<DP>::rs_tb(o, p[kk], db, 1);
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
    // the CUDA-core route writes them; a row that saw no key gets +inf
    if (a.lse != nullptr && t == 0 && row[r] < a.Sq)
      a.lse[((long long)b * a.Hq + h) * a.Sq + row[r]] =
          m[r] == -INFINITY ? INFINITY : (m[r] + log2f(sum)) * kLn2;
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
    case 80: return launch_tc<80>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 128: return launch_tc<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 192: return launch_tc<192>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 256: return launch_tc<256>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_f32(int D, const void* q, const void* k, const void* v, void* o, float* lse,
                         int B, int Hq, int Hkv, int Sq, int Sk, Strides qs, Strides ks,
                         Strides vs, int causal, int window, float softcap, cudaStream_t s) {
  switch (D) {
    case 32: return launch_f32<32>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 64: return launch_f32<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 80: return launch_f32<80>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 128: return launch_f32<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 192: return launch_f32<192>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    case 256: return launch_f32<256>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the backward
// ---------------------------------------------------------------------------
//
// What `_make_flash_cvjp`'s bwd computes (src/repro/models/layers.py:242-294),
// from the forward's saved (q, k, v, o, lse) and nothing of size Sq x Sk:
//   delta = rowsum(dO * O); P = exp(s - lse); dS = P * (dO V^T - delta), times
//   (1 - (s / cap)^2) under a softcap, zero where masked;
//   dQ = dS K / sqrt(D); dK = dS^T Q / sqrt(D), dV = P^T dO, summed over the
//   query heads that share a KV head.
// Masked pairs count for nothing, as in the forward: P is 0 there, so a row
// that sees no key at all (the forward wrote o = 0 and lse = +inf for it, and
// exp(s - inf) = 0) passes no gradient, where the reference's average over
// masked keys would.
// Bound on the card: operations, five products of the visible (q, k) pairs
// (10 B Hq pairs D flops) at the dtype's peak. Deterministic on both routes (no
// atomics): every output element is written once, by the block that owns it.
// Three launches: flash_bwd_delta_kernel writes delta and a copy of lse into
// rows padded to a multiple of 64 (zeros past Sq), so every tile reads them as
// whole aligned runs; a dK/dV pass, one block per KV tile of one KV head,
// keeps dK and dV in registers and walks the group's query heads and the q
// tiles that see the tile (causal diagonal, window); a dQ pass, one block per
// q tile, keeps dQ in registers and walks the visible KV tiles. Each pass
// recomputes S and dP of a tile (seven products in all). Two routes, by dtype:
//
// bfloat16: tensor cores (flash_bwd_tc_dkdv_kernel, flash_bwd_tc_dq_kernel),
// built like flash_tc_kernel from hopper.cuh: 64-row bf16 tiles that TMA
// writes under the 128-byte swizzle (64-byte at D = 32), one producer thread
// feeding an mbarrier ring, consumer warpgroups on wgmma. P and dS are rounded
// to bf16 where they feed a product (as in any tensor-core flash backward);
// every product accumulates in f32 and the outputs are rounded once.
//   dK/dV: a block of three warpgroups owns 64 keys. The producer loads K and V
//   once and streams Q, dO and their lse, delta rows through a two-stage ring.
//   Warpgroup 1 owns dV, warpgroup 2 dK (64 x D f32 each: 128 registers a
//   thread at D = 256, so one warpgroup could not hold both). Per q tile,
//   warpgroup 1 computes S^T = K Q^T (wgmma, both operands K-major), then P^T
//   and P' = P^T (1 - (s / cap)^2), masked, on the accumulator fragment; it
//   hands P' to warpgroup 2 through shared memory (same fragment layout, one
//   f32 a register, named barriers both ways) and runs dV += P^T dO (P^T in
//   registers as the bf16 A operand, dO MN-major from shared memory).
//   Warpgroup 2 meanwhile computes dP^T = V dO^T, then dS^T = P' (dP^T - delta)
//   and dK += dS^T Q. Each warpgroup runs two of the four products a tile.
//   dQ: a block of three warpgroups owns 128 q rows, 64 per consumer
//   warpgroup, which run in turn as the forward's do; Q and dO are loaded
//   once, K and V stream through a two-stage ring in tiles of 64 keys (32 at
//   D = 256, with wgmma m64n32: 64-key stages would not fit beside Q and dO;
//   at D = 192 64-key stages fit, 193 KB, and S, dP and dQ take 160 f32
//   registers a thread, as dK/dV's at D = 256). D = 80 is staged as 128
//   columns of TMA's zeros past D, as in the forward.
//   Per KV tile: S = Q K^T and dP = dO V^T (one wgmma group), dS on the
//   fragment, dQ += dS K (dQ alone is 128 registers a thread at D = 256).
//   Shared memory at D = 256: dK/dV 210 KB (K and V 32 KB each, two stages of
//   Q and dO 128 KB, the 16 KB exchange), dQ 193 KB; one block an SM.
//
// float32: CUDA cores, exact f32 arithmetic (no TF32: the reference trains in
// f32). Tiles of 32 rows and 32 keys staged with cp.async in f32, rows padded
// by 4 floats; the q-side tiles of the dK/dV pass (Q, dO, lse, delta) and the
// KV tiles of the dQ pass go to two buffers, the next tile's copy in flight
// while the current one is computed. 256 threads in two halves of four
// warps: for the scores, half 0 computes S = Q K^T and half 1 dP = dO V^T,
// each thread a 4 x 4 block over half of D (its partner lane has the other
// half; one shuffle adds them), so that each 16-byte load feeds 16 FMAs; all
// 256 threads then turn S and dP into P and dS, four entries each. Then half 0 accumulates dV += P^T dO and half 1 dK += dS^T Q (dK/dV pass),
// each thread 4 keys x D/16 dims, or all 256 threads dQ += dS K, each 4 rows x
// D/32 dims (dQ pass). 209 KB of shared memory at D = 256 (one block an SM),
// 108.5 KB at D = 128 (two blocks an SM, 128 registers a thread).

constexpr int kPadRows = 64;  // lse and delta rows padded to a multiple of this

struct BwdArgs {
  const float* lse_pad;    // [B, Hq, Sq_pad], natural log, zeros past Sq
  const float* delta_pad;  // [B, Hq, Sq_pad]
  int Hq, Hkv, Sq, Sk, Sq_pad, causal, window;
  float softcap, scale;
};

__device__ __forceinline__ bool visible(const BwdArgs& a, int qpos, int kpos) {
  bool ok = qpos < a.Sq && kpos < a.Sk;
  if (a.causal) ok = ok && kpos <= qpos;
  if (a.window > 0) ok = ok && qpos - kpos < a.window;
  return ok;
}

// delta = rowsum(dO * O) and a copy of lse, one warp a padded row
template <typename T>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                       const float* __restrict__ lse, float* __restrict__ lse_pad,
                                       float* __restrict__ delta_pad, long long rows_pad, int Sq,
                                       int Sq_pad, int D) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows_pad) return;
  const int lane = threadIdx.x % 32;
  const long long bh = row / Sq_pad;
  const int r = (int)(row % Sq_pad);
  float acc = 0.f, l = 0.f;
  if (r < Sq) {
    const long long src = bh * Sq + r;
    const T* orow = o + src * D;
    const T* drow = dout + src * D;
    for (int c = lane; c < D; c += 32) acc = fmaf(to_f32(orow[c]), to_f32(drow[c]), acc);
    l = lse[src];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    delta_pad[row] = acc;
    lse_pad[row] = l;
  }
}

// --- the CUDA-core route (float32) -------------------------------------------

template <int D>
struct Bwd {
  static constexpr int LD = row_ld<D>();  // staged row stride, floats
  // dK/dV accumulation: 8 key blocks x 16 dim blocks over 128 threads,
  // the widest vectors that tile D (D = 80: single floats, 5 a row)
  static constexpr int VW = D % 64 == 0 ? 4 : D % 32 == 0 ? 2 : 1;
  static constexpr int NM = D / (16 * VW);
  // dQ accumulation: 8 row blocks x 32 dim blocks over 256 threads; where
  // 32 VWQ does not divide D (D = 80: 96 dims covered), whole warps skip the
  // dims past D
  static constexpr int VWQ = D % 128 == 0 ? 4 : D % 64 == 0 ? 2 : 1;
  static constexpr int NMQ = (D + 32 * VWQ - 1) / (32 * VWQ);
  // K, V, Q and dO, two of either side's; P and dS; lse and delta, two stages
  static constexpr size_t SMEM =
      sizeof(float) * (6 * (size_t)BB * LD + 2 * (size_t)BB * kPS + 4 * BB);
  static constexpr int MIN_BLOCKS = D <= 128 ? 2 : 1;
  static_assert(SMEM * MIN_BLOCKS <= 232448, "CUDA-core backward tiles exceed shared memory");
};

// BB floats of lse and of delta (padded rows: always in bounds)
__device__ __forceinline__ void stage_rows_async(float* lse_s, float* delta_s, const BwdArgs& a,
                                                 long long row) {
  const int t = threadIdx.x;
  if (t < BB / 4) cp_async16(lse_s + 4 * t, a.lse_pad + row + 4 * t, true);
  else if (t < BB / 2) cp_async16(delta_s + 4 * (t - BB / 4), a.delta_pad + row + 4 * (t - BB / 4), true);
}

// The elementwise step, four entries a thread over all 256: from the raw
// score s = q.k and dP, P = exp(x - lse) with x = s / sqrt(D) (capped:
// cap tanh(x / cap)) and dS = P (1 - (x / cap)^2) (dP - delta), zero where
// masked. [q][k] tiles (dK/dV pass: P over S, dS over dP) or, TRANSPOSED,
// [k][q] (dQ pass: dS over dP only).
template <bool TRANSPOSED>
__device__ __forceinline__ void p_and_ds(const BwdArgs& a, float* Ps, float* dSs,
                                         const float* lse_s, const float* delta_s, int q0,
                                         int k0) {
  const int r = threadIdx.x >> 3, c0 = 4 * (threadIdx.x & 7);
  float4* pv = reinterpret_cast<float4*>(Ps + r * kPS + c0);
  float4* dv = reinterpret_cast<float4*>(dSs + r * kPS + c0);
  float sv[4], dp[4];
  {
    const float4 x = *pv, y = *dv;
    sv[0] = x.x; sv[1] = x.y; sv[2] = x.z; sv[3] = x.w;
    dp[0] = y.x; dp[1] = y.y; dp[2] = y.z; dp[3] = y.w;
  }
  float p[4], ds[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int ql = TRANSPOSED ? c0 + e : r, kl = TRANSPOSED ? r : c0 + e;
    float x = sv[e] * a.scale, dcap = 1.f;
    if (a.softcap > 0.f) {
      const float t = tanhf(x / a.softcap);
      x = a.softcap * t;
      dcap = 1.f - t * t;
    }
    const bool ok = visible(a, q0 + ql, k0 + kl);
    p[e] = ok ? expf(x - lse_s[ql]) : 0.f;
    ds[e] = p[e] * dcap * (dp[e] - delta_s[ql]);
  }
  if (!TRANSPOSED) *pv = make_float4(p[0], p[1], p[2], p[3]);
  *dv = make_float4(ds[0], ds[1], ds[2], ds[3]);
}

template <int D>
__global__ void __launch_bounds__(kThreads, Bwd<D>::MIN_BLOCKS)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      float* __restrict__ dk, float* __restrict__ dv, const BwdArgs a) {
  using C = Bwd<D>;
  constexpr int LD = C::LD, VW = C::VW, NM = C::NM;
  extern __shared__ float4 bwd_smem[];  // 16-byte aligned rows
  float* Ks = reinterpret_cast<float*>(bwd_smem);  // [BB][LD]
  float* Vs = Ks + BB * LD;
  float* Qs = Vs + BB * LD;          // two stages of [BB][LD]
  float* dOs = Qs + 2 * BB * LD;     // two stages
  float* Ps = dOs + 2 * BB * LD;     // [BB][kPS], S then P, [q][k]
  float* dSs = Ps + BB * kPS;        // [BB][kPS], dP then dS, [q][k]
  float* rows_s = dSs + BB * kPS;    // two stages of lse[BB], delta[BB]

  // the first KV tiles are seen by the most q tiles: they start first
  const int k0 = blockIdx.y * BB, hk = blockIdx.x % a.Hkv, b = blockIdx.x / a.Hkv;
  const int G = a.Hq / a.Hkv;
  const long long kv_off = ((long long)b * a.Hkv + hk) * a.Sk * D;
  // the q rows that see a key of this tile: from the diagonal (causal) to
  // the window's reach of its last key
  const int lo_q = a.causal ? k0 : 0;
  int hi_q = a.Sq;
  if (a.window > 0) hi_q = min(hi_q, k0 + BB - 1 + a.window);
  const int qt_lo = lo_q / BB;
  const int nqt = hi_q > lo_q ? (hi_q + BB - 1) / BB - qt_lo : 0;
  const int n = G * nqt;

  auto stage = [&](int i) {  // tile i's q side into buffer i % 2
    const int h = hk * G + i / nqt, q0 = (qt_lo + i % nqt) * BB, st = i & 1;
    const long long bh = (long long)b * a.Hq + h;
    stage_async<D>(Qs + st * BB * LD, q + bh * a.Sq * D, q0, a.Sq);
    stage_async<D>(dOs + st * BB * LD, dout + bh * a.Sq * D, q0, a.Sq);
    stage_rows_async(rows_s + st * 2 * BB, rows_s + st * 2 * BB + BB, a, bh * a.Sq_pad + q0);
  };
  stage_async<D>(Ks, k + kv_off, k0, a.Sk);
  stage_async<D>(Vs, v + kv_off, k0, a.Sk);
  if (n > 0) stage(0);
  cp_async_commit();

  const int half = threadIdx.x >> 7;
  const ScoreLane L;
  // accumulation: keys 4 kb .. 4 kb + 3, dims VW db + 16 VW m
  const int lane = threadIdx.x & 31;
  const int kb = lane >> 2, db = 4 * ((threadIdx.x & 127) >> 5) + (lane & 3);
  float acc[4][NM * VW];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NM * VW; ++c) acc[r][c] = 0.f;

  for (int i = 0; i < n; ++i) {
    hopper::cp_async_wait<0>();
    __syncthreads();  // tile i landed; every reader of tile i - 1 is done
    if (i + 1 < n) stage(i + 1);
    cp_async_commit();
    const int st = i & 1, q0 = (qt_lo + i % nqt) * BB;
    const float* Qt = Qs + st * BB * LD;
    const float* dOt = dOs + st * BB * LD;
    const float* lse_s = rows_s + st * 2 * BB;
    // half 0: S = Q K^T into Ps; half 1: dP = dO V^T into dSs
    float s[4][4];
    score_block<D>(s, half == 0 ? Qt : dOt, half == 0 ? Ks : Vs, L.qb, L.kb, L.sp);
    write_block<false>(s, L, half == 0 ? Ps : dSs);
    __syncthreads();
    p_and_ds<false>(a, Ps, dSs, lse_s, lse_s + BB, q0, k0);
    __syncthreads();  // P and dS complete
    // half 0: dV[j] += P[i, j] dO[i]; half 1: dK[j] += dS[i, j] Q[i]
    const float* W = half == 0 ? Ps : dSs;
    const float* X = half == 0 ? dOt : Qt;
#pragma unroll 4
    for (int r = 0; r < BB; ++r) {
      const float4 w = load4(W + r * kPS + 4 * kb);
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        float x[VW];
        lds<VW>(x, X + r * LD + VW * db + 16 * VW * m);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          acc[0][m * VW + e] = fmaf(w.x, x[e], acc[0][m * VW + e]);
          acc[1][m * VW + e] = fmaf(w.y, x[e], acc[1][m * VW + e]);
          acc[2][m * VW + e] = fmaf(w.z, x[e], acc[2][m * VW + e]);
          acc[3][m * VW + e] = fmaf(w.w, x[e], acc[3][m * VW + e]);
        }
      }
    }
  }
  float* out = half == 0 ? dv : dk;
  const float mul = half == 0 ? 1.f : a.scale;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kr = k0 + 4 * kb + r;
    if (kr >= a.Sk) continue;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      float o4[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) o4[e] = acc[r][m * VW + e] * mul;
      store_vec<VW>(out + kv_off + (long long)kr * D + VW * db + 16 * VW * m, o4);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, Bwd<D>::MIN_BLOCKS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    float* __restrict__ dq, const BwdArgs a) {
  using C = Bwd<D>;
  constexpr int LD = C::LD, VW = C::VWQ, NM = C::NMQ;
  extern __shared__ float4 bwd_smem[];
  float* Qs = reinterpret_cast<float*>(bwd_smem);  // [BB][LD]
  float* dOs = Qs + BB * LD;
  float* Ks = dOs + BB * LD;          // two stages of [BB][LD]
  float* Vs = Ks + 2 * BB * LD;       // two stages
  float* Ss = Vs + 2 * BB * LD;       // [BB][kPS], S transposed: [k][q]
  float* dSs = Ss + BB * kPS;         // [BB][kPS], dP then dS, transposed
  float* rows_s = dSs + BB * kPS;     // lse[BB], delta[BB]

  // the last q tiles see the most keys: they start first
  const int q0 = ((a.Sq + BB - 1) / BB - 1 - (int)blockIdx.y) * BB;
  const int h = blockIdx.x % a.Hq, b = blockIdx.x / a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const long long bh = (long long)b * a.Hq + h;
  const long long kv_off = ((long long)b * a.Hkv + hk) * a.Sk * D;
  // the keys this tile's rows see: up to the diagonal of its last row, back
  // to the window of its first
  const int hi_k = a.causal ? min(a.Sk, q0 + BB) : a.Sk;
  const int lo_k = a.window > 0 ? max(q0 - a.window + 1, 0) : 0;
  const int kt_lo = lo_k / BB;
  const int n = hi_k > lo_k ? (hi_k + BB - 1) / BB - kt_lo : 0;

  auto stage = [&](int i) {
    const int kr0 = (kt_lo + i) * BB, st = i & 1;
    stage_async<D>(Ks + st * BB * LD, k + kv_off, kr0, a.Sk);
    stage_async<D>(Vs + st * BB * LD, v + kv_off, kr0, a.Sk);
  };
  stage_async<D>(Qs, q + bh * a.Sq * D, q0, a.Sq);
  stage_async<D>(dOs, dout + bh * a.Sq * D, q0, a.Sq);
  stage_rows_async(rows_s, rows_s + BB, a, bh * a.Sq_pad + q0);
  if (n > 0) stage(0);
  cp_async_commit();

  const int half = threadIdx.x >> 7;
  const ScoreLane L;
  // accumulation: rows 4 qb .. 4 qb + 3, dims VW db + 32 VW m
  const int qb = threadIdx.x & 7, db = threadIdx.x >> 3;
  float acc[4][NM * VW];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NM * VW; ++c) acc[r][c] = 0.f;

  for (int i = 0; i < n; ++i) {
    hopper::cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n) stage(i + 1);
    cp_async_commit();
    const int st = i & 1, k0 = (kt_lo + i) * BB;
    const float* Kt = Ks + st * BB * LD;
    const float* Vt = Vs + st * BB * LD;
    // half 0: S = Q K^T, half 1: dP = dO V^T, both as [k][q]
    float s[4][4];
    score_block<D>(s, half == 0 ? Qs : dOs, half == 0 ? Kt : Vt, L.qb, L.kb, L.sp);
    write_block<true>(s, L, half == 0 ? Ss : dSs);
    __syncthreads();
    p_and_ds<true>(a, Ss, dSs, rows_s, rows_s + BB, q0, k0);
    __syncthreads();  // dS complete
    // dQ[i] += dS[i, j] K[j]
#pragma unroll 4
    for (int j = 0; j < BB; ++j) {
      const float4 w = load4(dSs + j * kPS + 4 * qb);
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        if (VW * db + 32 * VW * m >= D) continue;  // past D: whole warps
        float x[VW];
        lds<VW>(x, Kt + j * LD + VW * db + 32 * VW * m);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          acc[0][m * VW + e] = fmaf(w.x, x[e], acc[0][m * VW + e]);
          acc[1][m * VW + e] = fmaf(w.y, x[e], acc[1][m * VW + e]);
          acc[2][m * VW + e] = fmaf(w.z, x[e], acc[2][m * VW + e]);
          acc[3][m * VW + e] = fmaf(w.w, x[e], acc[3][m * VW + e]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qr = q0 + 4 * qb + r;
    if (qr >= a.Sq) continue;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      if (VW * db + 32 * VW * m >= D) continue;
      float o4[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) o4[e] = acc[r][m * VW + e] * a.scale;
      store_vec<VW>(dq + (bh * a.Sq + qr) * D + VW * db + 32 * VW * m, o4);
    }
  }
}

// --- the tensor-core route (bfloat16) ----------------------------------------

constexpr int kBr = 64;  // q rows and keys of a tensor-core backward tile

template <int D>
struct TcB {
  static constexpr int SPAN = D >= 64 ? 128 : 64;  // swizzle span, bytes
  static constexpr int CW = SPAN / 2;              // bf16 columns per chunk
  // D in whole chunks, as the forward's Tc<D>::DP: columns past D are TMA's
  // zeros, which add nothing to the products over D, and the accumulators'
  // columns past D are never stored
  static constexpr int DP = (D + CW - 1) / CW * CW;
  static constexpr int NC = DP / CW;               // chunks per row
  static constexpr int TILE = kBr * DP * 2;        // bytes of a 64-row tile
  static constexpr int CHUNK = kBr * SPAN;         // bytes of one of its chunks
  static constexpr int ROWS = 2 * kBr * 4;         // lse and delta of a q tile
  static constexpr int XCH = 32 * 128 * 4;         // P': 32 f32 a consumer thread
  // dK/dV: K, V, two stages of Q and dO and of their rows, the P' exchange,
  // 5 barriers, slack to align the tiles to 1024 B
  static constexpr size_t SMEM_KV =
      2 * TILE + 2 * kStages * TILE + kStages * ROWS + XCH + 64 + 1024;
  // dQ: two consumer warpgroups of 64 q rows each; KV tiles of BKQ keys (32
  // at D = 256, where two 64-key stages of K and V would not fit beside Q
  // and dO of 128 rows)
  static constexpr int NQ = 2;
  static constexpr int BKQ = D == 256 ? 32 : 64;
  static constexpr int KTILE = BKQ * DP * 2;
  static constexpr int KCHUNK = BKQ * SPAN;
  static constexpr size_t SMEM_Q = 2 * NQ * TILE + 2 * kStages * KTILE + 64 + 1024;
  static_assert(SMEM_KV <= 232448 && SMEM_Q <= 232448, "backward tiles exceed shared memory");
};

struct TcBwdArgs {
  BwdArgs m;
  __nv_bfloat16 *dq, *dk, *dv;
  float s_log2;    // 1/sqrt(D) * log2(e)
  float s_cap;     // 2/(sqrt(D) * cap) * log2(e): exponent of exp(2u) in tanh(u)
};

// P (natural: exp(x - lse)) and the softcap's derivative of a raw score
template <bool SOFTCAP>
__device__ __forceinline__ float tc_p(const TcBwdArgs& a, float raw, float lse2, float& dcap) {
  if (SOFTCAP) {
    const float ex = exp2_approx(raw * a.s_cap);
    const float th = 1.f - __fdividef(2.f, ex + 1.f);  // tanh(raw / (sqrt(D) cap))
    dcap = 1.f - th * th;
    return exp2_approx(fmaf(a.m.softcap * kLog2e, th, -lse2));
  }
  dcap = 1.f;
  return exp2_approx(fmaf(raw, a.s_log2, -lse2));
}

// K-major operand descriptor of k16 slice kk of a tile at `tile` whose
// column chunks are `chunk` bytes apart
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk, int chunk = TcB<D>::CHUNK) {
  using C = TcB<D>;
  const int c = kk / (C::CW / 16), w = kk % (C::CW / 16);
  return hopper::make_desc(tile + c * chunk + 32 * w, 16, 8 * C::SPAN, C::SPAN);
}

// MN-major (B, N = D) descriptor of rows 16 kk .. 16 kk + 15 of such a tile
template <int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk, int chunk = TcB<D>::CHUNK) {
  using C = TcB<D>;
  return hopper::make_desc(tile + kk * 16 * C::SPAN, chunk, 8 * C::SPAN, C::SPAN);
}

// a 64 x D f32 accumulator (rows `row0` + 16 warp + g (+ 8); DP >= D columns,
// those past D not stored) into bf16 rows [.., S) of a contiguous [rows, D]
// array, times `mul`
template <int D, int DP>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, const float (&acc)[DP / 2], int row0,
                                          int S, float mul) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * warp + g + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * D + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// the dK/dV pass's consumers: warpgroup 1 (dV) or 2 (dK)
template <int D, bool SOFTCAP>
__device__ __forceinline__ void tc_dkdv_consume(const TcBwdArgs& a, uint32_t sK, uint32_t sV,
                                                uint32_t sQ, uint32_t sdO, const float* rows_g,
                                                float* xch, uint32_t bars, int wg, int k0, int hk,
                                                int b, int qt_lo, int nqt, int n) {
  using C = TcB<D>;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kpos[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  constexpr int DP = C::DP;
  float acc[DP / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) acc[e] = 0.f;

  hopper::mbar_wait(bars, 0);  // K and V
  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    const uint32_t full = bars + 8 + 8 * st, empty = bars + 24 + 8 * st;
    const int q0 = (qt_lo + i % nqt) * kBr;
    const uint32_t qt = sQ + st * C::TILE, dot = sdO + st * C::TILE;
    const float* lse_s = rows_g + st * (C::ROWS / 4);
    hopper::mbar_wait(full, ph);
    float s[32];
    uint32_t frag[4][4];
    if (wg == 1) {
      // S^T = K Q^T
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss_n64(s, kmajor<D>(sK, kk), kmajor<D>(qt, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      // P^T in s, P' to the exchange (after warpgroup 2 has read the last)
      if (i > 0) hopper::named_barrier(2, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * t + c;
          const float lse2 = lse_s[col] * kLog2e;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 4 * j + 2 * r + c;
            float dcap;
            const float p = tc_p<SOFTCAP>(a, s[e], lse2, dcap);
            const bool ok = visible(a.m, q0 + col, kpos[r]);
            s[e] = ok ? p : 0.f;
            xch[e * 128 + tid] = ok ? p * dcap : 0.f;
          }
        }
      hopper::named_barrier_arrive(1, 256);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) frag[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      // dV += P^T dO
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::Wgmma<DP>::rs_tb(acc, frag[kk], mnmajor<D>(dot, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    } else {
      // dP^T = V dO^T
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss_n64(s, kmajor<D>(sV, kk), kmajor<D>(dot, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      // dS^T = P' (dP^T - delta)
      hopper::named_barrier(1, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float dl = lse_s[kBr + 8 * j + 2 * t + c];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 4 * j + 2 * r + c;
            s[e] = xch[e * 128 + tid] * (s[e] - dl);
          }
        }
      if (i + 1 < n) hopper::named_barrier_arrive(2, 256);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) frag[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      // dK += dS^T Q
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::Wgmma<DP>::rs_tb(acc, frag[kk], mnmajor<D>(qt, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty);
  }
  const long long kv_row = ((long long)b * a.m.Hkv + hk) * a.m.Sk;
  if (wg == 1) store_acc<D, DP>(a.dv + kv_row * D, acc, k0, a.m.Sk, 1.f);
  else store_acc<D, DP>(a.dk + kv_row * D, acc, k0, a.m.Sk, a.m.scale);
}

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_tc_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, const TcBwdArgs a) {
  using C = TcB<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u;  // swizzled tiles start 1024-aligned
  uint8_t* gK = smem_raw + (sK - raw);
  const uint32_t sV = sK + C::TILE, sQ = sV + C::TILE, sdO = sQ + kStages * C::TILE;
  const uint32_t sRows = sdO + kStages * C::TILE, sX = sRows + kStages * C::ROWS;
  // barriers: kv_full, full[2], empty[2]
  const uint32_t bars = sX + C::XCH;

  // lightest KV tiles last: the first keys are seen by the most q tiles
  const int kt = blockIdx.y;
  const int hk = blockIdx.x % a.m.Hkv, b = blockIdx.x / a.m.Hkv;
  const int G = a.m.Hq / a.m.Hkv;
  const int k0 = kt * kBr;
  const int lo_q = a.m.causal ? k0 : 0;
  int hi_q = a.m.Sq;
  if (a.m.window > 0) hi_q = min(hi_q, k0 + kBr - 1 + a.m.window);
  const int qt_lo = lo_q / kBr;
  const int nqt = hi_q > lo_q ? (hi_q + kBr - 1) / kBr - qt_lo : 0;
  const int n = G * nqt;

  if (threadIdx.x == 0) {
    hopper::mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bars + 8 + 8 * s, 1);
      hopper::mbar_init(bars + 24 + 8 * s, 8);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch(&tq);
      hopper::tma_prefetch(&tdo);
      hopper::mbar_expect_tx(bars, 2 * C::TILE);
      for (int c = 0; c < C::NC; ++c) {
        hopper::tma_load_4d(sK + c * C::CHUNK, &tk, bars, c * C::CW, k0, hk, b);
        hopper::tma_load_4d(sV + c * C::CHUNK, &tv, bars, c * C::CW, k0, hk, b);
      }
      for (int i = 0; i < n; ++i) {
        const int st = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const uint32_t full = bars + 8 + 8 * st;
        const int h = hk * G + i / nqt, q0 = (qt_lo + i % nqt) * kBr;
        hopper::mbar_wait(bars + 24 + 8 * st, ph ^ 1);  // stage released
        hopper::mbar_expect_tx(full, 2 * C::TILE + C::ROWS);
        for (int c = 0; c < C::NC; ++c) {
          hopper::tma_load_4d(sQ + st * C::TILE + c * C::CHUNK, &tq, full, c * C::CW, q0, h, b);
          hopper::tma_load_4d(sdO + st * C::TILE + c * C::CHUNK, &tdo, full, c * C::CW, q0, h, b);
        }
        const long long row = ((long long)b * a.m.Hq + h) * a.m.Sq_pad + q0;
        hopper::bulk_load(sRows + st * C::ROWS, a.m.lse_pad + row, C::ROWS / 2, full);
        hopper::bulk_load(sRows + st * C::ROWS + C::ROWS / 2, a.m.delta_pad + row, C::ROWS / 2, full);
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    tc_dkdv_consume<D, SOFTCAP>(a, sK, sV, sQ, sdO,
                                reinterpret_cast<const float*>(gK + (sRows - sK)),
                                reinterpret_cast<float*>(gK + (sX - sK)), bars, wg, k0, hk, b,
                                qt_lo, nqt, n);
  }
}

// the dQ pass's consumer warpgroup `cw`: q rows r0 .. r0 + 63
template <int D, bool SOFTCAP>
__device__ __forceinline__ void tc_dq_consume(const TcBwdArgs& a, uint32_t sQ, uint32_t sdO,
                                              uint32_t sK, uint32_t sV, uint32_t bars, int cw,
                                              int q0, int h, int b, int kt_lo, int ntiles) {
  using C = TcB<D>;
  constexpr int BK = C::BKQ;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + kBr * cw;
  const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
  const long long bh = (long long)b * a.m.Hq + h;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < a.m.Sq;
    lse2[r] = in ? a.m.lse_pad[bh * a.m.Sq_pad + row[r]] * kLog2e : 0.f;
    dl[r] = in ? a.m.delta_pad[bh * a.m.Sq_pad + row[r]] : 0.f;
  }
  const bool has_rows = r0 < a.m.Sq;
  const int r_last = min(r0 + kBr - 1, a.m.Sq - 1);
  // this warpgroup's keys: [lo_k, hi_k)
  const int lo_k = a.m.window > 0 ? max(r0 - a.m.window + 1, 0) : 0;
  const int hi_k = !has_rows ? 0 : a.m.causal ? min(a.m.Sk, r_last + 1) : a.m.Sk;
  const uint32_t qt = sQ + cw * C::TILE, dot = sdO + cw * C::TILE;
  constexpr int DP = C::DP;
  float acc[DP / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) acc[e] = 0.f;

  hopper::mbar_wait(bars, 0);  // Q and dO
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    const uint32_t k_full = bars + 8 + 8 * st, v_full = bars + 24 + 8 * st;
    const uint32_t empty = bars + 40 + 8 * st;
    const int k0 = (kt_lo + i) * BK;
    const uint32_t kt = sK + st * C::KTILE, vt = sV + st * C::KTILE;
    hopper::mbar_wait(k_full, ph);
    hopper::mbar_wait(v_full, ph);
    if (k0 < hi_k && k0 + BK > lo_k) {
      // S = Q K^T and dP = dO V^T, one group
      float s[BK / 2], dp[BK / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::Wgmma<BK>::ss(s, kmajor<D>(qt, kk), kmajor<D>(kt, kk, C::KCHUNK), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::Wgmma<BK>::ss(dp, kmajor<D>(dot, kk), kmajor<D>(vt, kk, C::KCHUNK), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      // dS = P (dP - delta) (1 - (s / cap)^2), masked
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kp = k0 + 8 * j + 2 * t + c;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 4 * j + 2 * r + c;
            float dcap;
            const float p = tc_p<SOFTCAP>(a, s[e], lse2[r], dcap);
            s[e] = visible(a.m, row[r], kp) ? p * dcap * (dp[e] - dl[r]) : 0.f;
          }
        }
      uint32_t frag[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) frag[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      // dQ += dS K, K MN-major
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hopper::Wgmma<DP>::rs_tb(acc, frag[kk], mnmajor<D>(kt, kk, C::KCHUNK), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty);
  }
  if (has_rows) store_acc<D, DP>(a.dq + bh * a.m.Sq * D, acc, r0, a.m.Sq, a.m.scale);
}

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_tc_dq_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, const TcBwdArgs a) {
  using C = TcB<D>;
  constexpr int NQ = C::NQ, R = NQ * kBr, BK = C::BKQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sdO = sQ + NQ * C::TILE, sK = sdO + NQ * C::TILE;
  const uint32_t sV = sK + kStages * C::KTILE;
  // barriers: q_full, k_full[2], v_full[2], empty[2]
  const uint32_t bars = sV + kStages * C::KTILE;

  // heaviest q tiles first: block rows of the grid run in order
  const int nqt = (a.m.Sq + R - 1) / R;
  const int qt = nqt - 1 - (int)blockIdx.y;
  const int h = blockIdx.x % a.m.Hq, b = blockIdx.x / a.m.Hq;
  const int hk = h / (a.m.Hq / a.m.Hkv);
  const int q0 = qt * R;
  const int q_last = min(q0 + R, a.m.Sq) - 1;
  const int hi_k = a.m.causal ? min(a.m.Sk, q_last + 1) : a.m.Sk;
  const int lo_k = a.m.window > 0 ? max(q0 - a.m.window + 1, 0) : 0;
  const int kt_lo = lo_k / BK;
  const int ntiles = max((hi_k + BK - 1) / BK - kt_lo, 0);

  if (threadIdx.x == 0) {
    hopper::mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bars + 8 + 8 * s, 1);
      hopper::mbar_init(bars + 24 + 8 * s, 1);
      hopper::mbar_init(bars + 40 + 8 * s, 4 * NQ);  // one arrival per consumer warp
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
      hopper::mbar_expect_tx(bars, 2 * NQ * C::TILE);
      for (int cw = 0; cw < NQ; ++cw)
        for (int c = 0; c < C::NC; ++c) {
          hopper::tma_load_4d(sQ + cw * C::TILE + c * C::CHUNK, &tq, bars, c * C::CW,
                              q0 + kBr * cw, h, b);
          hopper::tma_load_4d(sdO + cw * C::TILE + c * C::CHUNK, &tdo, bars, c * C::CW,
                              q0 + kBr * cw, h, b);
        }
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const uint32_t k_full = bars + 8 + 8 * st, v_full = bars + 24 + 8 * st;
        const int k0 = (kt_lo + i) * BK;
        hopper::mbar_wait(bars + 40 + 8 * st, ph ^ 1);  // stage released
        hopper::mbar_expect_tx(k_full, C::KTILE);
        for (int c = 0; c < C::NC; ++c)
          hopper::tma_load_4d(sK + st * C::KTILE + c * C::KCHUNK, &tk, k_full, c * C::CW, k0, hk,
                              b);
        hopper::mbar_expect_tx(v_full, C::KTILE);
        for (int c = 0; c < C::NC; ++c)
          hopper::tma_load_4d(sV + st * C::KTILE + c * C::KCHUNK, &tv, v_full, c * C::CW, k0, hk,
                              b);
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    tc_dq_consume<D, SOFTCAP>(a, sQ, sdO, sK, sV, bars, wg - 1, q0, h, b, kt_lo, ntiles);
  }
}

// --- launches ------------------------------------------------------------------

template <typename T>
cudaError_t launch_bwd_delta(const void* o, const void* dout, const float* lse, float* scratch,
                             int B, const BwdArgs& a, int D, cudaStream_t stream) {
  const long long rows_pad = (long long)B * a.Hq * a.Sq_pad;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows_pad + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, scratch, scratch + rows_pad,
      rows_pad, a.Sq, a.Sq_pad, D);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                           void* dq, void* dk, void* dv, int B, const BwdArgs& a,
                           cudaStream_t stream) {
  constexpr size_t smem = Bwd<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  if (a.Sk > 0) {
    flash_bwd_dkdv_kernel<D><<<dim3(B * a.Hkv, (a.Sk + BB - 1) / BB), kThreads, smem, stream>>>(
        qp, kp, vp, dop, static_cast<float*>(dk), static_cast<float*>(dv), a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dq_kernel<D><<<dim3(B * a.Hq, (a.Sq + BB - 1) / BB), kThreads, smem, stream>>>(
      qp, kp, vp, dop, static_cast<float*>(dq), a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v, const void* dout,
                          void* dq, void* dk, void* dv, int B, const BwdArgs& m,
                          cudaStream_t stream) {
  using C = TcB<D>;
  constexpr uint64_t E = 2;  // bytes of a bf16
  CUtensorMap tq, tk, tv, tdo, tkq, tvq;  // tkq, tvq: the dQ pass's KV tiles
  const uint64_t qd[4] = {D, (uint64_t)m.Sq, (uint64_t)m.Hq, (uint64_t)B};
  // K and V of Sk = 0 are never read: a one-row tensor keeps the descriptor valid
  const uint64_t sk = m.Sk > 1 ? m.Sk : 1;
  const uint64_t kd[4] = {D, sk, (uint64_t)m.Hkv, (uint64_t)B};
  const uint64_t q_st[3] = {D * E, (uint64_t)m.Sq * D * E, (uint64_t)m.Hq * m.Sq * D * E};
  const uint64_t k_st[3] = {D * E, sk * D * E, (uint64_t)m.Hkv * sk * D * E};
  if (!hopper::encode_bf16_4d(&tq, q, qd, q_st, C::CW, kBr, C::SPAN) ||
      !hopper::encode_bf16_4d(&tdo, dout, qd, q_st, C::CW, kBr, C::SPAN) ||
      !hopper::encode_bf16_4d(&tk, k, kd, k_st, C::CW, kBr, C::SPAN) ||
      !hopper::encode_bf16_4d(&tv, v, kd, k_st, C::CW, kBr, C::SPAN) ||
      !hopper::encode_bf16_4d(&tkq, k, kd, k_st, C::CW, C::BKQ, C::SPAN) ||
      !hopper::encode_bf16_4d(&tvq, v, kd, k_st, C::CW, C::BKQ, C::SPAN))
    return cudaErrorInvalidValue;
  const bool cap = m.softcap > 0.f;
  const auto dkdv = cap ? flash_bwd_tc_dkdv_kernel<D, true> : flash_bwd_tc_dkdv_kernel<D, false>;
  const auto dqk = cap ? flash_bwd_tc_dq_kernel<D, true> : flash_bwd_tc_dq_kernel<D, false>;
  cudaError_t err =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM_KV);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM_Q);
  if (err != cudaSuccess) return err;
  TcBwdArgs a{m, static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
              static_cast<__nv_bfloat16*>(dv), m.scale * kLog2e,
              cap ? 2.f * m.scale / m.softcap * kLog2e : 0.f};
  if (m.Sk > 0) {
    dkdv<<<dim3(B * m.Hkv, (m.Sk + kBr - 1) / kBr), kTcThreads, C::SMEM_KV, stream>>>(tq, tk, tv,
                                                                                      tdo, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dqk<<<dim3(B * m.Hq, (m.Sq + C::NQ * kBr - 1) / (C::NQ * kBr)), kTcThreads, C::SMEM_Q,
        stream>>>(tq, tkq, tvq, tdo, a);
  return cudaGetLastError();
}

cudaError_t dispatch_bwd(int D, bool bf16, const void* q, const void* k, const void* v,
                         const void* dout, void* dq, void* dk, void* dv, int B, const BwdArgs& a,
                         cudaStream_t s) {
  switch (D) {
    case 32: return bf16 ? launch_bwd_tc<32>(q, k, v, dout, dq, dk, dv, B, a, s)
                         : launch_bwd_f32<32>(q, k, v, dout, dq, dk, dv, B, a, s);
    case 64: return bf16 ? launch_bwd_tc<64>(q, k, v, dout, dq, dk, dv, B, a, s)
                         : launch_bwd_f32<64>(q, k, v, dout, dq, dk, dv, B, a, s);
    case 80: return bf16 ? launch_bwd_tc<80>(q, k, v, dout, dq, dk, dv, B, a, s)
                         : launch_bwd_f32<80>(q, k, v, dout, dq, dk, dv, B, a, s);
    case 128: return bf16 ? launch_bwd_tc<128>(q, k, v, dout, dq, dk, dv, B, a, s)
                          : launch_bwd_f32<128>(q, k, v, dout, dq, dk, dv, B, a, s);
    case 192: return bf16 ? launch_bwd_tc<192>(q, k, v, dout, dq, dk, dv, B, a, s)
                          : launch_bwd_f32<192>(q, k, v, dout, dq, dk, dv, B, a, s);
    case 256: return bf16 ? launch_bwd_tc<256>(q, k, v, dout, dq, dk, dv, B, a, s)
                          : launch_bwd_f32<256>(q, k, v, dout, dq, dk, dv, B, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace


// q: [B, Hq, Sq, D], k/v: [B, Hkv, Sk, D] with unit stride along D and the given
// element strides for batch, head and sequence; o: contiguous [B, Hq, Sq, D];
// lse: null, or contiguous f32 [B, Hq, Sq] that receives each row's natural-log
// log-sum-exp of its scaled (and capped) scores, which the backward reads.
// D in {32, 64, 80, 128, 192, 256}; dtype codes: 0 = float32 (CUDA cores: pointers
// 16-byte aligned and every stride a multiple of 4 elements, for the 16-byte
// cp.async copies), 1 = bfloat16 (tensor cores: pointers 16-byte aligned and
// every stride a multiple of 8 elements, as TMA needs). A row that sees no key
// gets o = 0 and lse = +inf. window <= 0 means no window; softcap <= 0 means no
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
  if (dtype == kF32) {
    // rows move as 16-byte cp.async copies
    const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
    const long long strides[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
    if (ptrs % 16) return (int)cudaErrorInvalidValue;
    for (long long st : strides)
      if (st < 0 || st % 4) return (int)cudaErrorInvalidValue;
    return (int)dispatch_f32(D, q, k, v, o, static_cast<float*>(lse), B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
  }
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
// forward's f32 [B, Hq, Sq]; scratch: f32 [2, B, Hq, Sq_pad], Sq_pad = Sq rounded
// up to a multiple of 64 (16-byte aligned), which receives lse and delta in
// padded rows. All of one dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor
// cores), accumulated in f32. Returns the first failing launch's cudaError_t (0
// on success); the three kernels run asynchronously on `stream`.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* scratch, void* dq, void* dk, void* dv, int B,
                                         int Hq, int Hkv, int Sq, int Sk, int D, int causal,
                                         int window, float softcap, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Sk < 0 || Hq > 65535 || B > 65535 || Sk > 65535 * BB ||
      Sq > 65535 * BB ||
      (D != 32 && D != 64 && D != 80 && D != 128 && D != 192 && D != 256) ||
      (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  // the f32 tiles move as 16-byte copies; TMA and the bulk copies need 16 bytes
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)dout |
       (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv | (uintptr_t)scratch) % 16)
    return (int)cudaErrorInvalidValue;
  const int Sq_pad = (Sq + kPadRows - 1) / kPadRows * kPadRows;
  float* pad = static_cast<float*>(scratch);
  const long long rows_pad = (long long)B * Hq * Sq_pad;
  const BwdArgs a{pad, pad + rows_pad, Hq, Hkv, Sq, Sk, Sq_pad, causal, window, softcap,
                  1.f / sqrtf((float)D)};
  const float* l = static_cast<const float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == kF32
                              ? launch_bwd_delta<float>(o, dout, l, pad, B, a, D, s)
                              : launch_bwd_delta<__nv_bfloat16>(o, dout, l, pad, B, a, D, s);
  if (err != cudaSuccess) return (int)err;
  return (int)dispatch_bwd(D, dtype == kBF16, q, k, v, dout, dq, dk, dv, B, a, s);
}
