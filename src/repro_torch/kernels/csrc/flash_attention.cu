// Forward flash attention for Hopper (sm_90a): blocked causal attention with an
// online softmax, GQA, tanh logit softcap and a sliding window.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (kernel body :54-91, pallas_call at :93). Same arithmetic: scores scaled by
// 1/sqrt(D), softcap before the mask, top-left causal mask (q_pos starts at 0 even
// when Sq != Sk), window rule q - k < w, masked scores at -1e30, f32 accumulation,
// output in q's type. K tiles outside the causal diagonal and left of the window
// are skipped (the loop bounds of flash_attention.py:84-86).
//
// Bound on the card: at gemma2-9b prefill, (B, Hq, Hkv, S, D) = (4, 16, 8, 1000, 256)
// causal, it reads q, k, v and writes o (~98 MB, >= 29 us at 3.35 TB/s) and does
// ~3.3e10 flops (>= 33 us at 989 TFLOP/s in bf16), so operations bound it. This
// first version does its products on the f32 CUDA cores, not the tensor cores
// (wgmma/mma.sync and TMA are later work), so it sits far above that bound.
//
// Design. One block of 256 threads per (q tile of 64 rows, q head, batch). The Q
// tile is staged once in shared memory as f32 (pre-scaled); K and V stream through
// shared memory 32 keys at a time. At D = 256 the tiles take 137 KB, above the
// 48 KB static limit, so the kernel uses dynamic shared memory raised with
// cudaFuncSetAttribute. Thread (ty, tx) of a 16 x 16 grid owns q rows ty*4..ty*4+3:
// for S = QK^T it computes keys tx and tx+16, for O += PV head dims tx + 16j.
// The 16 threads sharing a row group sit in one half-warp, so row max and row sum
// are reduced with shuffles and the running (m, l) stay in registers. Rows of Q
// and K are padded by one float so the half-warp reads 16 distinct banks. Ragged
// Sq and Sk tails are masked (zero-filled tiles, k < Sk in the mask), so no shape
// needs to divide the tiles. The kv head of q head h is h / (Hq / Hkv).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

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
// D in {32, 64, 128, 256}; dtype codes: 0 = float32, 1 = bfloat16. window <= 0
// means no window; softcap <= 0 means no softcap. Returns the launch's
// cudaError_t (0 on success); the kernel runs asynchronously on `stream`.
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
  if (dtype == kBF16)
    return (int)dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Hq, Hkv, Sq, Sk, qs, ks, vs, causal, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
