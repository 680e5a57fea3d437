// Grouped matmul for Hopper (sm_90a), the MoE expert FFN: rows of x [T, D]
// are sorted by expert, expert e owns the next group_sizes[e] rows, and
// out[t] = x[t] @ w[e(t)] for w [E, D, F], with f32 accumulation and the
// output in x's dtype (bfloat16 or float32, x and w of one dtype, all
// contiguous). Rows past sum(group_sizes) belong to no expert (the MoE
// layer's dropped slots) and are written as zeros.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py::moe_gmm
// (`_gmm_kernel`, pallas_call at :54). That kernel takes each row tile's
// expert from a searchsorted over tile starts, so a tile that straddles two
// experts is multiplied by the wrong one unless every group size is a
// multiple of its tile (only t % block_t is asserted, :45). Here every block
// maps itself to (expert, row tile) from the group sizes, which stay on the
// device: the grid has ceil(T/BM) + E + 1 row slots (each expert's last tile
// may be partial, and the rows past the groups are one more region), every
// block reads the E sizes into shared memory and walks them to find its
// slot, and surplus blocks exit. So any sizes work (0, 1, not a multiple of
// the tile, all rows in one expert), and the host never reads them: no copy
// to the host stalls it once per layer, and the decode step stays capturable
// into a CUDA graph.
//
// Bound on the card. Prefill (mixtral-8x7b, batch 4 x 1024 tokens, top-2):
// x [8192, 4096] @ w [8, 4096, 14336] is 9.62e11 flops, 0.97 ms at the bf16
// tensor-core peak, against 0.37 ms to move its bytes: operations. Decode
// (8 rows): reading the weights of the experts used (~5.5 of 8, 0.65 GB) is
// ~0.19 ms: bytes.
// Design, bf16: warp-level tensor-core products (wmma 16x16x16, bf16 in, f32
// accumulators in registers). A block computes a BM x BN output tile,
// walking D in BK-deep slices of x and w staged through shared memory. Many
// rows an expert (prefill, widths a multiple of 8): 128 x 128 tiles of 4
// warps, each 64 x 64 (16 accumulator fragments: 4 + 4 fragment loads feed
// 16 products), with a 4-stage cp.async ring, so three 32-deep slices are
// in flight while one is multiplied; 80 KB of shared memory and ~240
// registers a thread let 2 blocks share an SM. A few rows an expert
// (decode), or widths that are not a multiple of 8: 16 x 64 x 64 tiles of
// 4 warps, the next slice loaded into registers (16 bytes a thread where
// the widths and pointers allow) while the current one is multiplied; for
// decode the block count and the bytes in flight, not the products,
// decide the time. The accumulators leave through a 16 x 16 f32 scratch
// per warp, masked at the ragged row and column edges.
// float32 takes a plain CUDA-core kernel (64 x 64 tiles, 4 x 4 outputs a
// thread, fmaf), exact to f32 rounding: tensor cores would round its inputs
// to TF32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kMaxExperts = 256;

// This block's work: (expert, first row, rows). Expert e owns rows
// [off_e, off_e + size_e), cut into ceil(size_e / BM) tiles in order; the
// rows past the last group, up to T, form region E (written with zeros).
// A surplus block gets rows == 0. Sizes below 0 count as 0, and the groups
// are cut at T.
template <int BM>
__device__ int3 block_tile(const int* __restrict__ gs, int E, int T) {
  __shared__ int sizes[kMaxExperts];
  __shared__ int3 tile;
  for (int i = threadIdx.x; i < E; i += blockDim.x) sizes[i] = gs[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    int b = blockIdx.x, off = 0;
    int3 t = make_int3(E, 0, 0);
    for (int e = 0; e <= E; ++e) {
      const int size = min(e < E ? max(sizes[e], 0) : T, T - off);
      const int tiles = (size + BM - 1) / BM;
      if (b < tiles) {
        t = make_int3(e, off + b * BM, min(BM, size - b * BM));
        break;
      }
      b -= tiles;
      off += size;
    }
    tile = t;
  }
  __syncthreads();
  return tile;
}

// 8 consecutive 16-bit values of one row, zero outside [0, n) or when the
// row is not valid; one 16-byte load when VEC (widths a multiple of 8,
// 16-byte aligned pointers) and the 8 lie inside the row.
template <bool VEC>
__device__ __forceinline__ uint4 load8(const unsigned short* row, bool valid, int col, int n) {
  if (!valid) return make_uint4(0, 0, 0, 0);
  if (VEC && col + 8 <= n) return *reinterpret_cast<const uint4*>(row + col);
  unsigned v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = col + j < n ? row[col + j] : 0u;
  return make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16), v[4] | (v[5] << 16),
                    v[6] | (v[7] << 16));
}

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// The rows past the groups: zeros in this block's BN columns.
template <int BN>
__device__ __forceinline__ void zero_rows(__nv_bfloat16* out, int row0, int rows, int n0,
                                          int F) {
  for (int i = threadIdx.x; i < rows * BN; i += blockDim.x) {
    const int r = i / BN, c = n0 + i % BN;
    if (c < F) out[(int64_t)(row0 + r) * F + c] = __float2bfloat16(0.f);
  }
}

// A warp's accumulators, whose first element is row lr0 of the block's
// rows and column col0, through the warp's 16 x 16 f32 scratch cs into out
// as bf16, masked at the last row and column.
template <int FRAG_M, int FRAG_N>
__device__ __forceinline__ void store_acc(AccFrag (&acc)[FRAG_M][FRAG_N], float* cs,
                                          __nv_bfloat16* out, int row0, int rows, int lr0,
                                          int col0, int F) {
  const int lane = threadIdx.x % 32, r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FRAG_M; ++i) {
#pragma unroll
    for (int j = 0; j < FRAG_N; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int lr = lr0 + i * 16 + r, col = col0 + j * 16 + c0;
      if (lr < rows) {
        __nv_bfloat16* o = out + (int64_t)(row0 + lr) * F;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          if (col + jj < F) o[col + jj] = __float2bfloat16(cs[r * 16 + c0 + jj]);
      }
      __syncwarp();
    }
  }
}

template <int WARPS_M, int WARPS_N, int FRAG_M, int FRAG_N, int BK, bool VEC>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
gmm_bf16_kernel(const unsigned short* __restrict__ x, const unsigned short* __restrict__ w,
                const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int T, int D,
                int F, int E) {
  constexpr int BM = WARPS_M * FRAG_M * 16, BN = WARPS_N * FRAG_N * 16;
  constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  constexpr int LDA = BK + 8, LDB = BN + 8;  // rows 16 bytes off the banks' period
  constexpr int A_CHUNKS = BM * BK / 8 / THREADS, B_CHUNKS = BK * BN / 8 / THREADS;
  static_assert(A_CHUNKS >= 1 && A_CHUNKS * THREADS * 8 == BM * BK, "A tile split");
  static_assert(B_CHUNKS >= 1 && B_CHUNKS * THREADS * 8 == BK * BN, "B tile split");
  static_assert(BK % 16 == 0, "BK is a multiple of the wmma depth");
  __shared__ __align__(128) unsigned short As[2][BM * LDA];
  __shared__ __align__(128) unsigned short Bs[2][BK * LDB];
  __shared__ __align__(128) float Cs[WARPS_M * WARPS_N][16 * 16];

  const int3 tile = block_tile<BM>(gs, E, T);
  const int e = tile.x, row0 = tile.y, rows = tile.z;
  if (rows <= 0) return;
  const int tid = threadIdx.x, n0 = blockIdx.y * BN;
  if (e == E) {  // rows past the groups
    zero_rows<BN>(out, row0, rows, n0, F);
    return;
  }
  const unsigned short* xb = x + (int64_t)row0 * D;
  const unsigned short* wb = w + (int64_t)e * D * F;
  uint4 ra[A_CHUNKS], rb[B_CHUNKS];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * THREADS, r = c / (BK / 8), k = (c % (BK / 8)) * 8;
      ra[i] = load8<VEC>(xb + (int64_t)r * D, r < rows, k0 + k, D);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * THREADS, r = c / (BN / 8), n = (c % (BN / 8)) * 8;
      rb[i] = load8<VEC>(wb + (int64_t)(k0 + r) * F, k0 + r < D, n0 + n, F);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * THREADS, r = c / (BK / 8), k = (c % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(&As[buf][r * LDA + k]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * THREADS, r = c / (BN / 8), n = (c % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(&Bs[buf][r * LDB + n]) = rb[i];
    }
  };

  const int warp = tid / 32, wm = warp / WARPS_N, wn = warp % WARPS_N;
  AccFrag acc[FRAG_M][FRAG_N];
#pragma unroll
  for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
    for (int j = 0; j < FRAG_N; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (D + BK - 1) / BK;
  if (nk > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * BK);  // in flight during the products
    const __nv_bfloat16* a_s = reinterpret_cast<const __nv_bfloat16*>(As[cur]);
    const __nv_bfloat16* b_s = reinterpret_cast<const __nv_bfloat16*>(Bs[cur]);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[FRAG_M];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[FRAG_N];
#pragma unroll
      for (int i = 0; i < FRAG_M; ++i)
        wmma::load_matrix_sync(af[i], a_s + ((wm * FRAG_M + i) * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FRAG_N; ++j)
        wmma::load_matrix_sync(bf[j], b_s + kk * LDB + (wn * FRAG_N + j) * 16, LDB);
#pragma unroll
      for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
        for (int j = 0; j < FRAG_N; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }
  store_acc(acc, Cs[warp], out, row0, rows, wm * FRAG_M * 16, n0 + wn * FRAG_N * 16, F);
}

// 16 bytes global -> shared without passing through registers; zeros
// when !valid (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Many rows an expert, widths a multiple of 8 and 16-byte aligned pointers
// (the caller checks): the BK-deep slices go through a STAGES-deep ring
// of shared-memory buffers filled with cp.async.
constexpr int kPipeWarpsM = 2, kPipeWarpsN = 2, kPipeFrag = 4, kPipeBK = 32, kPipeStages = 4;
constexpr int kPipeBM = kPipeWarpsM * kPipeFrag * 16, kPipeBN = kPipeWarpsN * kPipeFrag * 16;
constexpr int kPipeThreads = 32 * kPipeWarpsM * kPipeWarpsN;
constexpr int kPipeLDA = kPipeBK + 8, kPipeLDB = kPipeBN + 8;
constexpr int kPipeAStage = kPipeBM * kPipeLDA, kPipeBStage = kPipeBK * kPipeLDB;
constexpr int kPipeSmem =
    kPipeStages * (kPipeAStage + kPipeBStage) * 2 + kPipeWarpsM * kPipeWarpsN * 256 * 4;

__global__ void __launch_bounds__(kPipeThreads, 2)
gmm_bf16_pipe_kernel(const unsigned short* __restrict__ x, const unsigned short* __restrict__ w,
                     const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int T, int D,
                     int F, int E) {
  constexpr int BM = kPipeBM, BN = kPipeBN, BK = kPipeBK, THREADS = kPipeThreads;
  constexpr int LDA = kPipeLDA, LDB = kPipeLDB, STAGES = kPipeStages, FRAG = kPipeFrag;
  constexpr int A_CHUNKS = BM * BK / 8 / THREADS, B_CHUNKS = BK * BN / 8 / THREADS;
  static_assert(A_CHUNKS * THREADS * 8 == BM * BK && B_CHUNKS * THREADS * 8 == BK * BN,
                "tile split");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned short* As = reinterpret_cast<unsigned short*>(smem_raw);
  unsigned short* Bs = As + STAGES * kPipeAStage;
  float* Cs = reinterpret_cast<float*>(Bs + STAGES * kPipeBStage);

  const int3 tile = block_tile<BM>(gs, E, T);
  const int e = tile.x, row0 = tile.y, rows = tile.z;
  if (rows <= 0) return;
  const int tid = threadIdx.x, n0 = blockIdx.y * BN;
  if (e == E) {  // rows past the groups
    zero_rows<BN>(out, row0, rows, n0, F);
    return;
  }
  const unsigned short* xb = x + (int64_t)row0 * D;
  const unsigned short* wb = w + (int64_t)e * D * F;
  auto fetch = [&](int kt) {
    const int k0 = kt * BK, stage = kt % STAGES;
    unsigned short* a_s = As + stage * kPipeAStage;
    unsigned short* b_s = Bs + stage * kPipeBStage;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * THREADS, r = c / (BK / 8), k = (c % (BK / 8)) * 8;
      const bool ok = r < rows && k0 + k < D;
      cp_async16(a_s + r * LDA + k, ok ? xb + (int64_t)r * D + k0 + k : x, ok);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * THREADS, r = c / (BN / 8), n = (c % (BN / 8)) * 8;
      const bool ok = k0 + r < D && n0 + n < F;
      cp_async16(b_s + r * LDB + n, ok ? wb + (int64_t)(k0 + r) * F + n0 + n : w, ok);
    }
  };

  const int warp = tid / 32, wm = warp / kPipeWarpsN, wn = warp % kPipeWarpsN;
  AccFrag acc[FRAG][FRAG];
#pragma unroll
  for (int i = 0; i < FRAG; ++i)
#pragma unroll
    for (int j = 0; j < FRAG; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // Slice kt sits in stage kt % STAGES. Before slice kt is multiplied,
  // wait_group leaves only the STAGES - 2 newest groups in flight, so
  // slice kt has landed; the barrier then shows every thread's copies and
  // frees the stage read in the previous iteration for slice kt+STAGES-1.
  // Every iteration commits one group, empty or not, to keep that count.
  const int nk = (D + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) fetch(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) fetch(kt + STAGES - 1);
    cp_async_commit();
    const int stage = kt % STAGES;
    const __nv_bfloat16* a_s = reinterpret_cast<const __nv_bfloat16*>(As + stage * kPipeAStage);
    const __nv_bfloat16* b_s = reinterpret_cast<const __nv_bfloat16*>(Bs + stage * kPipeBStage);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[FRAG];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[FRAG];
#pragma unroll
      for (int i = 0; i < FRAG; ++i)
        wmma::load_matrix_sync(af[i], a_s + ((wm * FRAG + i) * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FRAG; ++j)
        wmma::load_matrix_sync(bf[j], b_s + kk * LDB + (wn * FRAG + j) * 16, LDB);
#pragma unroll
      for (int i = 0; i < FRAG; ++i)
#pragma unroll
        for (int j = 0; j < FRAG; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  store_acc(acc, Cs + warp * 256, out, row0, rows, wm * FRAG * 16, n0 + wn * FRAG * 16, F);
}

// float32 on CUDA cores: 64 x 64 output tiles, 256 threads of 4 x 4.
constexpr int kF32Tile = 64, kF32K = 16, kF32Threads = 256;

__global__ void __launch_bounds__(kF32Threads)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int* __restrict__ gs, float* __restrict__ out, int T, int D, int F,
               int E) {
  __shared__ float As[kF32K][kF32Tile + 4];  // x slice, transposed: [k][row]
  __shared__ float Bs[kF32K][kF32Tile + 4];
  const int3 tile = block_tile<kF32Tile>(gs, E, T);
  const int e = tile.x, row0 = tile.y, rows = tile.z;
  if (rows <= 0) return;
  const int tid = threadIdx.x, n0 = blockIdx.y * kF32Tile;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  if (e < E) {
    const float* xb = x + (int64_t)row0 * D;
    const float* wb = w + (int64_t)e * D * F;
    for (int k0 = 0; k0 < D; k0 += kF32K) {
#pragma unroll
      for (int i = 0; i < kF32Tile * kF32K / kF32Threads; ++i) {
        const int idx = tid + i * kF32Threads;
        const int m = idx / kF32K, k = idx % kF32K;
        As[k][m] = m < rows && k0 + k < D ? xb[(int64_t)m * D + k0 + k] : 0.f;
        const int kb = idx / kF32Tile, n = idx % kF32Tile;
        Bs[kb][n] = k0 + kb < D && n0 + n < F ? wb[(int64_t)(k0 + kb) * F + n0 + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kF32K; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = As[k][ty * 4 + i];
          b[i] = Bs[k][tx * 4 + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = ty * 4 + i;
    if (lr >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < F) out[(int64_t)(row0 + lr) * F + col] = acc[i][j];  // zeros past the groups
    }
  }
}

template <int WARPS_M, int WARPS_N, int FRAG_M, int FRAG_N, int BK>
cudaError_t launch_bf16(const void* x, const void* w, const int* gs, void* out, int T, int D,
                        int F, int E, bool vec, cudaStream_t stream) {
  constexpr int BM = WARPS_M * FRAG_M * 16, BN = WARPS_N * FRAG_N * 16;
  const dim3 grid((T + BM - 1) / BM + E + 1, (F + BN - 1) / BN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const auto* xs = static_cast<const unsigned short*>(x);
  const auto* ws = static_cast<const unsigned short*>(w);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (vec)
    gmm_bf16_kernel<WARPS_M, WARPS_N, FRAG_M, FRAG_N, BK, true>
        <<<grid, 32 * WARPS_M * WARPS_N, 0, stream>>>(xs, ws, gs, o, T, D, F, E);
  else
    gmm_bf16_kernel<WARPS_M, WARPS_N, FRAG_M, FRAG_N, BK, false>
        <<<grid, 32 * WARPS_M * WARPS_N, 0, stream>>>(xs, ws, gs, o, T, D, F, E);
  return cudaGetLastError();
}

}  // namespace

// x [T, D], w [E, D, F], out [T, F], contiguous, of one dtype (0 float32,
// 1 bfloat16); group_sizes [E] int32 on the device. few_rows picks the
// 16-row tile (bf16 only; also taken for widths off 8 or unaligned
// pointers). Returns the launch's cudaError_t (0 on success);
// the kernel runs asynchronously on `stream`.
extern "C" int repro_moe_gmm(const void* x, const void* w, const void* group_sizes, void* out,
                             int T, int D, int F, int E, int dtype, int few_rows, void* stream) {
  if (T < 0 || D < 0 || F < 0 || E < 1 || E > kMaxExperts) return (int)cudaErrorInvalidValue;
  if (T == 0 || F == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  if (dtype == 0) {
    const dim3 grid((T + kF32Tile - 1) / kF32Tile + E + 1, (F + kF32Tile - 1) / kF32Tile);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    gmm_f32_kernel<<<grid, kF32Threads, 0, s>>>(static_cast<const float*>(x),
                                                static_cast<const float*>(w), gs,
                                                static_cast<float*>(out), T, D, F, E);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const bool vec = D % 8 == 0 && F % 8 == 0 && ((uintptr_t)x % 16) == 0 &&
                   ((uintptr_t)w % 16) == 0;
  if (few_rows || !vec) return (int)launch_bf16<1, 4, 1, 1, 64>(x, w, gs, out, T, D, F, E, vec, s);
  cudaError_t err = cudaFuncSetAttribute(gmm_bf16_pipe_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kPipeSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kPipeBM - 1) / kPipeBM + E + 1, (F + kPipeBN - 1) / kPipeBN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  gmm_bf16_pipe_kernel<<<grid, kPipeThreads, kPipeSmem, s>>>(
      static_cast<const unsigned short*>(x), static_cast<const unsigned short*>(w), gs,
      static_cast<__nv_bfloat16*>(out), T, D, F, E);
  return (int)cudaGetLastError();
}
