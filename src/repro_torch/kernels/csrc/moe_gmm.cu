// Grouped matmul for Hopper (sm_90a), the MoE expert FFN: rows of x [T, D]
// are sorted by expert, expert e owns the next group_sizes[e] rows, and
// out[t] = x[t] @ w[e(t)] for w [E, D, F], with f32 accumulation and the
// output in x's dtype (bfloat16 or float32, x and w of one dtype, all
// contiguous). The gated variant computes out[t] = act(x[t] @ wi[e(t)]) *
// (x[t] @ wg[e(t)]) in one launch (act: silu, or tanh gelu), x read once for
// both products, act and the product applied in f32 and rounded once. Rows
// past sum(group_sizes) belong to no expert (the MoE layer's dropped slots)
// and are written as zeros (act(0) * 0 = 0, written explicitly).
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py::moe_gmm
// (`_gmm_kernel`, pallas_call at :54). That kernel takes each row tile's
// expert from a searchsorted over tile starts, so a tile that straddles two
// experts is multiplied by the wrong one unless every group size is a
// multiple of its tile (only t % block_t is asserted, :45). Here every block
// maps itself to (expert, row tile, column tile) from the group sizes, which
// stay on the device: the grid has ceil(T/BM) + E + 1 row slots for every
// column tile (each expert's last tile may be partial, and the rows past the
// groups are one more region), every block reads the E sizes into shared
// memory and walks them to find its slot, and surplus blocks exit. So any
// sizes work (0, 1, not a multiple of the tile, all rows in one expert), and
// the host never reads them: no copy to the host stalls it once per layer,
// and the decode step stays capturable into a CUDA graph.
//
// Bound on the card. Prefill (mixtral-8x7b, batch 4 x 1024 tokens, top-2):
// x [8192, 4096] @ w [8, 4096, 14336] is 9.62e11 flops, 0.97 ms at the bf16
// tensor-core peak, against 0.37 ms to move its bytes: operations (the
// gated pair twice that). Decode (8 rows): reading the weights of the
// experts used (~5.5 of 8, 0.65 GB) is ~0.19 ms: bytes. Three routes, picked
// by the wrapper from dtype, shape and alignment (kernels/moe_gmm.py,
// gmm_route):
//
// bfloat16, many rows an expert (prefill; widths a multiple of 8, pointers
// 16-byte aligned, as TMA needs): gmm_tma_kernel, warp-specialised wgmma.
// A block of three warpgroups computes a 128-row tile of one expert and BN
// output columns (256, or 128 of wi and 128 of wg for the gated variant).
// Warpgroup 0 gives up registers (setmaxnreg 24) and one thread issues TMA
// loads of 64-deep slices, x [128, 64] K-major and w [64, BN] MN-major (F
// contiguous), both under the 128-byte swizzle, into a 4-stage mbarrier
// ring (48 KB a stage, one block an SM). Warpgroups 1 and 2 take 240
// registers and own 64 rows each: per slice, four k16 steps of wgmma
// m64n256k16 from shared memory (the gated variant's wi and wg tiles lie
// side by side in the stage, so one instruction computes both products on
// one read of x), the accumulator of 128 f32 a thread in registers; a slice's
// stage is released once the next slice's products are issued and the
// slice's own have completed (wgmma wait 1), so the tensor cores never wait
// for a release. The grid runs an expert's row tiles next to each other
// (groups of up to 16 row tiles, column tiles outer), so each weight panel
// (D x BN) is read from device memory once and reused from L2.
// Straddling tiles: a tile whose rows run past its group reads the next
// expert's rows (or zeros past T, which TMA fills), multiplies them and
// never stores them. A warpgroup's 64-row half is stored by TMA only when
// every row is the block's: it is staged swizzled in the warpgroup's own
// x halves of the ring (read by no one else, and free once its products
// are done) and written by one thread, the part past F clipped. Any other
// half is stored from registers, row by row under the mask; a half with no
// row of the block's skips its products and only releases the stages.
//
// bfloat16, a few rows an expert (decode), or widths off 8 or unaligned
// pointers: gmm_small_kernel, warp-level tensor-core products (wmma 16x16x16)
// on 16 x 64 tiles of 4 warps. Decode is bytes-bound (a row of w is read
// for one or two rows of x), so what decides its time is how the weight
// stream is kept in flight: the 64-deep slices go through registers (one
// 16-byte load a chunk where the widths and pointers allow) into two shared
// buffers, two slices a block in flight, and the grid runs column tiles
// fastest, so the blocks that run at once read neighbouring 128-byte pieces
// of the same weight rows. The accumulators leave through a 16 x 16 f32
// scratch per warp, masked at the ragged row and column edges.
//
// float32: gmm_f32_kernel, a plain CUDA-core kernel (64 x 64 tiles, 4 x 4
// outputs a thread, fmaf), exact to f32 rounding: tensor cores would round
// its inputs to TF32.
//
// Every kernel takes the activation as a template parameter (kPlain: one
// weight, no activation), so a gated call is one launch on every route.
//
// The backward (repro_moe_gmm_bwd, repro_moe_gmm_gated_bwd), the port's own:
// the Pallas kernel has none and the reference differentiates its dense
// dispatch. For y = gmm(x, w) and its gradient dy, per group e:
//   dx = dy w[e]^T (rows past the groups: 0),   dw[e] = x_e^T dy_e (an empty
//   group: 0, exactly).
// The gated variant h = act(a) * g, a = x wi[e], g = x wg[e], recomputes a
// and g (gmm_bwd_gate_kernel: both products in one pass over x, then in its
// epilogue da = dh g act'(a) and dg = dh act(a), written in f32), then
// dx = da wi^T + dg wg^T in one product (gmm_bwd_dx_kernel) and dwi, dwg =
// x^T da, x^T dg in one pass over x (gmm_bwd_dw_kernel). Recomputed, not
// saved: saving a and g would hold two [T, F] f32 tensors (0.94 GB at
// mixtral-8x7b's training shape) from a layer's forward to its backward, and
// under remat the layer's forward runs again just before its backward anyway;
// the recompute is two products of the six.
// Bound on the card: operations. Each pass is a product of the forward's
// size, 2 T D F flops: two for the plain backward, six gated, so at
// mixtral-8x7b's f32 training shape (8192 rows, 4096 x 14336) the gated
// backward is 5.8e12 flops, >= 86 ms at 67 TFLOP/s. A simple design first,
// for both dtypes (f32 accumulation): the f32 route's tiles, 64 x 64 outputs a
// block and 4 x 4 a thread over k slices of 16 staged in shared memory, bf16
// inputs converted on the way in. dx reads w[e] transposed in place (its
// slices are rows of w read along F), so no transposed copy of the weights is
// made; dw gives one block each (expert, D tile, F tile), which walks that
// expert's rows in order. Deterministic: every output element is summed by
// one thread in a fixed order, no atomics. Tiles that straddle two groups
// work as in the forward (block_tile).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace nvcuda;

constexpr int kMaxExperts = 256;
enum Act : int { kPlain = 0, kSilu = 1, kGelu = 2 };
enum Route : int { kRouteSmall = 0, kRouteTma = 1 };

// The output element from the products with wi (a) and wg (g).
template <int ACT>
__device__ __forceinline__ float combine(float a, float g) {
  if (ACT == kPlain) return a;
  if (ACT == kSilu) return a / (1.f + expf(-a)) * g;
  // tanh gelu, as torch's F.gelu(approximate="tanh")
  const float u = 0.7978845608028654f * (a + 0.044715f * a * a * a);
  return 0.5f * a * (1.f + tanhf(u)) * g;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The block's expert sizes, read into shared memory. Sizes below 0 count
// as 0; the groups are cut at T.
__device__ __forceinline__ void load_sizes(int* sizes, const int* __restrict__ gs, int E) {
  for (int i = threadIdx.x; i < E; i += blockDim.x) sizes[i] = max(gs[i], 0);
  __syncthreads();
}

// Row slot b's work: (expert, first row, rows). Expert e owns rows
// [off_e, off_e + size_e), cut into ceil(size_e / BM) tiles in order; the
// rows past the last group, up to T, form region E (written with zeros).
// A surplus slot gets rows == 0.
template <int BM>
__device__ int3 block_tile(const int* __restrict__ gs, int E, int T, int slot) {
  __shared__ int sizes[kMaxExperts];
  __shared__ int3 tile;
  load_sizes(sizes, gs, E);
  if (threadIdx.x == 0) {
    int b = slot, off = 0;
    int3 t = make_int3(E, 0, 0);
    for (int e = 0; e <= E; ++e) {
      const int size = min(e < E ? sizes[e] : T, T - off);
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

// The same tiles over a one-dimensional grid of (row slot, column tile)
// pairs, ordered so that an expert's row tiles run next to each other:
// expert by expert, its row tiles in groups of up to GROUP, and within a
// group every row tile of a column tile before the next column tile. So the
// blocks that run at once share a few weight panels and a few x tiles.
// Returns (expert, first row, rows, column tile); rows == 0 for a surplus
// block.
template <int BM, int GROUP>
__device__ int4 grouped_tile(const int* __restrict__ gs, int E, int T, int NT) {
  __shared__ int sizes[kMaxExperts];
  __shared__ int4 tile;
  load_sizes(sizes, gs, E);
  if (threadIdx.x == 0) {
    int b = blockIdx.x, off = 0;
    int4 t = make_int4(E, 0, 0, 0);
    for (int e = 0; e <= E; ++e) {
      const int size = min(e < E ? sizes[e] : T, T - off);
      const int tiles = (size + BM - 1) / BM;
      if (b < tiles * NT) {
        const int g0 = b / (GROUP * NT) * GROUP;  // the group's first row tile
        const int gm = min(GROUP, tiles - g0);    // its row tiles
        const int local = b - g0 * NT;
        const int rt = g0 + local % gm;
        t = make_int4(e, off + rt * BM, min(BM, size - rt * BM), local / gm);
        break;
      }
      b -= tiles * NT;
      off += size;
    }
    tile = t;
  }
  __syncthreads();
  return tile;
}

// Row slots enough for every tile: each expert's last tile may be partial,
// the rows past the groups are one more region, and no tile is empty.
inline int64_t row_slots(int T, int BM, int E) {
  const int64_t slots = (int64_t)(T + BM - 1) / BM + E + 1;
  return slots < T ? slots : T;
}

// The rows past the groups: zeros in columns [n0, n0 + BN) of `rows` rows.
template <int BN>
__device__ __forceinline__ void zero_rows(__nv_bfloat16* out, int row0, int rows, int n0,
                                          int F) {
  for (int i = threadIdx.x; i < rows * BN; i += blockDim.x) {
    const int r = i / BN, c = n0 + i % BN;
    if (c < F) out[(int64_t)(row0 + r) * F + c] = __float2bfloat16(0.f);
  }
}

// ---------------------------------------------------------------------------
// bfloat16, many rows an expert: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kTmaThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kTmaBM = 128, kTmaBK = 64, kTmaStages = 4, kTmaGroup = 16;
constexpr int kChunk = 64 * 128;  // bytes of 64 rows of 64 bf16 under the 128-byte swizzle

template <int ACT>
struct Tma {
  static constexpr int NB = ACT == kPlain ? 1 : 2;     // weight tiles a stage
  static constexpr int BN = ACT == kPlain ? 256 : 128; // output columns a block
  static constexpr int A_BYTES = kTmaBM * 128;         // x slice [128, 64]
  static constexpr int B_BYTES = kTmaBK * BN * 2;      // w slice [64, BN], BN / 64 chunks kChunk apart
  static constexpr int STAGE = A_BYTES + NB * B_BYTES; // 48 KB
  // the ring, 2 x kTmaStages barriers, and slack to align the ring to 1024 B
  static constexpr size_t SMEM = kTmaStages * STAGE + 16 * kTmaStages + 1024;
  static_assert(BN / 64 <= kTmaStages, "the output is staged in one x half a stage");
};

// The consumer warpgroup `cw`'s half of the block: rows [64 cw, 64 cw + 64)
// of the tile.
template <int ACT>
__device__ __forceinline__ void tma_consume(const CUtensorMap* tout, uint32_t ring,
                                            uint8_t* gring, uint32_t bars,
                                            __nv_bfloat16* __restrict__ out, int cw, int row0,
                                            int rows, int n0, int F, int nk) {
  using C = Tma<ACT>;
  constexpr int N = C::BN;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int lr0 = 64 * cw;
  const uint32_t full = bars, empty = bars + 8 * kTmaStages;
  if (lr0 >= rows) {  // no row of ours: release the stages in order
    for (int k = 0; k < nk; ++k) {
      hopper::mbar_wait(full + 8 * (k % kTmaStages), (k / kTmaStages) & 1);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + 8 * (k % kTmaStages));
    }
    return;
  }

  // One m64n256k16 product a k16 step, the weight tiles side by side in
  // the stage (wi's 128 columns, then wg's): accumulator columns 0..255
  // are the plain product's, or wi's 0..127 and wg's 0..127.
  float acc[128];
#pragma unroll
  for (int j = 0; j < 128; ++j) acc[j] = 0.f;

  for (int k = 0; k < nk; ++k) {
    const int s = k % kTmaStages;
    const uint32_t st = ring + s * C::STAGE;
    hopper::mbar_wait(full + 8 * s, (k / kTmaStages) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTmaBK / 16; ++kk) {
      // x K-major: this warpgroup's 64 rows, 32 bytes a k16 step; w
      // MN-major: 64-column chunks kChunk apart, 16 k-rows (2048 B) a step
      const uint64_t da = hopper::make_desc(st + 64 * 128 * cw + 32 * kk, 16, 1024, 128);
      const uint64_t db = hopper::make_desc(st + C::A_BYTES + 2048 * kk, kChunk, 1024, 128);
      hopper::Wgmma<256>::ss_tb(acc, da, db, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // slice k - 1's products are done: release its stage
    hopper::fence_regs(acc);
    if (k > 0) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + 8 * ((k - 1) % kTmaStages));
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // Thread (warp, lane) holds rows 16 warp + g + 8 r of the half, columns
  // 8 j + 2 t + {0, 1}: entries 4 j + 2 r + {0, 1}; wg's column of output
  // column n is accumulator column 128 + n.
  const int g = lane / 4, t = lane % 4;
  auto value = [&](int j, int r, int c) {
    return combine<ACT>(acc[4 * j + 2 * r + c], acc[(C::NB - 1) * 64 + 4 * j + 2 * r + c]);
  };
  if (lr0 + 64 <= rows) {
    // every row is the block's: staged in this warpgroup's x half of stage
    // q for output chunk q (64 columns), stored by TMA
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * t, q = col / 64;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t off = q * C::STAGE + 64 * 128 * cw +
                             hopper::swizzle(16 * warp + g + 8 * r, (col % 64) * 2, 128);
        *reinterpret_cast<uint32_t*>(gring + off) = pack_bf16(value(j, r, 0), value(j, r, 1));
      }
    }
    hopper::fence_proxy_async();
    hopper::named_barrier(1 + cw, 128);
    if (tid == 0) {
#pragma unroll
      for (int q = 0; q < N / 64; ++q)
        if (n0 + 64 * q < F)
          hopper::tma_store_4d(tout, ring + q * C::STAGE + 64 * 128 * cw, n0 + 64 * q,
                               row0 + lr0, 0, 0);
      hopper::tma_store_commit();
      hopper::tma_store_wait_read();
    }
    return;
  }
  // a half the group ends inside: row by row under the mask (F is a
  // multiple of 8, so a pair of columns is inside or outside together)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = lr0 + 16 * warp + g + 8 * r;
    if (lr >= rows) continue;
    __nv_bfloat16* o = out + (int64_t)(row0 + lr) * F;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col < F)
        *reinterpret_cast<uint32_t*>(o + col) = pack_bf16(value(j, r, 0), value(j, r, 1));
    }
  }
}

template <int ACT>
__global__ void __launch_bounds__(kTmaThreads, 1)
gmm_tma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap tw2, const __grid_constant__ CUtensorMap tout,
               const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int T, int D, int F,
               int E) {
  using C = Tma<ACT>;
  const int NT = (F + C::BN - 1) / C::BN;
  const int4 tile = grouped_tile<kTmaBM, kTmaGroup>(gs, E, T, NT);
  const int e = tile.x, row0 = tile.y, rows = tile.z, n0 = tile.w * C::BN;
  if (rows <= 0) return;
  if (e == E) {  // rows past the groups
    for (int i = threadIdx.x; i < rows * (C::BN / 8); i += kTmaThreads) {
      const int r = i / (C::BN / 8), c = n0 + (i % (C::BN / 8)) * 8;
      if (c < F) *reinterpret_cast<uint4*>(out + (int64_t)(row0 + r) * F + c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  extern __shared__ uint8_t tma_smem[];
  const uint32_t raw = hopper::smem_u32(tma_smem);
  const uint32_t ring = (raw + 1023) & ~1023u;  // swizzled tiles start 1024-aligned
  uint8_t* gring = tma_smem + (ring - raw);
  const uint32_t bars = ring + kTmaStages * C::STAGE;  // full[stages], empty[stages]
  const int nk = (D + kTmaBK - 1) / kTmaBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTmaStages; ++s) {
      hopper::mbar_init(bars + 8 * s, 1);
      hopper::mbar_init(bars + 8 * (kTmaStages + s), 8);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch(&tx);
      hopper::tma_prefetch(&tw);
      if (C::NB > 1) hopper::tma_prefetch(&tw2);
      for (int k = 0; k < nk; ++k) {
        const int s = k % kTmaStages;
        const uint32_t st = ring + s * C::STAGE, full = bars + 8 * s;
        hopper::mbar_wait(bars + 8 * (kTmaStages + s), ((k / kTmaStages) & 1) ^ 1);  // released
        hopper::mbar_expect_tx(full, C::STAGE);
        hopper::tma_load_4d(st, &tx, full, k * kTmaBK, row0, 0, 0);
#pragma unroll
        for (int i = 0; i < C::NB; ++i)
#pragma unroll
          for (int q = 0; q < C::BN / 64; ++q)
            hopper::tma_load_4d(st + C::A_BYTES + i * C::B_BYTES + q * kChunk, i ? &tw2 : &tw,
                                full, n0 + 64 * q, k * kTmaBK, e, 0);
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    tma_consume<ACT>(&tout, ring, gring, bars, out, wg - 1, row0, rows, n0, F, nk);
  }
}

template <int ACT>
cudaError_t launch_tma(const void* x, const void* w, const void* w2, const int* gs, void* out,
                       int T, int D, int F, int E, cudaStream_t stream) {
  using C = Tma<ACT>;
  constexpr uint64_t B = 2;  // bytes of a bf16
  const uint64_t t = T, d = D, f = F, e = E;
  CUtensorMap tx, tw, tw2, tout;
  const uint64_t xd[4] = {d, t, 1, 1}, x_st[3] = {d * B, t * d * B, t * d * B};
  const uint64_t wd[4] = {f, d, e, 1}, w_st[3] = {f * B, d * f * B, e * d * f * B};
  const uint64_t od[4] = {f, t, 1, 1}, o_st[3] = {f * B, t * f * B, t * f * B};
  if (!hopper::encode_bf16_4d(&tx, x, xd, x_st, 64, kTmaBM, 128) ||
      !hopper::encode_bf16_4d(&tw, w, wd, w_st, 64, kTmaBK, 128) ||
      !hopper::encode_bf16_4d(&tw2, C::NB > 1 ? w2 : w, wd, w_st, 64, kTmaBK, 128) ||
      !hopper::encode_bf16_4d(&tout, out, od, o_st, 64, 64, 128))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gmm_tma_kernel<ACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const int64_t blocks = row_slots(T, kTmaBM, E) * ((F + C::BN - 1) / C::BN);
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  gmm_tma_kernel<ACT><<<(unsigned)blocks, kTmaThreads, C::SMEM, stream>>>(
      tx, tw, tw2, tout, gs, static_cast<__nv_bfloat16*>(out), T, D, F, E);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16, a few rows an expert: wmma on 16 x 64 tiles, two slices in flight
// ---------------------------------------------------------------------------

constexpr int kSmallBM = 16, kSmallBN = 64, kSmallBK = 64;
constexpr int kSmallThreads = 32 * kSmallBN / 16;  // a warp for 16 x 16
constexpr int kSmallLDA = kSmallBK + 8, kSmallLDB = kSmallBN + 8;  // rows 16 bytes off the banks' period
constexpr int kSmallA = kSmallBM * kSmallLDA, kSmallB = kSmallBK * kSmallLDB;  // elements
// 16-byte chunks a thread loads of a slice of x and of each weight
constexpr int kSmallAChunks = (kSmallBM * kSmallBK / 8 + kSmallThreads - 1) / kSmallThreads;
constexpr int kSmallBChunks = kSmallBK * kSmallBN / 8 / kSmallThreads;
static_assert(kSmallBChunks * kSmallThreads * 8 == kSmallBK * kSmallBN, "w slice split");

// 8 consecutive 16-bit values of one row, zero outside [0, n) or when the
// row is not valid. VEC (widths a multiple of 8, 16-byte aligned pointers):
// the 8 lie inside the row or outside together, one 16-byte load.
template <bool VEC>
__device__ __forceinline__ uint4 load8(const unsigned short* row, bool valid, int col, int n) {
  if (!valid || (VEC && col >= n)) return make_uint4(0, 0, 0, 0);
  if constexpr (VEC) {
    return *reinterpret_cast<const uint4*>(row + col);
  } else {
    unsigned v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = col + j < n ? row[col + j] : 0u;
    return make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16), v[4] | (v[5] << 16),
                      v[6] | (v[7] << 16));
  }
}

// The 64-deep slices of x and w go through registers into two shared
// buffers: while slice k is multiplied, slice k + 1 waits in registers to
// be stored and slice k + 2 is being loaded, so two slices a block are in
// flight.
template <int ACT, bool VEC>
__global__ void __launch_bounds__(kSmallThreads)
gmm_small_kernel(const unsigned short* __restrict__ x, const unsigned short* __restrict__ w,
                 const unsigned short* __restrict__ w2, const int* __restrict__ gs,
                 __nv_bfloat16* __restrict__ out, int T, int D, int F, int E) {
  constexpr int NB = ACT == kPlain ? 1 : 2;
  constexpr int BM = kSmallBM, BN = kSmallBN, BK = kSmallBK, THREADS = kSmallThreads;
  constexpr int LDA = kSmallLDA, LDB = kSmallLDB, AC = kSmallAChunks, BC = kSmallBChunks;
  // two buffers of a slice of x and of each weight; after the products,
  // each warp's 16 x 16 f32 scratch (a union keeps the gated kernel's
  // shared memory under the 48 KB of a static array)
  constexpr int RING = (2 * kSmallA + 2 * NB * kSmallB) * 2;
  constexpr int SCRATCH = THREADS / 32 * NB * 256 * 4;
  __shared__ __align__(128) unsigned char smem[RING > SCRATCH ? RING : SCRATCH];
  auto As = reinterpret_cast<unsigned short(*)[kSmallA]>(smem);
  auto Bs = reinterpret_cast<unsigned short(*)[NB][kSmallB]>(smem + 2 * kSmallA * 2);
  auto Cs = reinterpret_cast<float(*)[NB][256]>(smem);

  // column tiles fastest: the blocks that run at once stream neighbouring
  // columns of the same expert's rows
  const int NT = (F + BN - 1) / BN;
  const int3 tile = block_tile<BM>(gs, E, T, blockIdx.x / NT);
  const int e = tile.x, row0 = tile.y, rows = tile.z;
  if (rows <= 0) return;
  const int tid = threadIdx.x, n0 = blockIdx.x % NT * BN;
  if (e == E) {  // rows past the groups
    zero_rows<BN>(out, row0, rows, n0, F);
    return;
  }
  const unsigned short* xb = x + (int64_t)row0 * D;
  const unsigned short* wb[2] = {w + (int64_t)e * D * F, (NB > 1 ? w2 : w) + (int64_t)e * D * F};

  uint4 ra[2][AC], rb[2][NB][BC];
  auto load = [&](int kt, uint4 (&a)[AC], uint4 (&b)[NB][BC]) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < AC; ++i) {
      const int c = tid + i * THREADS, r = c / (BK / 8), k = (c % (BK / 8)) * 8;
      a[i] = load8<VEC>(xb + (int64_t)r * D, c < BM * BK / 8 && r < rows, k0 + k, D);
    }
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int i = 0; i < BC; ++i) {
        const int c = tid + i * THREADS, r = c / (BN / 8), n = (c % (BN / 8)) * 8;
        b[m][i] = load8<VEC>(wb[m] + (int64_t)(k0 + r) * F, k0 + r < D, n0 + n, F);
      }
  };
  auto store = [&](int buf, const uint4 (&a)[AC], const uint4 (&b)[NB][BC]) {
#pragma unroll
    for (int i = 0; i < AC; ++i) {
      const int c = tid + i * THREADS, r = c / (BK / 8), k = (c % (BK / 8)) * 8;
      if (c < BM * BK / 8) *reinterpret_cast<uint4*>(&As[buf][r * LDA + k]) = a[i];
    }
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int i = 0; i < BC; ++i) {
        const int c = tid + i * THREADS, r = c / (BN / 8), n = (c % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(&Bs[buf][m][r * LDB + n]) = b[m][i];
      }
  };

  const int warp = tid / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB];
#pragma unroll
  for (int m = 0; m < NB; ++m) wmma::fill_fragment(acc[m], 0.f);
  auto multiply = [&](int buf) {
    const __nv_bfloat16* a_s = reinterpret_cast<const __nv_bfloat16*>(As[buf]);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
      wmma::load_matrix_sync(af, a_s + kk, LDA);
#pragma unroll
      for (int m = 0; m < NB; ++m) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(
            bf, reinterpret_cast<const __nv_bfloat16*>(Bs[buf][m]) + kk * LDB + warp * 16, LDB);
        wmma::mma_sync(acc[m], af, bf, acc[m]);
      }
    }
  };

  // Slice k sits in buffer k % 2 and, before that, in register set k % 2;
  // the loop takes two slices a turn, so each set is named at compile time.
  const int nk = (D + BK - 1) / BK;
  if (nk > 0) {
    load(0, ra[0], rb[0]);
    store(0, ra[0], rb[0]);
  }
  if (nk > 1) load(1, ra[1], rb[1]);
  __syncthreads();
  for (int kt = 0; kt < nk; kt += 2) {
    if (kt + 2 < nk) load(kt + 2, ra[0], rb[0]);
    multiply(0);
    if (kt + 1 < nk) store(1, ra[1], rb[1]);
    __syncthreads();
    if (kt + 1 >= nk) break;
    if (kt + 3 < nk) load(kt + 3, ra[1], rb[1]);
    multiply(1);
    if (kt + 2 < nk) store(0, ra[0], rb[0]);
    __syncthreads();
  }

  // through each warp's 16 x 16 f32 scratch (the buffers are free: the
  // loop ends on a barrier), masked at the last row and column
#pragma unroll
  for (int m = 0; m < NB; ++m)
    wmma::store_matrix_sync(Cs[warp][m], acc[m], 16, wmma::mem_row_major);
  __syncwarp();
  const int lane = tid % 32, r = lane / 2, c0 = (lane % 2) * 8;
  if (r < rows) {
    __nv_bfloat16* o = out + (int64_t)(row0 + r) * F;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = n0 + warp * 16 + c0 + jj;
      if (col < F)
        o[col] = __float2bfloat16(
            combine<ACT>(Cs[warp][0][r * 16 + c0 + jj], Cs[warp][NB - 1][r * 16 + c0 + jj]));
    }
  }
}

template <int ACT>
cudaError_t launch_small(const void* x, const void* w, const void* w2, const int* gs, void* out,
                         int T, int D, int F, int E, bool vec, cudaStream_t stream) {
  const int64_t blocks = row_slots(T, kSmallBM, E) * ((F + kSmallBN - 1) / kSmallBN);
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  const auto kernel = vec ? gmm_small_kernel<ACT, true> : gmm_small_kernel<ACT, false>;
  kernel<<<(unsigned)blocks, kSmallThreads, 0, stream>>>(
      static_cast<const unsigned short*>(x), static_cast<const unsigned short*>(w),
      static_cast<const unsigned short*>(w2), gs, static_cast<__nv_bfloat16*>(out), T, D, F, E);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 on CUDA cores: 64 x 64 output tiles, 256 threads of 4 x 4
// ---------------------------------------------------------------------------

constexpr int kF32Tile = 64, kF32K = 16, kF32Threads = 256;

template <int ACT>
__global__ void __launch_bounds__(kF32Threads)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ w2, const int* __restrict__ gs,
               float* __restrict__ out, int T, int D, int F, int E) {
  constexpr int NB = ACT == kPlain ? 1 : 2;
  __shared__ float As[kF32K][kF32Tile + 4];  // x slice, transposed: [k][row]
  __shared__ float Bs[NB][kF32K][kF32Tile + 4];
  const int3 tile = block_tile<kF32Tile>(gs, E, T, blockIdx.x);
  const int e = tile.x, row0 = tile.y, rows = tile.z;
  if (rows <= 0) return;
  const int tid = threadIdx.x, n0 = blockIdx.y * kF32Tile;
  const int ty = tid / 16, tx = tid % 16;
  float acc[NB][4][4] = {};
  if (e < E) {
    const float* xb = x + (int64_t)row0 * D;
    const float* wb[2] = {w + (int64_t)e * D * F, (NB > 1 ? w2 : w) + (int64_t)e * D * F};
    for (int k0 = 0; k0 < D; k0 += kF32K) {
#pragma unroll
      for (int i = 0; i < kF32Tile * kF32K / kF32Threads; ++i) {
        const int idx = tid + i * kF32Threads;
        const int m = idx / kF32K, k = idx % kF32K;
        As[k][m] = m < rows && k0 + k < D ? xb[(int64_t)m * D + k0 + k] : 0.f;
        const int kb = idx / kF32Tile, n = idx % kF32Tile;
        const bool ok = k0 + kb < D && n0 + n < F;
#pragma unroll
        for (int b = 0; b < NB; ++b)
          Bs[b][kb][n] = ok ? wb[b][(int64_t)(k0 + kb) * F + n0 + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kF32K; ++k) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          float bv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[b][k][tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[b][i][j] = fmaf(a[i], bv[j], acc[b][i][j]);
        }
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
      if (col < F)  // zeros past the groups
        out[(int64_t)(row0 + lr) * F + col] = combine<ACT>(acc[0][i][j], acc[NB - 1][i][j]);
    }
  }
}

template <int ACT>
cudaError_t launch(const void* x, const void* w, const void* w2, const int* gs, void* out, int T,
                   int D, int F, int E, int dtype, int route, cudaStream_t s) {
  if (dtype == 0) {
    const dim3 grid((unsigned)row_slots(T, kF32Tile, E), (F + kF32Tile - 1) / kF32Tile);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    gmm_f32_kernel<ACT><<<grid, kF32Threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(w2),
        gs, static_cast<float*>(out), T, D, F, E);
    return cudaGetLastError();
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  const uintptr_t ptrs = (uintptr_t)x | (uintptr_t)w | (uintptr_t)w2;
  const bool vec = D % 8 == 0 && F % 8 == 0 && ptrs % 16 == 0;
  if (route == kRouteTma) {
    // TMA: 16-byte aligned pointers, row pitches a multiple of 16 bytes
    if (!vec || D == 0 || (uintptr_t)out % 16) return cudaErrorInvalidValue;
    return launch_tma<ACT>(x, w, w2, gs, out, T, D, F, E, s);
  }
  if (route != kRouteSmall) return cudaErrorInvalidValue;
  return launch_small<ACT>(x, w, w2, gs, out, T, D, F, E, vec, s);
}

// ---------------------------------------------------------------------------
// the backward: CUDA cores, f32 accumulation, both dtypes
// ---------------------------------------------------------------------------

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The gated pair's gradients from its pre-activations a (wi) and g (wg) and
// the output's gradient dh: d/da and d/dg of act(a) * g, act as `combine`.
template <int ACT>
__device__ __forceinline__ void gate_grads(float a, float g, float dh, float& da, float& dg) {
  if (ACT == kSilu) {
    const float sg = 1.f / (1.f + expf(-a));
    dg = dh * a * sg;
    da = dh * g * sg * (1.f + a * (1.f - sg));
  } else {  // tanh gelu
    const float k0 = 0.7978845608028654f, k1 = 0.044715f;
    const float th = tanhf(k0 * (a + k1 * a * a * a));
    dg = dh * 0.5f * a * (1.f + th);
    da = dh * g * (0.5f * (1.f + th) + 0.5f * a * (1.f - th * th) * k0 * (1.f + 3.f * k1 * a * a));
  }
}

// Expert e's rows: (first row, rows), the groups cut at T as block_tile does.
__device__ int2 group_span(const int* __restrict__ gs, int E, int T, int e) {
  __shared__ int sizes[kMaxExperts];
  __shared__ int2 span;
  load_sizes(sizes, gs, E);
  if (threadIdx.x == 0) {
    int off = 0;
    for (int i = 0; i < e; ++i) off += min(sizes[i], T - off);
    span = make_int2(off, min(sizes[e], T - off));
  }
  __syncthreads();
  return span;
}

// da, dg [T, F] f32 of the gated pair: a = x wi[e], g = x wg[e] recomputed
// as gmm_f32_kernel computes them, then gate_grads with dh [T, F]; rows past
// the groups get zeros.
template <int ACT, typename TI>
__global__ void __launch_bounds__(kF32Threads)
gmm_bwd_gate_kernel(const TI* __restrict__ x, const TI* __restrict__ wi,
                    const TI* __restrict__ wg, const TI* __restrict__ dh,
                    const int* __restrict__ gs, float* __restrict__ da,
                    float* __restrict__ dg, int T, int D, int F, int E) {
  __shared__ float As[kF32K][kF32Tile + 4];  // x slice, transposed: [k][row]
  __shared__ float Bs[2][kF32K][kF32Tile + 4];
  const int3 tile = block_tile<kF32Tile>(gs, E, T, blockIdx.x);
  const int e = tile.x, row0 = tile.y, rows = tile.z;
  if (rows <= 0) return;
  const int tid = threadIdx.x, n0 = blockIdx.y * kF32Tile;
  const int ty = tid / 16, tx = tid % 16;
  float acc[2][4][4] = {};
  if (e < E) {
    const TI* xb = x + (int64_t)row0 * D;
    const TI* wb[2] = {wi + (int64_t)e * D * F, wg + (int64_t)e * D * F};
    for (int k0 = 0; k0 < D; k0 += kF32K) {
#pragma unroll
      for (int i = 0; i < kF32Tile * kF32K / kF32Threads; ++i) {
        const int idx = tid + i * kF32Threads;
        const int m = idx / kF32K, k = idx % kF32K;
        As[k][m] = m < rows && k0 + k < D ? ldf(xb + (int64_t)m * D + k0 + k) : 0.f;
        const int kb = idx / kF32Tile, n = idx % kF32Tile;
        const bool ok = k0 + kb < D && n0 + n < F;
#pragma unroll
        for (int b = 0; b < 2; ++b)
          Bs[b][kb][n] = ok ? ldf(wb[b] + (int64_t)(k0 + kb) * F + n0 + n) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kF32K; ++k) {
        float av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[k][ty * 4 + i];
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          float bv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[b][k][tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[b][i][j] = fmaf(av[i], bv[j], acc[b][i][j]);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = ty * 4 + i;
    if (lr >= rows) continue;
    const int64_t row = row0 + lr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= F) continue;
      float ga = 0.f, gg = 0.f;  // zeros past the groups
      if (e < E) gate_grads<ACT>(acc[0][i][j], acc[1][i][j], ldf(dh + row * F + col), ga, gg);
      da[row * F + col] = ga;
      dg[row * F + col] = gg;
    }
  }
}

// dx [T, D] = sum over b < NB of dy_b [T, F] times w_b[e]^T ([E, D, F], read
// along F: no transposed copy); rows past the groups get zeros.
template <int NB, typename TY, typename TW>
__global__ void __launch_bounds__(kF32Threads)
gmm_bwd_dx_kernel(const TY* __restrict__ dy0, const TY* __restrict__ dy1,
                  const TW* __restrict__ w0, const TW* __restrict__ w1,
                  const int* __restrict__ gs, TW* __restrict__ dx, int T, int D, int F, int E) {
  __shared__ float As[kF32K][kF32Tile + 4];  // dy slice, transposed: [k][row]
  __shared__ float Bs[kF32K][kF32Tile + 4];  // w[e] slice: [k = f][n = d]
  const int3 tile = block_tile<kF32Tile>(gs, E, T, blockIdx.x);
  const int e = tile.x, row0 = tile.y, rows = tile.z;
  if (rows <= 0) return;
  const int tid = threadIdx.x, n0 = blockIdx.y * kF32Tile;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  if (e < E) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const TY* yb = (b == 0 ? dy0 : dy1) + (int64_t)row0 * F;
      const TW* wb = (b == 0 ? w0 : w1) + (int64_t)e * D * F;
      for (int k0 = 0; k0 < F; k0 += kF32K) {
#pragma unroll
        for (int i = 0; i < kF32Tile * kF32K / kF32Threads; ++i) {
          const int idx = tid + i * kF32Threads;
          const int m = idx / kF32K, k = idx % kF32K;  // 16 neighbouring f a row
          As[k][m] = m < rows && k0 + k < F ? ldf(yb + (int64_t)m * F + k0 + k) : 0.f;
          Bs[k][m] = n0 + m < D && k0 + k < F ? ldf(wb + (int64_t)(n0 + m) * F + k0 + k) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kF32K; ++k) {
          float av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = As[k][ty * 4 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = ty * 4 + i;
    if (lr >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < D) stf(dx + (int64_t)(row0 + lr) * D + col, acc[i][j]);
    }
  }
}

// dw_b[e] [D, F] = x_e^T dy_b,e for b < NB over expert e's rows, walked in
// order; one block an (expert, D tile, F tile); an empty group writes zeros.
template <int NB, typename TY, typename TW>
__global__ void __launch_bounds__(kF32Threads)
gmm_bwd_dw_kernel(const TW* __restrict__ x, const TY* __restrict__ dy0,
                  const TY* __restrict__ dy1, const int* __restrict__ gs,
                  TW* __restrict__ dw0, TW* __restrict__ dw1, int T, int D, int F, int E) {
  __shared__ float As[kF32K][kF32Tile + 4];      // x rows: [k = row][m = d]
  __shared__ float Bs[NB][kF32K][kF32Tile + 4];  // dy rows: [k = row][n = f]
  const int e = blockIdx.y;
  const int2 span = group_span(gs, E, T, e);
  const int nft = (F + kF32Tile - 1) / kF32Tile;
  const int m0 = blockIdx.x / nft * kF32Tile, n0 = blockIdx.x % nft * kF32Tile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[NB][4][4] = {};
  const TW* xb = x + (int64_t)span.x * D;
  for (int r0 = 0; r0 < span.y; r0 += kF32K) {
#pragma unroll
    for (int i = 0; i < kF32Tile * kF32K / kF32Threads; ++i) {
      const int idx = tid + i * kF32Threads;
      const int k = idx / kF32Tile, c = idx % kF32Tile;  // 64 neighbouring columns a row
      const bool in = r0 + k < span.y;
      As[k][c] = in && m0 + c < D ? ldf(xb + (int64_t)(r0 + k) * D + m0 + c) : 0.f;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const TY* yb = (b == 0 ? dy0 : dy1) + (int64_t)span.x * F;
        Bs[b][k][c] = in && n0 + c < F ? ldf(yb + (int64_t)(r0 + k) * F + n0 + c) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kF32K; ++k) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[b][k][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[b][i][j] = fmaf(av[i], bv[j], acc[b][i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    TW* out = (b == 0 ? dw0 : dw1) + (int64_t)e * D * F;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + ty * 4 + i;
      if (r >= D) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        if (col < F) stf(out + (int64_t)r * F + col, acc[b][i][j]);
      }
    }
  }
}

// dx then dw for NB (dy, w) pairs whose dy are TY and w, x, dx, dw are TW
template <int NB, typename TY, typename TW>
cudaError_t launch_bwd_products(const TY* dy0, const TY* dy1, const TW* x, const TW* w0,
                                const TW* w1, const int* gs, TW* dx, TW* dw0, TW* dw1, int T,
                                int D, int F, int E, cudaStream_t s) {
  const int64_t slots = row_slots(T, kF32Tile, E);
  if (slots > 0 && D > 0) {
    const dim3 grid((unsigned)slots, (D + kF32Tile - 1) / kF32Tile);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    gmm_bwd_dx_kernel<NB, TY, TW><<<grid, kF32Threads, 0, s>>>(dy0, dy1, w0, w1, gs, dx, T, D,
                                                              F, E);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (D > 0 && F > 0) {
    const int64_t tiles = (int64_t)((D + kF32Tile - 1) / kF32Tile) * ((F + kF32Tile - 1) / kF32Tile);
    if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
    gmm_bwd_dw_kernel<NB, TY, TW><<<dim3((unsigned)tiles, E), kF32Threads, 0, s>>>(
        x, dy0, dy1, gs, dw0, dw1, T, D, F, E);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

template <typename TW>
cudaError_t launch_bwd(const void* dy, const void* x, const void* w, const int* gs, void* dx,
                       void* dw, int T, int D, int F, int E, cudaStream_t s) {
  const TW* y = static_cast<const TW*>(dy);
  return launch_bwd_products<1, TW, TW>(y, y, static_cast<const TW*>(x),
                                        static_cast<const TW*>(w), static_cast<const TW*>(w), gs,
                                        static_cast<TW*>(dx), static_cast<TW*>(dw),
                                        static_cast<TW*>(dw), T, D, F, E, s);
}

template <int ACT, typename TW>
cudaError_t launch_gated_bwd(const void* dh, const void* x, const void* wi, const void* wg,
                             const int* gs, float* scratch, void* dx, void* dwi, void* dwg,
                             int T, int D, int F, int E, cudaStream_t s) {
  float* da = scratch;
  float* dg = scratch + (int64_t)T * F;
  const int64_t slots = row_slots(T, kF32Tile, E);
  if (slots > 0 && F > 0) {
    const dim3 grid((unsigned)slots, (F + kF32Tile - 1) / kF32Tile);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    gmm_bwd_gate_kernel<ACT, TW><<<grid, kF32Threads, 0, s>>>(
        static_cast<const TW*>(x), static_cast<const TW*>(wi), static_cast<const TW*>(wg),
        static_cast<const TW*>(dh), gs, da, dg, T, D, F, E);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_bwd_products<2, float, TW>(
      da, dg, static_cast<const TW*>(x), static_cast<const TW*>(wi), static_cast<const TW*>(wg),
      gs, static_cast<TW*>(dx), static_cast<TW*>(dwi), static_cast<TW*>(dwg), T, D, F, E, s);
}

int check_dims(int T, int D, int F, int E) {
  if (T < 0 || D < 0 || F < 0 || E < 1 || E > kMaxExperts) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// x [T, D], w [E, D, F], out [T, F], contiguous, of one dtype (0 float32,
// 1 bfloat16); group_sizes [E] int32 on the device. route (bf16 only): 0
// the small-tile kernel, 1 the wgmma/TMA kernel (widths a multiple of 8,
// D > 0, pointers 16-byte aligned; anything else returns an error). Returns
// the launch's cudaError_t (0 on success); the kernel runs asynchronously
// on `stream`.
extern "C" int repro_moe_gmm(const void* x, const void* w, const void* group_sizes, void* out,
                             int T, int D, int F, int E, int dtype, int route, void* stream) {
  if (int err = check_dims(T, D, F, E)) return err;
  if (T == 0 || F == 0) return 0;
  return (int)launch<kPlain>(x, w, w, static_cast<const int*>(group_sizes), out, T, D, F, E,
                             dtype, route, static_cast<cudaStream_t>(stream));
}

// The gated variant: out = act(x @ wi[e]) * (x @ wg[e]) per row, wi and wg
// [E, D, F] of x's dtype; act 1 silu, 2 tanh gelu. Otherwise as
// repro_moe_gmm, in one launch.
extern "C" int repro_moe_gmm_gated(const void* x, const void* wi, const void* wg,
                                   const void* group_sizes, void* out, int T, int D, int F,
                                   int E, int dtype, int route, int act, void* stream) {
  if (int err = check_dims(T, D, F, E)) return err;
  if (T == 0 || F == 0) return 0;
  const int* gs = static_cast<const int*>(group_sizes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act == kSilu) return (int)launch<kSilu>(x, wi, wg, gs, out, T, D, F, E, dtype, route, s);
  if (act == kGelu) return (int)launch<kGelu>(x, wi, wg, gs, out, T, D, F, E, dtype, route, s);
  return (int)cudaErrorInvalidValue;
}

// The backward of repro_moe_gmm: dy [T, F], x [T, D], w [E, D, F], contiguous,
// of one dtype (0 float32, 1 bfloat16); group_sizes [E] int32 on the device.
// Writes dx [T, D] (zeros past the groups) and dw [E, D, F] (zeros for an
// empty group) in that dtype, accumulated in f32. Returns the first failing
// launch's cudaError_t (0 on success); the kernels run asynchronously on
// `stream`.
extern "C" int repro_moe_gmm_bwd(const void* dy, const void* x, const void* w,
                                 const void* group_sizes, void* dx, void* dw, int T, int D,
                                 int F, int E, int dtype, void* stream) {
  if (int err = check_dims(T, D, F, E)) return err;
  const int* gs = static_cast<const int*>(group_sizes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_bwd<float>(dy, x, w, gs, dx, dw, T, D, F, E, s);
  if (dtype == 1) return (int)launch_bwd<__nv_bfloat16>(dy, x, w, gs, dx, dw, T, D, F, E, s);
  return (int)cudaErrorInvalidValue;
}

// The backward of repro_moe_gmm_gated: dh [T, F], x [T, D], wi, wg [E, D, F],
// contiguous, of one dtype; act 1 silu, 2 tanh gelu; scratch: f32 [2, T, F]
// (receives the pre-activations' gradients). Writes dx [T, D], dwi and dwg
// [E, D, F] in that dtype. Otherwise as repro_moe_gmm_bwd.
extern "C" int repro_moe_gmm_gated_bwd(const void* dh, const void* x, const void* wi,
                                       const void* wg, const void* group_sizes, void* scratch,
                                       void* dx, void* dwi, void* dwg, int T, int D, int F,
                                       int E, int dtype, int act, void* stream) {
  if (int err = check_dims(T, D, F, E)) return err;
  const int* gs = static_cast<const int*>(group_sizes);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GATED_BWD(ACT, TW) \
  (int)launch_gated_bwd<ACT, TW>(dh, x, wi, wg, gs, sc, dx, dwi, dwg, T, D, F, E, s)
  if (act == kSilu && dtype == 0) return GATED_BWD(kSilu, float);
  if (act == kSilu && dtype == 1) return GATED_BWD(kSilu, __nv_bfloat16);
  if (act == kGelu && dtype == 0) return GATED_BWD(kGelu, float);
  if (act == kGelu && dtype == 1) return GATED_BWD(kGelu, __nv_bfloat16);
#undef GATED_BWD
  return (int)cudaErrorInvalidValue;
}
