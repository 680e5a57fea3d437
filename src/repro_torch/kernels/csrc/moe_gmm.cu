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
// gated pair twice that); 14.4 ms at the f32 peak of the CUDA cores.
// Decode (8 rows): reading the weights of the experts used (~5.5 of 8, 0.65
// GB) is ~0.19 ms: bytes. Three routes, picked by the wrapper from dtype,
// shape and alignment (kernels/moe_gmm.py, gmm_route):
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
// float32: gmm_f32_kernel on the CUDA cores, exact to f32 rounding (tensor
// cores would round its inputs to TF32), register-blocked (rb_loop below):
// 128 x 128 outputs a block of 256 threads, 8 x 8 a thread, over 16-deep
// slices staged by cp.async into two buffers; per k step a thread reads 8
// values of each operand in four 16-byte shared loads and does 64 FMAs. The
// gated variant's block holds 64 columns of wi and the same 64 of wg, so a
// thread's 8 x 8 holds both products of 8 x 4 outputs.
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
// and g (the gate kernel: both products in one pass over x, then in its
// epilogue da = dh g act'(a) and dg = dh act(a), written to a [2, T, F]
// scratch in x's dtype), then dx = da wi^T + dg wg^T in one product and dwi,
// dwg = x^T da, x^T dg in one pass over x. Recomputed, not saved: saving a
// and g would hold two [T, F] tensors from a layer's forward to its
// backward, and under remat the layer's forward runs again just before its
// backward anyway; the recompute is two products of the six.
// Bound on the card: operations, each pass a product of the forward's size
// (2 T D F flops): two for the plain backward, six gated. Deterministic on
// every route: each output element is summed in a fixed order, no atomics,
// no split over rows; no transposed copy of w.
//
// bfloat16 backward (route 1; the forward's TMA conditions, and T > 0): the
// forward's machinery with other operand layouts, one block body
// (tma_body) for the four products:
//   gate (gmm_bwd_gate_tma_kernel): the gated forward's loads and products,
//     da and dg rounded to bf16 in the epilogue (the tensor cores take bf16
//     operands; the reference's bf16 autodiff holds them in bf16 too);
//   dx (gmm_bwd_dx_tma_kernel): row tiles as the forward, A = dy (K-major,
//     K = F), B = w[e] read as stored, [D, F] being the K-major layout of
//     w[e]^T (TMA boxes of 256 d x 64 f); the gated pair's K runs over (da,
//     wi) then (dg, wg) into one accumulator;
//   dw (gmm_bwd_dw_tma_kernel): a block an (expert, 128 d, 256 f) tile
//     walking that expert's rows in order in 64-row slices from its first
//     row: A = x_e^T and B = dy_e are both MN-major (TMA boxes of 64 x 64,
//     the descriptors' transpose bits set). The last slice may hold the next
//     expert's rows (TMA fills zeros only past T): once it lands, the two
//     consumer warpgroups zero those rows of every chunk in shared memory
//     (a row's 128 bytes stay one row under the swizzle), fence the writes
//     to the async proxy and meet at a named barrier before their products.
//     The gated pair's da and dg tiles lie side by side, as wi and wg do in
//     the forward. dw halves always go out by TMA, clipped at D and F.
// float32 backward, and bfloat16 where TMA cannot take the operands (route
// 0): gmm_bwd_gate_kernel, gmm_bwd_dx_kernel, gmm_bwd_dw_kernel, the
// forward's register-blocked loop (rb_loop) with other operand layouts;
// bf16 operands are converted on their way into shared memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

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
// bfloat16, many rows an expert: wgmma fed by TMA (the forward, and the
// backward's gate, dx and dw products)
// ---------------------------------------------------------------------------

constexpr int kTmaThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kTmaBM = 128, kTmaBK = 64, kTmaStages = 4, kTmaGroup = 16;
constexpr int kChunk = 64 * 128;  // bytes of 64 rows of 64 bf16 under the 128-byte swizzle

enum Mode : int { kFwd = 0, kGate = 1, kDx = 2, kDw = 3 };

// A block's product: 128 rows (of x, dy, or for dw of D) by 256 accumulator
// columns, over 64-deep slices. NB weights (or, for dw, gradients): the
// forward's, the gate's and dw's lie side by side in a stage, BN = 256 / NB
// columns each; dx runs its pair's K one after the other.
template <int MODE, int NB>
struct Tma {
  static constexpr int SIDE = MODE == kDx ? 1 : NB;
  static constexpr int BN = 256 / SIDE;                // columns of each product
  static constexpr int NOUT = MODE == kGate || (MODE == kDw && NB == 2) ? 2 : 1;
  static constexpr int A_BYTES = kTmaBM * 128;         // [128, 64], or for dw two [64, 64] chunks
  static constexpr int B_BYTES = kTmaBK * 256 * 2;     // the slice's 256 columns
  static constexpr int STAGE = A_BYTES + B_BYTES;      // 48 KB
  // the ring, 2 x kTmaStages barriers, and slack to align the ring to 1024 B
  static constexpr size_t SMEM = kTmaStages * STAGE + 16 * kTmaStages + 1024;
  static_assert(NOUT * BN / 64 <= kTmaStages, "the output is staged in one x half a stage");
};

// Where a block writes, beside its TMA output maps: `out` (the forward's
// output, the gate's da, dx) and `out2` (the gate's dg) [rows, ld] for the
// halves stored from registers and the rows past the groups; `dh` the
// output gradient the gate reads.
struct TmaOut {
  __nv_bfloat16* out;
  __nv_bfloat16* out2;
  const __nv_bfloat16* dh;
  int ld;
};

// Rows [tail, 64) of a dw stage's slice zeroed, in its two x chunks and four
// gradient chunks (contiguous from the stage's start): the next expert's
// rows, or TMA's zeros past T. By the two consumer warpgroups' 256 threads.
__device__ __forceinline__ void zero_slice_rows(uint8_t* stage, int tail) {
  const int per = (kTmaBK - tail) * 8;  // 16-byte units of a chunk's rows past the tail
  for (int i = threadIdx.x - 128; i < 6 * per; i += 256) {
    const int c = i / per, u = i % per;
    *reinterpret_cast<uint4*>(stage + c * kChunk + (tail + u / 8) * 128 + (u % 8) * 16) =
        make_uint4(0, 0, 0, 0);
  }
}

// The consumer warpgroup `cw`'s half of the block: rows [64 cw, 64 cw + 64)
// of the tile (for dw: of its D tile). `tail`: rows of dw's last slice.
template <int MODE, int NB, int ACT>
__device__ __forceinline__ void tma_consume(const CUtensorMap* to, const CUtensorMap* to2,
                                            uint32_t ring, uint8_t* gring, uint32_t bars,
                                            const TmaOut& o, int cw, int row0, int rows, int n0,
                                            int plane, int nk, int tail) {
  using C = Tma<MODE, NB>;
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

  // One m64n256k16 product a k16 step: accumulator columns 0..255 are one
  // product's, or (NB side by side) the first's 0..127 and the second's.
  float acc[128];
#pragma unroll
  for (int j = 0; j < 128; ++j) acc[j] = 0.f;

  // slice k's products, once its stage has landed
  auto products = [&](int k) {
    const uint32_t st = ring + (k % kTmaStages) * C::STAGE;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTmaBK / 16; ++kk) {
      // A K-major: this warpgroup's 64 rows, 32 bytes a k16 step; for dw
      // MN-major: its 64 columns of D are chunk cw, 16 rows (2048 B) a step.
      // B MN-major: 64-column chunks kChunk apart, 16 k-rows a step; for dx
      // K-major: 256 rows of w[e], 32 bytes a step.
      const uint64_t da = MODE == kDw
                              ? hopper::make_desc(st + kChunk * cw + 2048 * kk, kChunk, 1024, 128)
                              : hopper::make_desc(st + 64 * 128 * cw + 32 * kk, 16, 1024, 128);
      const uint64_t db = MODE == kDx
                              ? hopper::make_desc(st + C::A_BYTES + 32 * kk, 16, 1024, 128)
                              : hopper::make_desc(st + C::A_BYTES + 2048 * kk, kChunk, 1024, 128);
      hopper::Wgmma<256>::ss<MODE == kDw, MODE != kDx>(acc, da, db, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // slice k - 1's products are done: release its stage
    hopper::fence_regs(acc);
    if (k > 0) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + 8 * ((k - 1) % kTmaStages));
    }
  };
  // dw's last slice, where it holds rows past the expert's, is taken after
  // the loop, so the loop's products run with nothing else between them
  const int whole = MODE == kDw && tail < kTmaBK ? nk - 1 : nk;
  for (int k = 0; k < whole; ++k) {
    hopper::mbar_wait(full + 8 * (k % kTmaStages), (k / kTmaStages) & 1);
    products(k);
  }
  if (whole < nk) {
    const int k = nk - 1, s = k % kTmaStages;
    hopper::mbar_wait(full + 8 * s, (k / kTmaStages) & 1);
    zero_slice_rows(gring + s * C::STAGE, tail);
    hopper::fence_proxy_async();
    hopper::named_barrier(3, 256);
    products(k);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // Thread (warp, lane) holds rows 16 warp + g + 8 r of the half, columns
  // 8 j + 2 t + {0, 1} of each product: entries 64 i + 4 j + 2 r + {0, 1}
  // of product i (i = 0 when one product fills the 256 columns).
  const int g = lane / 4, t = lane % 4;
  // output o's pair at (j, r); `dh` the pair's output gradient (gate only)
  constexpr int SECOND = C::SIDE > 1 ? 64 : 0;  // the second product's entries
  auto value = [&](int oi, int j, int r, int c, float dh) -> float {
    const float a = acc[4 * j + 2 * r + c], b = acc[SECOND + 4 * j + 2 * r + c];
    if constexpr (MODE == kGate) {
      float ga, gg;
      gate_grads<ACT>(a, b, dh, ga, gg);
      return oi ? gg : ga;
    } else if constexpr (MODE == kFwd) {
      return combine<ACT>(a, b);
    } else {
      return oi ? b : a;  // dx; dw (the second product's, gated)
    }
  };
  auto dh_pair = [&](int row, int col, float (&dh)[2]) {
    dh[0] = dh[1] = 0.f;
    if (MODE == kGate && col < o.ld) {
      const __nv_bfloat162 v =
          *reinterpret_cast<const __nv_bfloat162*>(o.dh + (int64_t)row * o.ld + col);
      dh[0] = __low2float(v);
      dh[1] = __high2float(v);
    }
  };
  if (MODE == kDw || lr0 + 64 <= rows) {
    // every row is the block's: output o's chunk q (64 columns) staged in
    // this warpgroup's x half of stage o * N / 64 + q, stored by TMA
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * t, q = col / 64;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lr = 16 * warp + g + 8 * r;
        float dh[2];
        dh_pair(row0 + lr0 + lr, n0 + col, dh);
#pragma unroll
        for (int oi = 0; oi < C::NOUT; ++oi) {
          const uint32_t off = (oi * N / 64 + q) * C::STAGE + 64 * 128 * cw +
                               hopper::swizzle(lr, (col % 64) * 2, 128);
          *reinterpret_cast<uint32_t*>(gring + off) =
              pack_bf16(value(oi, j, r, 0, dh[0]), value(oi, j, r, 1, dh[1]));
        }
      }
    }
    hopper::fence_proxy_async();
    hopper::named_barrier(1 + cw, 128);
    if (tid == 0) {
#pragma unroll
      for (int oi = 0; oi < C::NOUT; ++oi)
#pragma unroll
        for (int q = 0; q < N / 64; ++q)
          if (n0 + 64 * q < o.ld)
            hopper::tma_store_4d(oi ? to2 : to, ring + (oi * N / 64 + q) * C::STAGE + 64 * 128 * cw,
                                 n0 + 64 * q, row0 + lr0, plane, 0);
      hopper::tma_store_commit();
      hopper::tma_store_wait_read();
    }
    return;
  }
  // a half the group ends inside: row by row under the mask (the widths are
  // multiples of 8, so a pair of columns is inside or outside together)
  if constexpr (MODE != kDw) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = lr0 + 16 * warp + g + 8 * r;
      if (lr >= rows) continue;
      const int64_t row = row0 + lr;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= o.ld) continue;
        float dh[2];
        dh_pair(row, col, dh);
#pragma unroll
        for (int oi = 0; oi < C::NOUT; ++oi)
          *reinterpret_cast<uint32_t*>((oi ? o.out2 : o.out) + row * o.ld + col) =
              pack_bf16(value(oi, j, r, 0, dh[0]), value(oi, j, r, 1, dh[1]));
      }
    }
  }
}

// One block of any of the four products. Maps: ta the A operand (x, or dx's
// dy / [da; dg]), tb and tb2 the weights (dw: tb the gradients, planes of
// [NB, T, F]), to and to2 the outputs.
template <int MODE, int NB, int ACT>
__device__ __forceinline__ void tma_body(const CUtensorMap* ta, const CUtensorMap* tb,
                                         const CUtensorMap* tb2, const CUtensorMap* to,
                                         const CUtensorMap* to2, const TmaOut& o,
                                         const int* __restrict__ gs, int T, int D, int F, int E) {
  using C = Tma<MODE, NB>;
  int e, row0, rows, n0, nk, plane = 0, first = 0, tail = kTmaBK;
  if constexpr (MODE == kDw) {
    // (expert, F tile, D tile), D tiles fastest: the blocks that run at
    // once read one expert's x (8 MB at mixtral's width, kept in L2) and a
    // few of its gradient's column panels, each from device memory once
    const int nt = (F + C::BN - 1) / C::BN, mt = (D + kTmaBM - 1) / kTmaBM;
    e = blockIdx.x / (mt * nt);
    const int2 span = group_span(gs, E, T, e);
    const int local = blockIdx.x % (mt * nt);
    row0 = local % mt * kTmaBM;
    n0 = local / mt * C::BN;
    rows = kTmaBM;
    first = span.x;
    nk = (span.y + kTmaBK - 1) / kTmaBK;
    tail = span.y - kTmaBK * (nk - 1);
    plane = e;
  } else {
    const int NT = ((MODE == kDx ? D : F) + C::BN - 1) / C::BN;
    const int4 tile = grouped_tile<kTmaBM, kTmaGroup>(gs, E, T, NT);
    e = tile.x, row0 = tile.y, rows = tile.z, n0 = tile.w * C::BN;
    if (rows <= 0) return;
    if (e == E) {  // rows past the groups
      for (int i = threadIdx.x; i < rows * (C::BN / 8); i += kTmaThreads) {
        const int r = i / (C::BN / 8), c = n0 + (i % (C::BN / 8)) * 8;
        if (c >= o.ld) continue;
#pragma unroll
        for (int oi = 0; oi < C::NOUT; ++oi)
          *reinterpret_cast<uint4*>((oi ? o.out2 : o.out) + (int64_t)(row0 + r) * o.ld + c) =
              make_uint4(0, 0, 0, 0);
      }
      return;
    }
    nk = MODE == kDx ? NB * ((F + kTmaBK - 1) / kTmaBK) : (D + kTmaBK - 1) / kTmaBK;
  }

  extern __shared__ uint8_t tma_smem[];
  const uint32_t raw = hopper::smem_u32(tma_smem);
  const uint32_t ring = (raw + 1023) & ~1023u;  // swizzled tiles start 1024-aligned
  uint8_t* gring = tma_smem + (ring - raw);
  const uint32_t bars = ring + kTmaStages * C::STAGE;  // full[stages], empty[stages]

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
      hopper::tma_prefetch(ta);
      hopper::tma_prefetch(tb);
      if (NB > 1 && MODE != kDw) hopper::tma_prefetch(tb2);
      const int nkf = nk / NB;  // dx: slices of one product's K
      for (int k = 0; k < nk; ++k) {
        const int s = k % kTmaStages;
        const uint32_t st = ring + s * C::STAGE, full = bars + 8 * s;
        hopper::mbar_wait(bars + 8 * (kTmaStages + s), ((k / kTmaStages) & 1) ^ 1);  // released
        hopper::mbar_expect_tx(full, C::STAGE);
        if (MODE == kDx) {
          const int b = NB > 1 && k >= nkf, kf = k - b * nkf;
          hopper::tma_load_4d(st, ta, full, kf * kTmaBK, row0, b, 0);
          hopper::tma_load_4d(st + C::A_BYTES, b ? tb2 : tb, full, kf * kTmaBK, n0, e, 0);
        } else if (MODE == kDw) {
          const int r = first + k * kTmaBK;
          hopper::tma_load_4d(st, ta, full, row0, r, 0, 0);
          hopper::tma_load_4d(st + kChunk, ta, full, row0 + 64, r, 0, 0);
#pragma unroll
          for (int i = 0; i < NB; ++i)
#pragma unroll
            for (int q = 0; q < C::BN / 64; ++q)
              hopper::tma_load_4d(st + C::A_BYTES + (i * C::BN / 64 + q) * kChunk, tb, full,
                                  n0 + 64 * q, r, i, 0);
        } else {
          hopper::tma_load_4d(st, ta, full, k * kTmaBK, row0, 0, 0);
#pragma unroll
          for (int i = 0; i < NB; ++i)
#pragma unroll
            for (int q = 0; q < C::BN / 64; ++q)
              hopper::tma_load_4d(st + C::A_BYTES + (i * C::BN / 64 + q) * kChunk, i ? tb2 : tb,
                                  full, n0 + 64 * q, k * kTmaBK, e, 0);
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    tma_consume<MODE, NB, ACT>(to, to2, ring, gring, bars, o, wg - 1, row0, rows, n0, plane, nk,
                               tail);
  }
}

#define TMA_KERNEL_PARAMS                                                                  \
  const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,         \
      const __grid_constant__ CUtensorMap tb2, const __grid_constant__ CUtensorMap to,    \
      const __grid_constant__ CUtensorMap to2, const TmaOut o, const int* __restrict__ gs, \
      int T, int D, int F, int E

template <int ACT>
__global__ void __launch_bounds__(kTmaThreads, 1) gmm_tma_kernel(TMA_KERNEL_PARAMS) {
  tma_body<kFwd, ACT == kPlain ? 1 : 2, ACT>(&ta, &tb, &tb2, &to, &to2, o, gs, T, D, F, E);
}

template <int ACT>
__global__ void __launch_bounds__(kTmaThreads, 1) gmm_bwd_gate_tma_kernel(TMA_KERNEL_PARAMS) {
  tma_body<kGate, 2, ACT>(&ta, &tb, &tb2, &to, &to2, o, gs, T, D, F, E);
}

template <int NB>
__global__ void __launch_bounds__(kTmaThreads, 1) gmm_bwd_dx_tma_kernel(TMA_KERNEL_PARAMS) {
  tma_body<kDx, NB, kPlain>(&ta, &tb, &tb2, &to, &to2, o, gs, T, D, F, E);
}

template <int NB>
__global__ void __launch_bounds__(kTmaThreads, 1) gmm_bwd_dw_tma_kernel(TMA_KERNEL_PARAMS) {
  tma_body<kDw, NB, kPlain>(&ta, &tb, &tb2, &to, &to2, o, gs, T, D, F, E);
}
#undef TMA_KERNEL_PARAMS

// A bf16 tensor [d2, d1, d0] (d0 contiguous) cut into boxes of (b0, b1)
// under the 128-byte swizzle.
inline bool map_bf16(CUtensorMap* map, const void* p, uint64_t d0, uint64_t d1, uint64_t d2,
                     uint32_t b0, uint32_t b1) {
  const uint64_t dims[4] = {d0, d1, d2, 1};
  const uint64_t strides[3] = {d0 * 2, d0 * d1 * 2, d0 * d1 * d2 * 2};
  return hopper::encode_bf16_4d(map, p, dims, strides, b0, b1, 128);
}

template <class Kernel>
cudaError_t launch_tma_kernel(Kernel kernel, size_t smem, int64_t blocks, const CUtensorMap (&m)[5],
                              const TmaOut& o, const int* gs, int T, int D, int F, int E,
                              cudaStream_t s) {
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kTmaThreads, smem, s>>>(m[0], m[1], m[2], m[3], m[4], o, gs, T, D, F,
                                                      E);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t launch_tma(const void* x, const void* w, const void* w2, const int* gs, void* out,
                       int T, int D, int F, int E, cudaStream_t stream) {
  constexpr int NB = ACT == kPlain ? 1 : 2;
  using C = Tma<kFwd, NB>;
  CUtensorMap m[5];
  if (!map_bf16(&m[0], x, D, T, 1, 64, kTmaBM) || !map_bf16(&m[1], w, F, D, E, 64, kTmaBK) ||
      !map_bf16(&m[2], NB > 1 ? w2 : w, F, D, E, 64, kTmaBK) ||
      !map_bf16(&m[3], out, F, T, 1, 64, 64))
    return cudaErrorInvalidValue;
  m[4] = m[3];
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  const TmaOut to{o, o, nullptr, F};
  return launch_tma_kernel(gmm_tma_kernel<ACT>, C::SMEM,
                           row_slots(T, kTmaBM, E) * ((F + C::BN - 1) / C::BN), m, to, gs, T, D,
                           F, E, stream);
}

// The backward on the tensor cores: for a gated pair (ACT) the gate kernel
// writes [da; dg] into `scratch` (bf16 [2, T, F]), then dx and dw (dw2).
template <int ACT>
cudaError_t launch_bwd_tma(const void* dy, const void* x, const void* w, const void* w2,
                           const int* gs, void* scratch, void* dx, void* dw, void* dw2, int T,
                           int D, int F, int E, cudaStream_t s) {
  constexpr int NB = ACT == kPlain ? 1 : 2;
  using B = __nv_bfloat16;
  const void* grad = dy;  // dx's A and dw's B: dy, or the pair's [da; dg]
  CUtensorMap m[5];
  cudaError_t err;
  if constexpr (NB > 1) {
    using C = Tma<kGate, 2>;
    B* da = static_cast<B*>(scratch);
    B* dg = da + (int64_t)T * F;
    if (!map_bf16(&m[0], x, D, T, 1, 64, kTmaBM) || !map_bf16(&m[1], w, F, D, E, 64, kTmaBK) ||
        !map_bf16(&m[2], w2, F, D, E, 64, kTmaBK) || !map_bf16(&m[3], da, F, T, 1, 64, 64) ||
        !map_bf16(&m[4], dg, F, T, 1, 64, 64))
      return cudaErrorInvalidValue;
    const TmaOut o{da, dg, static_cast<const B*>(dy), F};
    err = launch_tma_kernel(gmm_bwd_gate_tma_kernel<ACT>, C::SMEM,
                            row_slots(T, kTmaBM, E) * ((F + C::BN - 1) / C::BN), m, o, gs, T, D,
                            F, E, s);
    if (err != cudaSuccess) return err;
    grad = scratch;
  }
  {
    using C = Tma<kDx, NB>;
    if (!map_bf16(&m[0], grad, F, T, NB, 64, kTmaBM) || !map_bf16(&m[1], w, F, D, E, 64, 256) ||
        !map_bf16(&m[2], NB > 1 ? w2 : w, F, D, E, 64, 256) ||
        !map_bf16(&m[3], dx, D, T, 1, 64, 64))
      return cudaErrorInvalidValue;
    m[4] = m[3];
    B* o = static_cast<B*>(dx);
    err = launch_tma_kernel(gmm_bwd_dx_tma_kernel<NB>, C::SMEM,
                            row_slots(T, kTmaBM, E) * ((D + C::BN - 1) / C::BN), m,
                            TmaOut{o, o, nullptr, D}, gs, T, D, F, E, s);
    if (err != cudaSuccess) return err;
  }
  using C = Tma<kDw, NB>;
  if (!map_bf16(&m[0], x, D, T, 1, 64, 64) || !map_bf16(&m[1], grad, F, T, NB, 64, 64) ||
      !map_bf16(&m[3], dw, F, D, E, 64, 64) || !map_bf16(&m[4], NB > 1 ? dw2 : dw, F, D, E, 64, 64))
    return cudaErrorInvalidValue;
  m[2] = m[1];
  const int64_t tiles = (int64_t)((D + kTmaBM - 1) / kTmaBM) * ((F + C::BN - 1) / C::BN);
  return launch_tma_kernel(gmm_bwd_dw_tma_kernel<NB>, C::SMEM, tiles * E, m,
                           TmaOut{nullptr, nullptr, nullptr, F}, gs, T, D, F, E, s);
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
// CUDA cores, register-blocked: the float32 forward, and the backward's
// gate, dx and dw products in f32 (bf16 where TMA cannot take them)
// ---------------------------------------------------------------------------

constexpr int kRbM = 128, kRbK = 16, kRbThreads = 256;
constexpr int kRbLD = 128 + 4;  // a slice row, padded: see stage_k

// Two buffers of a 16-deep slice of each operand, [k][m] and [k][n], f32.
struct RbTiles {
  float a[2][kRbK][kRbLD];
  float b[2][kRbK][kRbLD];
};

template <typename TI>
constexpr bool kIsF32 = std::is_same<TI, float>::value;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// One element (f32: a 4-byte cp.async; bf16: converted on the way) or four
// neighbouring f32 elements (a 16-byte cp.async) of `base + off` into shared
// memory, zeros where !ok.
template <typename TI>
__device__ __forceinline__ void put1(float* dst, const TI* base, int64_t off, bool ok) {
  if constexpr (kIsF32<TI>)
    hopper::cp_async4(dst, base + (ok ? off : 0), ok);
  else
    *dst = ok ? to_f32(base[off]) : 0.f;
}
__device__ __forceinline__ void put4(float* dst, const float* base, int64_t off, bool ok) {
  hopper::cp_async16(dst, base + (ok ? off : 0), ok);
}

// Columns [col, col + W) of a slice of an operand stored MN-major (the
// tile's m or n dimension contiguous): element (k, c) is src[(k0 + k) * ld +
// c0 + c], zero where k0 + k >= k_end or c0 + c >= c_end. VEC: 16-byte
// copies (f32, ld and c_end multiples of 4, src 16-byte aligned).
template <int W, bool VEC, typename TI>
__device__ __forceinline__ void stage_mn(float (*dst)[kRbLD], int col, const TI* src, int64_t ld,
                                         int k0, int k_end, int c0, int c_end) {
  if constexpr (VEC) {
    constexpr int Q = W / 4;
#pragma unroll
    for (int i = 0; i < kRbK * Q / kRbThreads; ++i) {
      const int idx = threadIdx.x + i * kRbThreads, k = idx / Q, c = (idx % Q) * 4;
      put4(&dst[k][col + c], src, (int64_t)(k0 + k) * ld + c0 + c,
           k0 + k < k_end && c0 + c < c_end);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRbK * W / kRbThreads; ++i) {
      const int idx = threadIdx.x + i * kRbThreads, k = idx / W, c = idx % W;
      put1(&dst[k][col + c], src, (int64_t)(k0 + k) * ld + c0 + c,
           k0 + k < k_end && c0 + c < c_end);
    }
  }
}

// A slice of a 128-wide tile of an operand stored K-major: element (k, c) is
// src[c * ld + k0 + k], zero where c >= c_end or k0 + k >= k_end. Eight
// threads take 8 neighbouring k of one row (32 bytes); with rows kRbLD = 4
// mod 32 floats apart, a warp's 4-byte stores (8 k x 4 rows) hit 32 banks.
template <typename TI>
__device__ __forceinline__ void stage_k(float (*dst)[kRbLD], const TI* src, int64_t ld, int k0,
                                        int k_end, int c_end) {
#pragma unroll
  for (int i = 0; i < kRbK * kRbM / kRbThreads; ++i) {
    const int idx = threadIdx.x + i * kRbThreads;
    const int c = (idx / 8) % kRbM, k = idx % 8 + 8 * (idx / (8 * kRbM));
    put1(&dst[k][c], src, (int64_t)c * ld + k0 + k, c < c_end && k0 + k < k_end);
  }
}

// Thread (ty, tx) of 16 x 16 owns rows 4 ty + {0..3} and 64 + 4 ty + {0..3}
// of the tile (i = 0..7) and columns 4 tx + {0..3}, 64 + 4 tx + {0..3}.
__device__ __forceinline__ int rb_row(int i) {
  return (i < 4 ? 0 : 64) + 4 * (threadIdx.x / 16) + (i & 3);
}
__device__ __forceinline__ int rb_col(int h) { return 64 * h + 4 * (threadIdx.x % 16); }

// acc += A B over nk slices; stage(buf, kt) starts the copies of slice kt
// into buffer buf. Slice kt + 1 is in flight while kt is multiplied.
template <class Stage>
__device__ __forceinline__ void rb_loop(float (&acc)[8][8], RbTiles& s, int nk,
                                        const Stage& stage) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  if (nk > 0) stage(0, 0);
  hopper::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) stage(buf ^ 1, kt + 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();  // slice kt has landed
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRbK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[buf][k][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s.a[buf][k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.b[buf][k][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&s.b[buf][k][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // buffer buf is refilled next turn
  }
}

// v[0..3] into p[col..col + 3], the part at or past n left out.
template <bool VEC, typename TI>
__device__ __forceinline__ void store4(TI* p, int col, int n, const float (&v)[4]) {
  if constexpr (VEC) {
    if (col < n) *reinterpret_cast<float4*>(p + col) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col + c < n) {
        if constexpr (kIsF32<TI>)
          p[col + c] = v[c];
        else
          p[col + c] = __float2bfloat16(v[c]);
      }
  }
}

// The forward's row tiles (MODE kFwd: out = combine(x wi, x wg), or x w)
// and the gated backward's recompute (kGate: out = da, out2 = dg from dh).
// A block: a 128-row tile of one expert by 128 columns of w, or by 64 of wi
// beside the same 64 of wg. Rows past the groups get zeros.
template <int MODE, int ACT, bool VEC, typename TI>
__device__ __forceinline__ void rb_rows(const TI* __restrict__ x, const TI* __restrict__ w,
                                        const TI* __restrict__ w2, const TI* __restrict__ dh,
                                        const int* __restrict__ gs, TI* __restrict__ out,
                                        TI* __restrict__ out2, int T, int D, int F, int E) {
  __shared__ __align__(16) RbTiles s;
  constexpr int W = ACT == kPlain ? 128 : 64;
  const int3 tile = block_tile<kRbM>(gs, E, T, blockIdx.x);
  const int e = tile.x, row0 = tile.y, rows = tile.z;
  if (rows <= 0) return;
  const int n0 = blockIdx.y * W;
  float acc[8][8] = {};
  if (e < E) {
    const TI* xb = x + (int64_t)row0 * D;
    const TI* wb = w + (int64_t)e * D * F;
    const TI* wb2 = w2 + (int64_t)e * D * F;
    rb_loop(acc, s, (D + kRbK - 1) / kRbK, [&](int buf, int kt) {
      const int k0 = kt * kRbK;
      stage_k(s.a[buf], xb, D, k0, D, rows);
      stage_mn<W, VEC>(s.b[buf], 0, wb, F, k0, D, n0, F);
      if (ACT != kPlain) stage_mn<W, VEC>(s.b[buf], 64, wb2, F, k0, D, n0, F);
    });
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rb_row(i);
    if (r >= rows) continue;
    const int64_t row = (int64_t)(row0 + r) * F;
    if constexpr (ACT == kPlain) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
        store4<VEC>(out + row, n0 + rb_col(h), F, v);
      }
    } else {
      const int col = n0 + rb_col(0);
      float v[4], v2[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if constexpr (MODE == kFwd) {
          v[c] = combine<ACT>(acc[i][c], acc[i][4 + c]);
        } else {
          v[c] = v2[c] = 0.f;  // zeros past the groups
          if (e < E && col + c < F)
            gate_grads<ACT>(acc[i][c], acc[i][4 + c], to_f32(dh[row + col + c]), v[c], v2[c]);
        }
      }
      store4<VEC>(out + row, col, F, v);
      if constexpr (MODE == kGate) store4<VEC>(out2 + row, col, F, v2);
    }
  }
}

template <int ACT, bool VEC>
__global__ void __launch_bounds__(kRbThreads, 2)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ w2, const int* __restrict__ gs,
               float* __restrict__ out, int T, int D, int F, int E) {
  rb_rows<kFwd, ACT, VEC>(x, w, w2, x, gs, out, out, T, D, F, E);
}

// da, dg [T, F] (scratch [2, T, F] in the inputs' dtype) of the gated pair:
// a = x wi[e], g = x wg[e] recomputed as gmm_f32_kernel computes them, then
// gate_grads with dh [T, F]; rows past the groups get zeros.
template <int ACT, bool VEC, typename TI>
__global__ void __launch_bounds__(kRbThreads, 2)
gmm_bwd_gate_kernel(const TI* __restrict__ x, const TI* __restrict__ wi,
                    const TI* __restrict__ wg, const TI* __restrict__ dh,
                    const int* __restrict__ gs, TI* __restrict__ scratch, int T, int D, int F,
                    int E) {
  rb_rows<kGate, ACT, VEC>(x, wi, wg, dh, gs, scratch, scratch + (int64_t)T * F, T, D, F, E);
}

// dx [T, D] = sum over b < NB of dy_b [T, F] times w_b[e]^T: dy [NB, T, F]
// (dy, or the gated pair's [da; dg]) and w_b[e] [D, F] both K-major, so
// neither is copied transposed; rows past the groups get zeros.
template <int NB, bool VEC, typename TI>
__global__ void __launch_bounds__(kRbThreads, 2)
gmm_bwd_dx_kernel(const TI* __restrict__ dy, const TI* __restrict__ w0,
                  const TI* __restrict__ w1, const int* __restrict__ gs, TI* __restrict__ dx,
                  int T, int D, int F, int E) {
  __shared__ __align__(16) RbTiles s;
  const int3 tile = block_tile<kRbM>(gs, E, T, blockIdx.x);
  const int e = tile.x, row0 = tile.y, rows = tile.z;
  if (rows <= 0) return;
  const int n0 = blockIdx.y * kRbM;
  float acc[8][8] = {};
  if (e < E) {
    const int nkf = (F + kRbK - 1) / kRbK;
    rb_loop(acc, s, NB * nkf, [&](int buf, int kt) {
      const int b = NB > 1 && kt >= nkf, k0 = (kt - b * nkf) * kRbK;
      stage_k(s.a[buf], dy + ((int64_t)b * T + row0) * F, F, k0, F, rows);
      stage_k(s.b[buf], (b ? w1 : w0) + ((int64_t)e * D + n0) * F, F, k0, F, D - n0);
    });
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rb_row(i);
    if (r >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
      store4<VEC>(dx + (int64_t)(row0 + r) * D, n0 + rb_col(h), D, v);
    }
  }
}

// dw_b[e] [D, F] = x_e^T dy_b,e for b < NB over expert e's rows, walked in
// order: x and dy [NB, T, F] both MN-major here. One block an (expert, 128
// of D, 128 of F or, gated, the same 64 of dwi and dwg); an empty group
// writes zeros.
template <int NB, bool VEC, typename TI>
__global__ void __launch_bounds__(kRbThreads, 2)
gmm_bwd_dw_kernel(const TI* __restrict__ x, const TI* __restrict__ dy,
                  const int* __restrict__ gs, TI* __restrict__ dw0, TI* __restrict__ dw1, int T,
                  int D, int F, int E) {
  __shared__ __align__(16) RbTiles s;
  constexpr int W = NB == 1 ? 128 : 64;
  const int e = blockIdx.y;
  const int2 span = group_span(gs, E, T, e);
  // D tiles fastest, as gmm_bwd_dw_tma_kernel's
  const int mt = (D + kRbM - 1) / kRbM;
  const int m0 = blockIdx.x % mt * kRbM, n0 = blockIdx.x / mt * W;
  const TI* xb = x + (int64_t)span.x * D;
  const TI* yb = dy + (int64_t)span.x * F;
  float acc[8][8] = {};
  rb_loop(acc, s, (span.y + kRbK - 1) / kRbK, [&](int buf, int kt) {
    const int k0 = kt * kRbK;
    stage_mn<kRbM, VEC>(s.a[buf], 0, xb, D, k0, span.y, m0, D);
    stage_mn<W, VEC>(s.b[buf], 0, yb, F, k0, span.y, n0, F);
    if (NB > 1) stage_mn<W, VEC>(s.b[buf], 64, yb + (int64_t)T * F, F, k0, span.y, n0, F);
  });
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + rb_row(i);
    if (r >= D) continue;
    const int64_t row = ((int64_t)e * D + r) * F;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
      if (NB == 1)
        store4<VEC>(dw0 + row, n0 + rb_col(h), F, v);
      else  // columns 0..63 are dwi's, 64..127 dwg's, of the same 64 of F
        store4<VEC>((h ? dw1 : dw0) + row, n0 + rb_col(0), F, v);
    }
  }
}

// The backward on the CUDA cores: for a gated pair (ACT) the gate kernel
// writes [da; dg] into `scratch` ([2, T, F] of TI), then dx and dw (dw2).
template <int ACT, bool VEC, typename TI>
cudaError_t launch_bwd_rb(const TI* dy, const TI* x, const TI* w, const TI* w2, const int* gs,
                          TI* scratch, TI* dx, TI* dw, TI* dw2, int T, int D, int F, int E,
                          cudaStream_t s) {
  constexpr int NB = ACT == kPlain ? 1 : 2;
  const int64_t slots = row_slots(T, kRbM, E);
  const TI* grad = dy;
  if constexpr (NB > 1) {
    if (slots > 0 && F > 0) {
      gmm_bwd_gate_kernel<ACT, VEC, TI><<<dim3((unsigned)slots, (F + 63) / 64), kRbThreads, 0, s>>>(
          x, w, w2, dy, gs, scratch, T, D, F, E);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    grad = scratch;
  }
  if (slots > 0 && D > 0) {
    gmm_bwd_dx_kernel<NB, VEC, TI><<<dim3((unsigned)slots, (D + kRbM - 1) / kRbM), kRbThreads, 0,
                                     s>>>(grad, w, w2, gs, dx, T, D, F, E);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (D > 0 && F > 0) {
    constexpr int W = NB == 1 ? 128 : 64;
    const int64_t tiles = (int64_t)((D + kRbM - 1) / kRbM) * ((F + W - 1) / W);
    if (tiles > INT32_MAX) return cudaErrorInvalidValue;
    gmm_bwd_dw_kernel<NB, VEC, TI><<<dim3((unsigned)tiles, E), kRbThreads, 0, s>>>(
        x, grad, gs, dw, dw2, T, D, F, E);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16) return false;
  return true;
}

template <int ACT>
cudaError_t launch(const void* x, const void* w, const void* w2, const int* gs, void* out, int T,
                   int D, int F, int E, int dtype, int route, cudaStream_t s) {
  if (dtype == 0) {
    constexpr int W = ACT == kPlain ? 128 : 64;
    const dim3 grid((unsigned)row_slots(T, kRbM, E), (F + W - 1) / W);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    const bool vec = D % 4 == 0 && F % 4 == 0 && aligned16({x, w, w2, out});
    const auto kernel = vec ? gmm_f32_kernel<ACT, true> : gmm_f32_kernel<ACT, false>;
    kernel<<<grid, kRbThreads, 0, s>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                       static_cast<const float*>(w2), gs,
                                       static_cast<float*>(out), T, D, F, E);
    return cudaGetLastError();
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  const bool vec = D % 8 == 0 && F % 8 == 0 && aligned16({x, w, w2});
  if (route == kRouteTma) {
    // TMA: 16-byte aligned pointers, row pitches a multiple of 16 bytes
    if (!vec || D == 0 || (uintptr_t)out % 16) return cudaErrorInvalidValue;
    return launch_tma<ACT>(x, w, w2, gs, out, T, D, F, E, s);
  }
  if (route != kRouteSmall) return cudaErrorInvalidValue;
  return launch_small<ACT>(x, w, w2, gs, out, T, D, F, E, vec, s);
}

// The backward of either product on the route asked for: 0 the CUDA cores
// (f32, or bf16), 1 the tensor cores (bf16; TMA's widths and alignment, and
// at least one row: anything else returns an error). ACT kPlain: the plain
// product's (w2, dw2 and scratch unused).
template <int ACT>
cudaError_t launch_bwd(const void* dy, const void* x, const void* w, const void* w2,
                       const int* gs, void* scratch, void* dx, void* dw, void* dw2, int T, int D,
                       int F, int E, int dtype, int route, cudaStream_t s) {
  using B = __nv_bfloat16;
  if (route == kRouteTma) {
    if (dtype != 1 || T == 0 || D == 0 || F == 0 || D % 8 || F % 8 ||
        !aligned16({dy, x, w, w2, scratch, dx, dw, dw2}))
      return cudaErrorInvalidValue;
    return launch_bwd_tma<ACT>(dy, x, w, w2, gs, scratch, dx, dw, dw2, T, D, F, E, s);
  }
  if (route != 0) return cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_bwd_rb<ACT, false, B>(
        static_cast<const B*>(dy), static_cast<const B*>(x), static_cast<const B*>(w),
        static_cast<const B*>(w2), gs, static_cast<B*>(scratch), static_cast<B*>(dx),
        static_cast<B*>(dw), static_cast<B*>(dw2), T, D, F, E, s);
  if (dtype != 0) return cudaErrorInvalidValue;
  const float *dyf = static_cast<const float*>(dy), *xf = static_cast<const float*>(x);
  const float *wf = static_cast<const float*>(w), *w2f = static_cast<const float*>(w2);
  float *sf = static_cast<float*>(scratch), *dxf = static_cast<float*>(dx);
  float *dwf = static_cast<float*>(dw), *dw2f = static_cast<float*>(dw2);
  if (D % 4 == 0 && F % 4 == 0 && aligned16({dy, x, w, w2, scratch, dx, dw, dw2}))
    return launch_bwd_rb<ACT, true>(dyf, xf, wf, w2f, gs, sf, dxf, dwf, dw2f, T, D, F, E, s);
  return launch_bwd_rb<ACT, false>(dyf, xf, wf, w2f, gs, sf, dxf, dwf, dw2f, T, D, F, E, s);
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
// of one dtype (0 float32, 1 bfloat16); group_sizes [E] int32 on the device;
// route 0 the CUDA cores, 1 the tensor cores (bf16; widths multiples of 8,
// T, D, F > 0, pointers 16-byte aligned). Writes dx [T, D] (zeros past the
// groups) and dw [E, D, F] (zeros for an empty group) in that dtype,
// accumulated in f32. Returns the first failing launch's cudaError_t (0 on
// success); the kernels run asynchronously on `stream`.
extern "C" int repro_moe_gmm_bwd(const void* dy, const void* x, const void* w,
                                 const void* group_sizes, void* dx, void* dw, int T, int D,
                                 int F, int E, int dtype, int route, void* stream) {
  if (int err = check_dims(T, D, F, E)) return err;
  return (int)launch_bwd<kPlain>(dy, x, w, w, static_cast<const int*>(group_sizes), dx, dx, dw,
                                 dw, T, D, F, E, dtype, route, static_cast<cudaStream_t>(stream));
}

// The backward of repro_moe_gmm_gated: dh [T, F], x [T, D], wi, wg [E, D, F],
// contiguous, of one dtype; act 1 silu, 2 tanh gelu; scratch [2, T, F] of
// that dtype (receives the pre-activations' gradients, da and dg). Writes dx
// [T, D], dwi and dwg [E, D, F] in that dtype. Otherwise as
// repro_moe_gmm_bwd.
extern "C" int repro_moe_gmm_gated_bwd(const void* dh, const void* x, const void* wi,
                                       const void* wg, const void* group_sizes, void* scratch,
                                       void* dx, void* dwi, void* dwg, int T, int D, int F,
                                       int E, int dtype, int route, int act, void* stream) {
  if (int err = check_dims(T, D, F, E)) return err;
  const int* gs = static_cast<const int*>(group_sizes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act == kSilu)
    return (int)launch_bwd<kSilu>(dh, x, wi, wg, gs, scratch, dx, dwi, dwg, T, D, F, E, dtype,
                                  route, s);
  if (act == kGelu)
    return (int)launch_bwd<kGelu>(dh, x, wi, wg, gs, scratch, dx, dwi, dwg, T, D, F, E, dtype,
                                  route, s);
  return (int)cudaErrorInvalidValue;
}
