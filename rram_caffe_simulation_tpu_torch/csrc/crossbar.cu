// Crossbar read GEMM: y_c = x_c @ W_eff_c for every config lane c (B2), and
// the tiled read on the same core (B2t): y_c[:, jt] = sum over kt, ascending,
// of adc(x_c[:, kt] @ W_eff_c[kt, jt]) over the layer's bk x bn crossbar
// tiles, adc being the tile's own ADC (quantize_ste at adc_levels with the
// partial's max-abs over ALL M rows and the tile's columns); and B3, the
// same tiled read of a convolution whose operand is gathered from the raw
// activation (implicit im2col, below).
//
// Replaces the Pallas kernels of rram_caffe_simulation_tpu/fault/hw_aware.py:
// `_make_crossbar_kernel` (one config, launched by `_pallas_forward`) and
// `_make_batched_kernel` (config grid, `_pallas_forward_batched`), with
// their host-noise twins, untiled (B2) and tiled (B2t: `_tile_blocks` :318,
// `_m_block` :308, `_adc_read` :212, `_apply_tile` :229); and
// `_make_implicit_kernel` :743 / `_make_implicit_batched_kernel` :814 with
// `_gather_block` :725, launched by `_pallas_forward_implicit[_batched]`
// (:905, :975) (B3). Per weight cell,
// the effective read `_w_eff`:
//   1. optional quantization onto the 2^(q-1)-1 level grid with the lane's
//      whole-matrix max-abs: w = w + (clip(rint(w/s), -l, l)*s - w),
//      s = max(scale, 1e-12)/l;
//   2. forward-only conductance noise (sigma != 0): noisy = w*(1 + sigma*eps);
//   3. the stuck clamp in straight-through form: w + (sel - w) with
//      sel = broken ? stuck : noisy.
// eps comes from `eps` when given (host-noise mode, for exact comparison),
// else from Philox4x32-10 drawn here: key = (lane seed, 0), counter = the
// flat index k*N+n of the (K, N) view whatever the storage order,
// Box-Muller on the first two words. Every block therefore sees the same
// weight noise whatever the tiling, which is what the TPU kernel's
// per-(j,k)-tile seeding guarantees.
//
// Bit-exact w_eff: the chain above uses __fdiv_rn/__fmul_rn/__fadd_rn, so
// nvcc cannot contract it into FMAs, and rintf rounds half to even like
// torch.round / jnp.round (roundf would round half away from zero). The
// file must not be built with --use_fast_math. Only the K-sum of the
// product is contracted (fmaf), so y differs from the plain version by
// f32 summation order alone. No floating-point atomics anywhere: two calls
// on the same inputs give the same bits.
//
// Operands as they are stored. x, w, stuck, eps are f32 and broken is one
// byte a cell (0/1); each comes with its element strides (lane, row,
// column) over the (C, M, K) or (C, K, N) view, so Caffe's stored
// (C, num_output, K) weight (k contiguous), its transpose (n contiguous)
// and the (M, C, K) view of a laned activation are all read in place. A
// lane stride of 0 shares one x among the lanes. Where the contiguous
// stride is 1 and rows, lanes and the base are 16-byte aligned the tiles
// come in by 16-byte cp.async; any other strides take scalar loads.
//
// One C call, up to three passes on the stream:
//   a. (levels > 0) the lane's max |w|, reduced straight from w into
//      `scale`; max is order-free, so the integer atomicMax on the float's
//      bits that joins a lane's blocks gives the bits of w.abs().amax();
//   b. the GEMM. A 256-thread block owns a BM x BN output tile (BN = 64;
//      B3 also 32). Its two groups of 128 threads each sum one half of a
//      stage's 32 k (added at the end, group 0's sum + group 1's); in a
//      group thread (ty, tx) owns the rows ty + TY i and the columns
//      tx + TX j (TX = BN/8, TY = 128/TX): a BM/TY x 8
//      register tile fed by float4 shared-memory loads along k (both
//      tiles are kept k-minor: xs[m][k], ws[n][k]), one such load for 16
//      FMAs, so the FMA pipe and not shared memory is the limit; the x
//      tile's 16-byte chunks are XOR-swizzled so a warp's four rows fall
//      into distinct banks. K advances in 32-deep stages through a ring of
//      two buffers: the raw x, w, broken, stuck (and eps) tiles of stage
//      t+1 are in flight (cp.async) while stage t is turned into W_eff in
//      shared memory and multiplied;
//   c. (split-K) every block writes its partial tile to `part`; the last
//      block to arrive at a tile (a counter per tile, integer atomicAdd)
//      sums the splits in ascending order, so the order is fixed.
//
// What bounds it on an H100, and which variant the wrapper picks:
//   - C = 512 lanes at ip1 (M = 100, K = 1024, N = 64) moves 0.5 GB for
//     6.7 GFLOP: bytes (0.16 ms at 3.35 TB/s) ahead of f32 FMAs (0.10 ms).
//     A 112 x 64 tile covers a lane's whole output, so W_eff is formed
//     once a lane and x, w, broken, stuck are read once; 512 blocks, two
//     resident per SM. Plain fmaf on the CUDA cores: TF32 would break the
//     f32 summation bound. On the card the three phases of a stage (loads,
//     W_eff, product) add up rather than overlap: a stage's data is always
//     there when asked for, but a thread that starts a cp.async stalls while
//     the SM's outstanding requests are full, and a 33 KB stage is more
//     than they hold, so starting the loads costs about the time the bytes
//     take. A third stage, a warp that only loads, loads spread between the
//     k steps, the scale reduced by the lane's own block, and one 1-D bulk
//     copy (cp.async.bulk) for each 128-byte tile row were each slower
//     than this form; 2-D tensor-map TMA loads of whole tiles are untried.
//   - C = 1 is latency: 13 MFLOP over 0.7 MB. One 128 x 64 tile would
//     leave 131 SMs idle behind 32 serial K stages, so 32-row tiles and
//     split-K spread ip1 over 4 x 32 = 128 blocks of one stage each; the
//     cost left is the passes themselves (a memset, the scale, the GEMM).
//
// B2t is the same call (scale pass, then the GEMM pass over K-tiles, the
// stages cut at a K-tile's edge so bk need not be a multiple of 32) with
// another epilogue: a block per (lane, K-tile, row block, column block)
// writes its raw partial to `part` and joins its N-tiles' max |partial| by
// integer atomicMax on the bits (order-free, so deterministic); then
// rram::adc_sum_kernel quantizes each partial with `_adc_read`'s
// straight-through __f*_rn chain and sums the K-tiles in ascending order,
// ((q0 + q1) + q2) + ..., the plain version's. Each K-tile's partial is
// summed in the same order whatever C or the tile rows (`hw_aware.b2t_plan`,
// the shape alone), and no float is ever added atomically.
// What bounds B2t on an H100: a block spends 6-9 us on a 32-deep stage
// whether it has its SM alone or shares it (the loads, W_eff and the FMAs
// add up, as for B2), so time follows the stages a block runs in series
// and the blocks a wave holds. At C = 1 (ip1: M 100, K 1024, N 64, tiles
// 128 x 64: 0.7 MB and 13 MFLOP, ~0.3 us of card time) that is latency: a
// memset, the scale pass, 8 K-tile blocks of four stages (times the row
// blocks) and the second pass. At C = 64 bytes (26 MB of x, 38 MB of cells
// at 9 bytes a cell: ~20 us) lead f32 FMAs (~13 us), but 512 blocks of
// four stages are two waves of that stage cost: the core's own throughput
// bounds it. The tile ADC inside the block was built and measured twice
// and is gone (PERF.md): one block a lane walking its K-tiles serialises
// them (0.28 ms at C = 1, 0.25 at C = 64, no faster at C = 512), and each
// K-tile's ADC in its own block with the last block of a column summing
// them was slower than two passes at C = 1 and 64.
//
// B3 is B2t with another x tile load: element (m, k) of the operand is
// xflat[lane * x_lane_stride + row_base[m] + col_off[k]] of the zero-padded,
// flattened NCHW activation (`mapping.im2col_index_plan`); the patch matrix
// never exists. The gather is the x tile's load in the two-buffer ring, so
// stage t+1's gather is in flight while stage t multiplies. It is
// contiguous along m (an output row at stride 1) and, for a kernel row's
// taps, along k, where a 5-tap row and the rows' varying alignment leave
// few 16-byte chunks whole. So a warp takes 128 neighbouring rows at one
// column, four a thread: one 16-byte cp.async where the four are adjacent
// and aligned (for a 5 x 5 conv at stride 1, 2 of 5 columns), four 4-byte
// ones otherwise, coalesced either way, into the x tile, which B3 keeps
// [k][m]. W_eff is
// formed once a call by a pass of its own (weff_kernel, after the scale
// pass) into scratch (C, K, N), so the GEMM pass reads only x and W_eff,
// its [k][n] tile as stored, and forms nothing in stage. The product then
// runs one k at a time: float4 reads along m and along n feed a TM x 8
// register tile, each output's fmaf chain in the same k order as B2t's
// float4-along-k form (group halves, then group 0's + group 1's), so B3
// over x gives the bits of B2t over the patch rows at the same crossbar
// tiles. The column tile is a template parameter: 32 or 64 columns, the one
// that pads N less (conv2 has N = 32, where a 64-column tile would spend
// half its FMAs on padding); a thread still owns 8 columns, so 32-column
// tiles take twice the rows (256 against 128) for the same register
// tile. Measured and replaced (PERF.md, the B3 redesign): a thread's
// 4-column chunk along k for rows 32 apart (scattered requests; 7.7 ms
// for the GEMM pass at C = 64), W_eff formed in each stage as B2t does,
// from the raw tiles (8.8 ms against 7.1 with the pass), a third ring
// buffer, a block walking its lane's K-tiles and tiles of half the rows
// (all slower).
// The epilogue is B2t's (raw partials, integer-max tile ranges, then
// rram::adc_sum_kernel). What bounds B3 on an H100: its shapes are
// compute-bound (conv2: M 25,600, K 800, N 32, 1.3 GFLOP a lane over a few
// MB), so the f32 FMA rate (67 TFLOP/s; TF32 would break the identity with
// B2t) and the design's own partials round trip (P is (C, gk, M, N) f32:
// 2.2 GB written and read back at C = 64 over conv2 and conv3).
#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

#include "crossbar_weff.cuh"

namespace {

using rram::gauss;
using rram::w_eff;

constexpr int BK = 32;
constexpr int THREADS = 256;     // 2 k groups x 128: BN/8 (tx) x 1024/BN (ty)
constexpr int STAGES = 2;
constexpr int WP = BK + 4;       // pitch of ws[n][k]: float4 reads of 8
                                 // neighbouring n hit 8 distinct bank groups

// What a block does with its product
enum Epilogue {
  kPlain,   // B2: y, or a split-K partial summed by the last block
  kTile,    // B2t, B3: one K-tile's raw partial and its N-tiles' max |p|;
            //   rram::adc_sum_kernel does the ADC and the sum
};

// one strided operand: element strides over the (lane, row, column) view
struct Operand {
  const void* p;
  long long sl, sr, sc;
  int vec;     // 16-byte loads allowed along the contiguous axis
};

struct Params {
  Operand x, w, broken, stuck, eps;      // eps.p == nullptr: none given
  const float* scale;                    // (C,) max |w| of each lane
  const int32_t* seeds;
  float sigma, levels;
  int C, M, K, N;
  int splits, tiles_per_split;           // B2: over the K stages
  int bk, bn, gk, gn;                    // B2t, B3: the crossbar tiles
  float adc_levels;                      // B2t, B3: 0 = no ADC
  const int32_t* row_base;               // B3: (M,) x's row offsets
  const int32_t* col_off;                // B3: (K,) x's column offsets
  unsigned* amax;                        // B2t, B3: (C, gk, gn)
  float* part;                           // B2 split-K: (C, splits, M, N);
                                         // B2t, B3: (C, gk, M, N)
  unsigned* counters;                    // one per output tile
  float* out;
};

// r + a . b, k ascending
__device__ __forceinline__ float dot_acc(float4 a, float4 b, float r) {
  r = fmaf(a.x, b.x, r);
  r = fmaf(a.y, b.y, r);
  r = fmaf(a.z, b.z, r);
  return fmaf(a.w, b.w, r);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// where element (r, c) of the x tile sits: the 16-byte chunks of a row are
// XOR-swizzled with the row's low bits, so the float4 reads of a warp (one k
// chunk of four neighbouring rows) fall into distinct bank groups
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * BK + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// A rows x cols tile of a 2-D strided view into dense shared memory
// (pitch = cols; `SWZ`: the x tile's swizzled order): element (r, c) from
// base[(r0+r)*sr + (c0+c)*sc], zero outside (rlim, clim). With `vec`
// (sc == 1, 16-byte aligned) by cp.async.
template <typename T, bool SWZ = false>
__device__ __forceinline__ void load_tile(T* dst, const T* base, long long sr,
                                          long long sc, int vec, int rows,
                                          int cols, int r0, int c0, int rlim,
                                          int clim, int tid) {
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T);
    const int cpr = cols / E;
    for (int i = tid; i < rows * cpr; i += THREADS) {
      const int r = i / cpr, c = (i % cpr) * E;
      const int gr = r0 + r, gc = c0 + c;
      int valid = gr < rlim ? clim - gc : 0;
      valid = valid < 0 ? 0 : (valid > E ? E : valid);
      const T* src = valid ? base + (long long)gr * sr + gc : base;
      cp_async16(dst + (SWZ ? swizzled(r, c) : r * cols + c), src,
                 valid * (int)sizeof(T));
    }
  } else {
    for (int i = tid; i < rows * cols; i += THREADS) {
      const int r = i / cols, c = i % cols;
      const int gr = r0 + r, gc = c0 + c;
      dst[SWZ ? swizzled(r, c) : r * cols + c] =
          (gr < rlim && gc < clim)
              ? base[(long long)gr * sr + (long long)gc * sc]
              : T(0);
    }
  }
}

// B3's x tile, [k][m] (pitch BM), gathered through the address plan:
// element (r, c) is xc[rb[r] + col_off[k0 + c]], rb the block's row offsets
// (-1 past M), zero past M or k_end. Warp w brings the columns 4w..4w+3
// for the rows 4 lane.., 4 lane + 128.., ...: it reads its four column
// offsets once a stage; four neighbouring rows that are adjacent in x
// (an output row at stride 1) at a 16-byte aligned address come by one
// 16-byte cp.async, else by four 4-byte ones, so a warp's copy is one
// 512-byte run of x where the rows allow, into neighbouring words of
// shared memory.
template <int BM>
__device__ __forceinline__ void load_x_gather(float* dst, const float* xc,
                                              const int* rb,
                                              const int32_t* col_off, int k0,
                                              int k_end, int tid) {
  static_assert(THREADS / 32 == BK / 4, "a warp per 4-column chunk");
  const int lane = tid & 31, c = (tid >> 5) * 4, k = k0 + c;
  int off[4];
  bool kin[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    kin[j] = k + j < k_end;
    off[j] = kin[j] ? __ldg(col_off + k + j) : 0;
  }
#pragma unroll
  for (int r = 4 * lane; r < BM; r += 128) {
    const int4 b = *(const int4*)&rb[r];
    // rows r..r+3 adjacent in x (row offsets rise strictly; -1 only at
    // the tail): one 16-byte copy a column where it is aligned
    const bool run = b.x >= 0 && b.w == b.x + 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* d = dst + (c + j) * BM + r;
      const float* src = xc + b.x + off[j];
      if (run && kin[j] && ((uintptr_t)src & 15) == 0) {
        cp_async16(d, src, 16);
      } else {
        const int bs[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const bool in = bs[v] >= 0 && kin[j];
          cp_async4(d + v, in ? xc + bs[v] + off[j] : xc, in ? 4 : 0);
        }
      }
    }
  }
}

// A (BK x BN) weight-shaped tile: stored k-minor ([n][k]) when the operand's
// n stride is not 1 (Caffe's stored layout), else n-minor ([k][n]); zero
// from k = k_end on.
template <int BN, typename T>
__device__ __forceinline__ void load_cell_tile(T* dst, const Operand& op,
                                               int c, int k0, int n0,
                                               int k_end, int N, int tid) {
  const T* base = (const T*)op.p + (long long)c * op.sl;
  if (op.sc != 1)
    load_tile(dst, base, op.sc, op.sr, op.vec, BN, BK, n0, k0, N, k_end, tid);
  else
    load_tile(dst, base, op.sr, op.sc, op.vec, BK, BN, k0, n0, k_end, N, tid);
}

template <int BN, typename T>
__device__ __forceinline__ T cell_at(const T* tile, const Operand& op, int k,
                                     int n) {
  return op.sc != 1 ? tile[n * BK + k] : tile[k * BN + n];
}

// element (k, n) of lane c of a strided operand
template <typename T>
__device__ __forceinline__ T elem(const Operand& op, int c, int k, int n) {
  return ((const T*)op.p)[(long long)c * op.sl + (long long)k * op.sr +
                          (long long)n * op.sc];
}

// max |w| of a lane as the float's bits (non-negative floats order like
// unsigned integers; a NaN's payload orders above infinity, as amax keeps
// it), this thread's share: elements first, first + stride, ... `dense`:
// the lane is one run of K*N floats in memory, read flat (`vec`: by float4).
__device__ __forceinline__ unsigned absmax_bits(const float* wc, long long sk,
                                                long long sn, int dense,
                                                int vec, int K, int N,
                                                long long first,
                                                long long stride) {
  const long long total = (long long)K * N;
  unsigned m = 0;
  if (dense && vec) {
    const float4* w4 = (const float4*)wc;
    for (long long i = first; i < total / 4; i += stride) {
      const float4 v = w4[i];
      m = max(m, __float_as_uint(v.x) & 0x7fffffffu);
      m = max(m, __float_as_uint(v.y) & 0x7fffffffu);
      m = max(m, __float_as_uint(v.z) & 0x7fffffffu);
      m = max(m, __float_as_uint(v.w) & 0x7fffffffu);
    }
    for (long long i = (total / 4) * 4 + first; i < total; i += stride)
      m = max(m, __float_as_uint(wc[i]) & 0x7fffffffu);
  } else if (dense) {
    for (long long i = first; i < total; i += stride)
      m = max(m, __float_as_uint(wc[i]) & 0x7fffffffu);
  } else {
    for (long long i = first; i < total; i += stride) {
      const long long k = i / N, n = i - k * N;
      m = max(m, __float_as_uint(wc[k * sk + n * sn]) & 0x7fffffffu);
    }
  }
  return m;
}

// the block's maximum of every thread's m, in thread 0
__device__ __forceinline__ unsigned block_max(unsigned m, unsigned* warp_max,
                                              int tid) {
  m = __reduce_max_sync(0xffffffffu, m);
  if ((tid & 31) == 0) warp_max[tid >> 5] = m;
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int i = 1; i < THREADS / 32; ++i) m = max(m, warp_max[i]);
  }
  return m;
}

// floats of one ring stage: B2/B2t the x tile [m][k], then the raw w,
// stuck (and eps) tiles and the broken bytes; B3 the gathered x tile
// [k][m] and the W_eff tile [k][n]
__host__ __device__ __forceinline__ int stage_floats(int BM, int BN,
                                                     bool has_eps,
                                                     bool gather) {
  return gather ? BK * (BM + BN)
                : BM * BK + (has_eps ? 3 : 2) * BK * BN + BK * BN / 4;
}

template <int BM, int BN, Epilogue EPI, bool GATHER>
__global__ void __launch_bounds__(THREADS, 2)
crossbar_kernel(const __grid_constant__ Params p) {
  // in a k group of 128 threads, thread (ty, tx) owns TM rows and 8
  // columns: B2/B2t rows ty + TY i, columns tx + TX j (float4 reads along
  // k); B3 rows 4 ty + v + 4 TY g, columns 4 tx + u + 4 TX h (float4
  // reads along m and n, one k at a time)
  constexpr int TX = BN / 8, TY = 128 / TX, TM = BM / TY;
  static_assert(BM % TY == 0 && (!GATHER || TM % 4 == 0), "tile rows");
  extern __shared__ float4 smem_raw[];
  const bool has_eps = p.eps.p != nullptr;
  const int stage = stage_floats(BM, BN, has_eps, GATHER);
  float* ws = (float*)smem_raw;                     // [BN][WP], W_eff (B2)
  float* ring = ws + (GATHER ? 0 : BN * WP);
  __shared__ __align__(16) int rbs[GATHER ? BM : 1];  // B3: rows' offsets

  // two groups of 128 threads, each summing one half of a stage's 32 k
  const int tid = threadIdx.x, grp = tid >> 7;
  const int tx = tid % TX, ty = (tid & 127) / TX;
  // blockIdx.x: (lane, split) for B2, (lane, K-tile) for B2t and B3
  const int per_lane = EPI == kPlain ? p.splits : p.gk;
  const int c = blockIdx.x / per_lane, sub = blockIdx.x - c * per_lane;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.z * BN;
  const int M = p.M, K = p.K, N = p.N;
  auto row = [&](int i) {
    return GATHER ? 4 * ty + i % 4 + 4 * TY * (i / 4) : ty + TY * i;
  };
  auto col = [&](int j) {
    return GATHER ? 4 * tx + (j & 3) + 4 * TX * (j >> 2) : tx + TX * j;
  };

  const float* xc = (const float*)p.x.p + (long long)c * p.x.sl;
  const float levels = p.levels;
  const float s =
      levels > 0.f ? __fdiv_rn(fmaxf(p.scale[c], 1e-12f), levels) : 0.f;
  const bool noise = p.sigma != 0.f;
  const uint32_t seed = (uint32_t)p.seeds[c];
  // k-major thread-to-cell map where w is stored k-minor: shared-memory
  // reads of the raw tile and writes of ws[n][k] both run along k
  const bool k_minor = p.w.sc != 1;
  if constexpr (GATHER) {
    for (int i = tid; i < BM; i += THREADS)
      rbs[i] = m0 + i < M ? __ldg(p.row_base + m0 + i) : -1;
    __syncthreads();
  }

  // stage t of the k range from k_lo: the raw tiles, zero from k_end on
  auto load_stage = [&](int t, int k_lo, int k_end) {
    float* xs = ring + (t % STAGES) * stage;
    const int k0 = k_lo + t * BK;
    float* wr = xs + BM * BK;
    if constexpr (GATHER) {
      load_x_gather<BM>(xs, xc, rbs, p.col_off, k0, k_end, tid);
      // W_eff (C, K, N), n contiguous: the [k][n] tile as it is
      load_tile(wr, (const float*)p.w.p + (long long)c * p.w.sl, p.w.sr,
                p.w.sc, p.w.vec, BK, BN, k0, n0, k_end, N, tid);
    } else {
      load_tile<float, true>(xs, xc, p.x.sr, p.x.sc, p.x.vec, BM, BK, m0, k0,
                             M, k_end, tid);
      float* sr = wr + BK * BN;
      float* er = sr + BK * BN;
      uint8_t* br = (uint8_t*)(er + (has_eps ? BK * BN : 0));
      load_cell_tile<BN>(wr, p.w, c, k0, n0, k_end, N, tid);
      load_cell_tile<BN>(sr, p.stuck, c, k0, n0, k_end, N, tid);
      load_cell_tile<BN>(br, p.broken, c, k0, n0, k_end, N, tid);
      if (has_eps) load_cell_tile<BN>(er, p.eps, c, k0, n0, k_end, N, tid);
    }
  };

  constexpr bool tiled = EPI == kTile;
  const long long MN = (long long)M * N;
  __shared__ bool last;
  float acc[TM][8];
  // the k range: B2's split of the K stages, or the K-tile `sub` (its last
  // stage cut at its edge)
  int k_lo, k_end;
  if constexpr (tiled) {
    k_lo = sub * p.bk;
    k_end = min(k_lo + p.bk, K);
  } else {
    const int t_begin = sub * p.tiles_per_split;
    k_lo = t_begin * BK;
    k_end = min(min(t_begin + p.tiles_per_split, (K + BK - 1) / BK) * BK,
                K);
  }
  const int ntiles = (k_end - k_lo + BK - 1) / BK;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_stage(t, k_lo, k_end);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();    // stage t landed; everyone is done with t-1
    if (t + STAGES - 1 < ntiles) load_stage(t + STAGES - 1, k_lo, k_end);
    cp_async_commit();

    const float* xs = ring + (t % STAGES) * stage;
    const float* wr = xs + BM * BK;
    if constexpr (GATHER) {
      // acc += x[:, k] w[k, :] for this group's 16 k, ascending: the same
      // fmaf chain per output as the float4 form below
      const float* xg = xs + grp * (BK / 2) * BM + 4 * ty;
      const float* wg = wr + grp * (BK / 2) * BN + 4 * tx;
#pragma unroll
      for (int kk = 0; kk < BK / 2; ++kk) {
        float a[TM], b[8];
#pragma unroll
        for (int g = 0; g < TM / 4; ++g) {
          const float4 v = *(const float4*)&xg[kk * BM + 4 * TY * g];
          a[4 * g] = v.x, a[4 * g + 1] = v.y, a[4 * g + 2] = v.z,
          a[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = *(const float4*)&wg[kk * BN + 4 * TX * h];
          b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z,
          b[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    } else {
      const int k0 = k_lo + t * BK;
      const float* sr = wr + BK * BN;
      const float* er = sr + BK * BN;
      const uint8_t* br = (const uint8_t*)(er + (has_eps ? BK * BN : 0));
#pragma unroll
      for (int u = 0; u < BK * BN / THREADS; ++u) {
        const int i = tid + u * THREADS;
        const int k = k_minor ? (i & (BK - 1)) : (i / BN);
        const int n = k_minor ? (i / BK) : (i & (BN - 1));
        float v = 0.f;
        if (k0 + k < k_end && n0 + n < N) {
          float e = 0.f;
          if (noise)
            e = has_eps
                    ? cell_at<BN>(er, p.eps, k, n)
                    : gauss(seed, (unsigned long long)(k0 + k) * N + n0 + n);
          v = w_eff(cell_at<BN>(wr, p.w, k, n),
                    cell_at<BN>(br, p.broken, k, n) ? 1.f : 0.f,
                    cell_at<BN>(sr, p.stuck, k, n), levels, s, noise,
                    p.sigma, e);
        }
        ws[n * WP + k] = v;
      }
      __syncthreads();

      const float* xg = xs + ty * BK;   // rows ty + TY i share ty's swizzle
      const float* wg = ws + tx * WP + grp * (BK / 2);
#pragma unroll
      for (int kk = 0; kk < BK / 2; kk += 4) {
        const int xk = ((((grp * (BK / 2) + kk) >> 2) ^ ty) & 7) << 2;
        float4 b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          b[j] = *(const float4*)&wg[TX * j * WP + kk];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 a = *(const float4*)&xg[TY * i * BK + xk];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = dot_acc(a, b[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the two k halves, added in a fixed order: group 0's + group 1's
  float* red = ring;                  // TM * 8 * 128 floats fit the ring
  const int t128 = tid & 127;
  if (grp == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[(i * 8 + j) * 128 + t128] = acc[i][j];
  }
  __syncthreads();

  if constexpr (!tiled) {
    float* dst = p.splits > 1
                     ? p.part + ((long long)c * p.splits + sub) * MN
                     : p.out + c * MN;
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int m = m0 + row(i), n = n0 + col(j);
          if (m < M && n < N)
            dst[(long long)m * N + n] =
                __fadd_rn(acc[i][j], red[(i * 8 + j) * 128 + t128]);
        }
    }
  } else {
    // the K-tile's raw partial to `part`; at adc_levels > 0 also its
    // N-tiles' max |partial| to `amax`
    __shared__ unsigned colmax[BN];   // max |partial| bits of a column
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], red[(i * 8 + j) * 128 + t128]);
    }
    if (p.adc_levels > 0.f) {
      // max |partial| of each column over the block's rows (an integer
      // max on the bits: order-free), then of each N-tile's columns
      if (tid < BN) colmax[tid] = 0u;
      __syncthreads();
      if (grp == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          unsigned mx = 0u;
          const int n = n0 + col(j);
#pragma unroll
          for (int i = 0; i < TM; ++i)
            if (m0 + row(i) < M && n < N)
              mx = max(mx, __float_as_uint(fabsf(acc[i][j])));
          // the warp's lanes TX apart share a column
#pragma unroll
          for (int o = TX; o < 32; o <<= 1)
            mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          if ((tid & 31) < TX) atomicMax(&colmax[col(j)], mx);
        }
      }
      __syncthreads();
      if (tid < BN && n0 + tid < N) {
        const int jt = (n0 + tid) / p.bn;
        const int lo = max(jt * p.bn, n0) - n0;
        const int hi = min(min((jt + 1) * p.bn, N), n0 + BN) - n0;
        unsigned mx = 0u;
        for (int q = lo; q < hi; ++q) mx = max(mx, colmax[q]);
        // one global max per N-tile the block touches, by its first
        // column here; the tile's other blocks join by atomicMax
        if (tid == lo)
          atomicMax(p.amax + ((long long)c * p.gk + sub) * p.gn + jt, mx);
      }
    }
    if (grp == 0) {
      float* dst = p.part + ((long long)c * p.gk + sub) * MN;
      // B3's 4 neighbouring columns go out as one float4 where they can
      const bool vec = GATHER && N % 4 == 0;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; j += 4) {
          const int m = m0 + row(i), n = n0 + col(j);
          if (m >= M) continue;
          float* d = dst + (long long)m * N + n;
          if (vec && n + 3 < N) {
            *(float4*)d = make_float4(acc[i][j], acc[i][j + 1],
                                      acc[i][j + 2], acc[i][j + 3]);
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (n0 + col(j + u) < N)
                dst[(long long)m * N + n0 + col(j + u)] = acc[i][j + u];
          }
        }
    }
  }

  // B2 split-K: the last block to arrive at this output tile sums the
  // splits, ascending
  const int parts = p.splits;
  if (tiled || parts == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    unsigned* ctr = p.counters +
                    ((long long)c * gridDim.y + blockIdx.y) * gridDim.z +
                    blockIdx.z;
    last = atomicAdd(ctr, 1u) == (unsigned)parts - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* pc = p.part + (long long)c * parts * MN;
  float* oc = p.out + c * MN;
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int m = m0 + i / BN, n = n0 + (i & (BN - 1));
    if (m < M && n < N) {
      const long long at = (long long)m * N + n;
      float sum = __ldcg(pc + at);
      for (int sp = 1; sp < parts; ++sp)
        sum = __fadd_rn(sum, __ldcg(pc + (long long)sp * MN + at));
      oc[at] = sum;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
lane_absmax_kernel(const float* __restrict__ w, long long sl, long long sk,
                   long long sn, int dense, int vec, int K, int N,
                   unsigned* __restrict__ scale_bits) {
  const int c = blockIdx.y, tid = threadIdx.x;
  unsigned m = absmax_bits(w + (long long)c * sl, sk, sn, dense, vec, K, N,
                           (long long)blockIdx.x * THREADS + tid,
                           (long long)gridDim.x * THREADS);
  __shared__ unsigned warp_max[THREADS / 32];
  m = block_max(m, warp_max, tid);
  if (tid == 0) {
    if (gridDim.x == 1)
      scale_bits[c] = m;
    else
      atomicMax(scale_bits + c, m);
  }
}

// B3's W_eff pass: every cell's effective read once a call, from w, broken,
// stuck (and eps) as stored, into weff (C, K, N), n contiguous, the layout
// of the GEMM pass's [k][n] tile. A block turns a 32 x 32 cell tile of
// lane c0 + blockIdx.z (a launch per 65535 lanes) through shared memory,
// so it reads along the stored weight's contiguous axis (k in Caffe's
// layout) and writes along n. The noise counter is k*N+n, as in B2's
// in-stage form.
__global__ void __launch_bounds__(THREADS)
weff_kernel(const __grid_constant__ Params p, float* __restrict__ weff,
            int c0) {
  __shared__ float tile[32][33];
  const int K = p.K, N = p.N, c = c0 + blockIdx.z;
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const float levels = p.levels;
  const float s =
      levels > 0.f ? __fdiv_rn(fmaxf(p.scale[c], 1e-12f), levels) : 0.f;
  const bool noise = p.sigma != 0.f, has_eps = p.eps.p != nullptr;
  const bool along_k = p.w.sr == 1;
  for (int i = ty; i < 32; i += THREADS / 32) {
    const int kk = along_k ? tx : i, nn = along_k ? i : tx;
    const int k = k0 + kk, n = n0 + nn;
    if (k < K && n < N) {
      float e = 0.f;
      if (noise)
        e = has_eps ? elem<float>(p.eps, c, k, n)
                    : gauss((uint32_t)p.seeds[c],
                            (unsigned long long)k * N + n);
      tile[kk][nn] = w_eff(elem<float>(p.w, c, k, n),
                           elem<uint8_t>(p.broken, c, k, n) ? 1.f : 0.f,
                           elem<float>(p.stuck, c, k, n), levels, s, noise,
                           p.sigma, e);
    }
  }
  __syncthreads();
  for (int i = ty; i < 32; i += THREADS / 32) {
    const int k = k0 + i, n = n0 + tx;
    if (k < K && n < N)
      weff[((long long)c * K + k) * N + n] = tile[i][tx];
  }
}

template <int BM, int BN, bool GATHER>
int smem_bytes(bool has_eps) {
  return ((GATHER ? 0 : BN * WP) +
          STAGES * stage_floats(BM, BN, has_eps, GATHER)) *
         (int)sizeof(float);
}

template <int BM>
int blocks_per_sm(bool has_eps) {
  const int smem = smem_bytes<BM, 64, false>(has_eps);
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      crossbar_kernel<BM, 64, kPlain, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, crossbar_kernel<BM, 64, kPlain, false>, THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

template <int BM, int BN, Epilogue EPI, bool GATHER>
cudaError_t launch_gemm(const Params& p, dim3 grid, cudaStream_t stream) {
  const int smem = smem_bytes<BM, BN, GATHER>(p.eps.p != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      crossbar_kernel<BM, BN, EPI, GATHER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  crossbar_kernel<BM, BN, EPI, GATHER><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

Operand operand(const void* ptr, const long long* strides, int elem) {
  Operand o{ptr, strides[0], strides[1], strides[2], 0};
  // the contiguous axis is the column, or the row of a k-minor weight view
  const long long other = o.sc == 1 ? o.sr : o.sc;
  const long long unit = o.sc == 1 ? o.sc : o.sr;
  const int per = 16 / elem;
  o.vec = ptr != nullptr && unit == 1 && other % per == 0 &&
          o.sl % per == 0 && (uintptr_t)ptr % 16 == 0;
  return o;
}

// The operands and the lane constants shared by B2, B2t and B3; scratch
// starts with the C lane scales.
Params make_params(const void* x, const long long* x_strides, const void* w,
                   const long long* w_strides, const void* broken,
                   const long long* broken_strides, const void* stuck,
                   const long long* stuck_strides, const void* eps,
                   const long long* eps_strides, const void* seeds,
                   float sigma, float levels, int C, int M, int K, int N,
                   void* scratch, void* part, void* out) {
  Params p{};
  p.x = operand(x, x_strides, 4);
  p.w = operand(w, w_strides, 4);
  p.broken = operand(broken, broken_strides, 1);
  p.stuck = operand(stuck, stuck_strides, 4);
  const long long none[3] = {0, 0, 1};
  p.eps = operand(eps, eps ? eps_strides : none, 4);
  // x is always kept [m][k]: its 16-byte loads need k contiguous
  if (p.x.sc != 1) p.x.vec = 0;
  p.scale = (const float*)scratch;
  p.seeds = (const int32_t*)seeds;
  p.sigma = sigma;
  p.levels = levels;
  p.C = C, p.M = M, p.K = K, p.N = N;
  p.splits = 1;
  p.part = (float*)part;
  p.counters = (unsigned*)scratch + C;
  p.out = (float*)out;
  return p;
}

// Zero the first `zero` words of scratch when a pass needs them, then (at
// levels > 0) the scale pass: blocks of at least 4096 cells, enough to fill
// the card; several blocks a lane join by atomicMax on zeroed words.
cudaError_t scale_pass(const void* w, const long long* w_strides,
                       float levels, int C, int K, int N, long long zero,
                       void* scratch, cudaStream_t stream) {
  int scale_blocks = 1;
  if (levels > 0.f) {
    const long long most = ((long long)K * N + 4095) / 4096;
    scale_blocks = (int)std::min<long long>((264 + C - 1) / C, most);
    if (scale_blocks < 1) scale_blocks = 1;
  }
  if (scale_blocks > 1 || zero > C) {
    cudaError_t err = cudaMemsetAsync(
        scratch, 0, (size_t)std::max<long long>(zero, C) * 4, stream);
    if (err != cudaSuccess) return err;
  }
  if (levels > 0.f) {
    const long long sk = w_strides[1], sn = w_strides[2];
    const int dense = (sn == 1 && sk == N) || (sk == 1 && sn == K) ||
                      (K == 1 && sn == 1) || (N == 1 && sk == 1);
    const int vec = (uintptr_t)w % 16 == 0 && w_strides[0] % 4 == 0;
    lane_absmax_kernel<<<dim3(scale_blocks, C), THREADS, 0, stream>>>(
        (const float*)w, w_strides[0], sk, sn, dense, vec, K, N,
        (unsigned*)scratch);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

template <Epilogue EPI>
cudaError_t launch_rows(int bm, const Params& p, dim3 grid,
                        cudaStream_t stream) {
  return bm == 128   ? launch_gemm<128, 64, EPI, false>(p, grid, stream)
         : bm == 112 ? launch_gemm<112, 64, EPI, false>(p, grid, stream)
         : bm == 32  ? launch_gemm<32, 64, EPI, false>(p, grid, stream)
                     : cudaErrorInvalidValue;
}

// B3's tile rows by column tile: 256 x 32 or 128 x 64 (a thread owns 8
// columns either way)
constexpr int b3_rows(int tile_n) { return tile_n == 32 ? 256 : 128; }

// A K-tile's stages start at kt * bk: 16-byte loads along k need bk a
// multiple of the elements in 16 bytes
void align_to_tiles(Params& p, int bk) {
  if (p.x.sc == 1 && bk % 4) p.x.vec = 0;
  for (Operand* o : {&p.w, &p.stuck, &p.eps})
    if (o->sc != 1 && bk % 4) o->vec = 0;
  if (p.broken.sc != 1 && bk % 16) p.broken.vec = 0;
}

}  // namespace

// Load every kernel this library can launch into the current context (under
// CUDA's lazy loading a kernel is otherwise loaded at its first launch);
// launches nothing. Returns the first CUDA error, or 0.
extern "C" int rram_crossbar_load_module() {
  cudaFuncAttributes a;
  const void* kernels[] = {
      (const void*)crossbar_kernel<128, 64, kPlain, false>,
      (const void*)crossbar_kernel<112, 64, kPlain, false>,
      (const void*)crossbar_kernel<32, 64, kPlain, false>,
      (const void*)crossbar_kernel<128, 64, kTile, false>,
      (const void*)crossbar_kernel<112, 64, kTile, false>,
      (const void*)crossbar_kernel<32, 64, kTile, false>,
      (const void*)crossbar_kernel<256, 32, kTile, true>,
      (const void*)crossbar_kernel<128, 64, kTile, true>,
      (const void*)lane_absmax_kernel,
      (const void*)weff_kernel,
      (const void*)rram::adc_sum_kernel,
      (const void*)rram::adc_sum_any_kernel};
  for (const void* k : kernels) {
    const cudaError_t err = cudaFuncGetAttributes(&a, k);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Resident blocks of the GEMM pass per SM (`bm` rows a tile, with or without
// an eps tile in the ring), or minus the CUDA error; launches nothing.
extern "C" int rram_crossbar_blocks_per_sm(int bm, int has_eps) {
  return bm == 128   ? blocks_per_sm<128>(has_eps)
         : bm == 112 ? blocks_per_sm<112>(has_eps)
                     : blocks_per_sm<32>(has_eps);
}

// B2. Strides are in elements, (lane, row, column) of the (C, M, K) view of
// x and the (C, K, N) views of w, broken (uint8), stuck and eps (nullptr:
// none). `bm` is the output tile's rows (128, 112 or 32) and `splits` the
// split of the K stages the caller sized `part` (C, splits, M, N) for;
// `scratch` holds C floats of lane scales, then one counter per output tile
// (C * ceil(M/bm) * ceil(N/64)), zeroed here when a pass needs it.
extern "C" int rram_crossbar_forward(
    const void* x, const long long* x_strides, const void* w,
    const long long* w_strides, const void* broken,
    const long long* broken_strides, const void* stuck,
    const long long* stuck_strides, const void* eps,
    const long long* eps_strides, const void* seeds, float sigma,
    float levels, int C, int M, int K, int N, int bm, int splits,
    void* scratch, void* part, void* out, void* stream_ptr) {
  if (C <= 0 || M <= 0 || N <= 0) return (int)cudaGetLastError();
  if ((bm != 128 && bm != 112 && bm != 32) || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int ktiles = (K + BK - 1) / BK;
  if (splits > 1 && splits > ktiles) return (int)cudaErrorInvalidValue;

  Params p = make_params(x, x_strides, w, w_strides, broken, broken_strides,
                         stuck, stuck_strides, eps, eps_strides, seeds, sigma,
                         levels, C, M, K, N, scratch, part, out);
  p.splits = splits;
  p.tiles_per_split = (ktiles + splits - 1) / splits;
  if (splits > 1 && (long long)p.tiles_per_split * (splits - 1) >= ktiles)
    return (int)cudaErrorInvalidValue;           // an empty split

  const long long tiles =
      (long long)C * ((M + bm - 1) / bm) * ((N + 63) / 64);
  cudaError_t err = scale_pass(w, w_strides, levels, C, K, N,
                               C + (splits > 1 ? tiles : 0), scratch, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(C * splits, (M + bm - 1) / bm, (N + 63) / 64);
  return (int)launch_rows<kPlain>(bm, p, grid, stream);
}

// B2t: the same operands and strides; bk x bn crossbar tiles of the (K, N)
// view, each partial through its own ADC of `adc_levels` (0: none), the
// K-tiles summed in ascending order. `bm` is the GEMM pass's tile rows (128,
// 112 or 32). `scratch` holds C lane scales, then the tiles' maxima
// (C * gk * gn); `part` is the K-tiles' raw partials (C, gk, M, N).
extern "C" int rram_crossbar_tiled_forward(
    const void* x, const long long* x_strides, const void* w,
    const long long* w_strides, const void* broken,
    const long long* broken_strides, const void* stuck,
    const long long* stuck_strides, const void* eps,
    const long long* eps_strides, const void* seeds, float sigma,
    float levels, float adc_levels, int C, int M, int K, int N, int bk,
    int bn, int bm, void* scratch, void* part, void* out,
    void* stream_ptr) {
  if (C <= 0 || M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (K <= 0 || bk <= 0 || bn <= 0 || (bm != 128 && bm != 112 && bm != 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  bk = std::min(bk, K);      // one K-tile either way; keeps kt * bk in range

  Params p = make_params(x, x_strides, w, w_strides, broken, broken_strides,
                         stuck, stuck_strides, eps, eps_strides, seeds, sigma,
                         levels, C, M, K, N, scratch, part, out);
  p.bk = bk, p.bn = bn;
  p.gk = (K + bk - 1) / bk, p.gn = (N + bn - 1) / bn;
  p.adc_levels = adc_levels;
  p.amax = (unsigned*)scratch + C;
  align_to_tiles(p, bk);

  cudaError_t err = scale_pass(w, w_strides, levels, C, K, N,
                               C + (long long)C * p.gk * p.gn, scratch,
                               stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_rows<kTile>(
      bm, p, dim3(C * p.gk, (M + bm - 1) / bm, (N + 63) / 64), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)rram::launch_adc_sum((const float*)part, p.amax, adc_levels, C,
                                   M, N, bn, p.gk, p.gn, (float*)out, stream);
}

// B3: B2t's call with x gathered. x is the zero-padded flat activation,
// x_strides (lane stride or 0 for a shared x, unused, unused); element
// (m, k) of lane c's operand is x[c * lane + row_base[m] + col_off[k]]
// (int32 plans on the card). w, broken, stuck, eps as for B2t. `tile_n`
// is the GEMM pass's column tile (32 or 64; its rows follow: 256 or 128).
// `weff` (C * K * N floats) receives W_eff in a pass of its own before the
// GEMM. `scratch` and `part` as for B2t.
extern "C" int rram_crossbar_implicit_forward(
    const void* x, const long long* x_strides, const void* w,
    const long long* w_strides, const void* broken,
    const long long* broken_strides, const void* stuck,
    const long long* stuck_strides, const void* eps,
    const long long* eps_strides, const void* seeds, float sigma,
    float levels, float adc_levels, const void* row_base,
    const void* col_off, int C, int M, int K, int N, int bk, int bn,
    int tile_n, void* scratch, void* weff, void* part, void* out,
    void* stream_ptr) {
  if (C <= 0 || M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (K <= 0 || bk <= 0 || bn <= 0 || weff == nullptr ||
      (tile_n != 32 && tile_n != 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  bk = std::min(bk, K);

  Params p = make_params(x, x_strides, w, w_strides, broken, broken_strides,
                         stuck, stuck_strides, eps, eps_strides, seeds, sigma,
                         levels, C, M, K, N, scratch, part, out);
  p.row_base = (const int32_t*)row_base;
  p.col_off = (const int32_t*)col_off;
  p.bk = bk, p.bn = bn;
  p.gk = (K + bk - 1) / bk, p.gn = (N + bn - 1) / bn;
  p.adc_levels = adc_levels;
  p.amax = (unsigned*)scratch + C;

  cudaError_t err = scale_pass(w, w_strides, levels, C, K, N,
                               C + (long long)C * p.gk * p.gn, scratch,
                               stream);
  if (err != cudaSuccess) return (int)err;
  for (int c0 = 0; c0 < C; c0 += 65535) {
    weff_kernel<<<dim3((N + 31) / 32, (K + 31) / 32, std::min(C - c0, 65535)),
                  THREADS, 0, stream>>>(p, (float*)weff, c0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // the GEMM pass reads x and W_eff (C, K, N) alone
  const long long st[3] = {(long long)K * N, N, 1};
  p.w = operand(weff, st, 4);
  const dim3 grid(C * p.gk, (M + b3_rows(tile_n) - 1) / b3_rows(tile_n),
                  (N + tile_n - 1) / tile_n);
  err = tile_n == 32 ? launch_gemm<256, 32, kTile, true>(p, grid, stream)
                     : launch_gemm<128, 64, kTile, true>(p, grid, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)rram::launch_adc_sum((const float*)part, p.amax, adc_levels, C,
                                   M, N, bn, p.gk, p.gn, (float*)out, stream);
}
