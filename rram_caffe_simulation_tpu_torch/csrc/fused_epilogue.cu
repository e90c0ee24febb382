// Fused ApplyUpdate + Fail epilogue for the packed fault banks (kernel B1).
//
// Replaces the Pallas kernel of rram_caffe_simulation_tpu/fault/fused.py
// (`_make_fused_kernel` / `_epilogue_tile` :52, launched once per leaf by
// `_fused_call` :99 and `_fused_call_batched` :118). Per cell, exactly
// `data - upd` followed by `fault/packed.py fail_packed`:
//   new   = data - upd                                  (__fsub_rn)
//   lq'   = lq - 1 where lq > 0, gated by mode: 0 write (|upd| >= 1e-20f),
//           1 always, 2 never (lq' = lq)
//   data' = lq' <= 0 ? stuck : new, stuck = ((byte >> 2i) & 3) - 1
//
// Layout: a leaf's data/upd/life_q are (rows, L) row-major with any leading
// axes (the sweep's config axis C included) folded into rows; its stuck bank
// is (rows, ceil(L/4)) uint8, four 2-bit codes a byte, the last byte of a
// row padded. Outputs are new tensors (the caller's params alias data).
//
// What bounds it on an H100: bytes. Per cell it reads 8 B of f32, 2 or 4 B
// of counter and 1/4 B of bank and writes 4 B and the counter again, with a
// handful of integer and float operations: far below the card's balance
// point. The design moves every byte once, in one launch for all of a
// step's fault leaves, at the width the memory system serves best:
//   - One launch a group. The leaves (a step's 4 untiled, 10 tiled) travel
//     as a table in the kernel's parameters (six pointers, the cell count,
//     L, ceil(L/4), the first tile; read in place as a __grid_constant__),
//     so no host-to-device copy precedes the launch. A tile is 4096
//     consecutive cells of one leaf; `fault/fused.py b1_plan` numbers the
//     tiles leaf after leaf and the C function checks its numbers. A
//     persistent grid (as many blocks as are resident at once) strides over
//     the tiles, so the leaf is uniform across a block; a group larger than
//     the table takes more launches of the same kernel.
//   - 16-byte streaming access. A thread takes four chunks of a tile, each
//     four consecutive cells, neighbouring threads on neighbouring chunks.
//     It issues every load of its chunks (one 16-byte load each of data and
//     upd, one of 16 or 8 bytes of counters, evict-first) before it
//     computes, then stores them the same way (streaming stores).
//   - The bank byte by (row, column). Where L % 4 == 0 a chunk's four cells
//     share one byte, the chunk's index (the ip weights and ip1's bias, 99%
//     of the untiled sweep's bytes). Otherwise each cell's byte is
//     row * ceil(L/4) + col / 4, its bits 2 * (col % 4), with
//     (row, col) = divmod(flat, L): never a padding column.
//   - Alignment. A leaf whose six pointers are not all on the vector grid
//     (16 bytes; 8 for int16 counters) takes the same chunks by scalar
//     loads and stores, as does a leaf's partial last chunk. No copy.
// tests/test_torch_fused.py emulates these index maps on the CPU.
//
// Bit exactness: the subtract is one IEEE f32 op (__fsub_rn), the write
// gate compares |upd| with the float32 value of 1e-20 as the reference
// does, and the counter arithmetic is integer, so outputs equal the plain
// PyTorch version bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kEpsilon = 1e-20f;  // failure_maker.cu:25
constexpr int kThreads = 256;
constexpr int kChunks = 4;                           // chunks a thread a tile
constexpr long long kTileChunks = kThreads * kChunks;
constexpr long long kTileCells = 4 * kTileChunks;    // fused.B1_TILE
constexpr int kMaxLeaves = 16;                       // fused.B1_LEAVES

struct Leaf {
  const float* data;
  const float* upd;
  const void* lq;
  const uint8_t* bank;
  float* out_data;
  void* out_lq;
  long long cells;
  long long first_tile;
  int L, Lb;     // the last axis and its bank bytes, ceil(L / 4)
  int vec;       // all six pointers on the vector grid
};

struct Table {
  Leaf leaf[kMaxLeaves];
  long long tiles;
  int n;
};

// four counters of a chunk in registers, as int
__device__ __forceinline__ void load4(const int32_t* p, long long c, int* q) {
  const int4 v = __ldcs(reinterpret_cast<const int4*>(p) + c);
  q[0] = v.x, q[1] = v.y, q[2] = v.z, q[3] = v.w;
}

__device__ __forceinline__ int lo16(int v) {
  return (int)(int16_t)(uint16_t)((uint32_t)v & 0xffffu);
}

__device__ __forceinline__ void load4(const int16_t* p, long long c, int* q) {
  const int2 v = __ldcs(reinterpret_cast<const int2*>(p) + c);
  q[0] = lo16(v.x), q[1] = lo16((int)((uint32_t)v.x >> 16));
  q[2] = lo16(v.y), q[3] = lo16((int)((uint32_t)v.y >> 16));
}

__device__ __forceinline__ void store4(int32_t* p, long long c, const int* q) {
  __stcs(reinterpret_cast<int4*>(p) + c, make_int4(q[0], q[1], q[2], q[3]));
}

__device__ __forceinline__ uint32_t pack16(int a, int b) {
  return ((uint32_t)a & 0xffffu) | ((uint32_t)b << 16);
}

__device__ __forceinline__ void store4(int16_t* p, long long c, const int* q) {
  __stcs(reinterpret_cast<int2*>(p) + c,
         make_int2((int)pack16(q[0], q[1]), (int)pack16(q[2], q[3])));
}

// One tile of one leaf. QUAD: L % 4 == 0 (a chunk's cells share a byte);
// VEC: the leaf's pointers are on the vector grid.
template <typename LQ, bool QUAD, bool VEC>
__device__ __forceinline__ void tile(const Leaf& lf, long long t, int mode) {
  const LQ* lq = static_cast<const LQ*>(lf.lq);
  LQ* out_lq = static_cast<LQ*>(lf.out_lq);
  const long long chunks = (lf.cells + 3) / 4;
  const long long c0 = (t - lf.first_tile) * kTileChunks + threadIdx.x;
  float d[kChunks][4], u[kChunks][4];
  int q[kChunks][4];
  uint32_t code[kChunks][4];   // each cell's bank byte
  int shift[kChunks][4];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const long long c = c0 + (long long)k * kThreads;
    if (c >= chunks) continue;
    const long long f0 = 4 * c;
    const int n = (int)min(4LL, lf.cells - f0);
    if (VEC && n == 4) {
      const float4 dv = __ldcs(reinterpret_cast<const float4*>(lf.data) + c);
      const float4 uv = __ldcs(reinterpret_cast<const float4*>(lf.upd) + c);
      d[k][0] = dv.x, d[k][1] = dv.y, d[k][2] = dv.z, d[k][3] = dv.w;
      u[k][0] = uv.x, u[k][1] = uv.y, u[k][2] = uv.z, u[k][3] = uv.w;
      load4(lq, c, q[k]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        d[k][i] = i < n ? lf.data[f0 + i] : 0.0f;
        u[k][i] = i < n ? lf.upd[f0 + i] : 0.0f;
        q[k][i] = i < n ? (int)lq[f0 + i] : 0;
      }
    }
    if (QUAD) {
      const uint32_t byte = __ldcs(lf.bank + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) code[k][i] = byte, shift[k][i] = 2 * i;
    } else {
      long long row = f0 / lf.L;
      int col = (int)(f0 - row * lf.L);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        code[k][i] = i < n ? __ldg(lf.bank + row * lf.Lb + (col >> 2)) : 0u;
        shift[k][i] = 2 * (col & 3);
        if (++col == lf.L) col = 0, ++row;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const long long c = c0 + (long long)k * kThreads;
    if (c >= chunks) continue;
    const long long f0 = 4 * c;
    const int n = (int)min(4LL, lf.cells - f0);
    float o[4];
    int q2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = q[k][i];
      const bool dec =
          v > 0 && (mode == 1 || (mode == 0 && fabsf(u[k][i]) >= kEpsilon));
      q2[i] = dec ? v - 1 : v;
      const float stuck = (float)((code[k][i] >> shift[k][i]) & 3u) - 1.0f;
      o[i] = q2[i] <= 0 ? stuck : __fsub_rn(d[k][i], u[k][i]);
    }
    if (VEC && n == 4) {
      __stcs(reinterpret_cast<float4*>(lf.out_data) + c,
             make_float4(o[0], o[1], o[2], o[3]));
      store4(out_lq, c, q2);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < n) {
          lf.out_data[f0 + i] = o[i];
          out_lq[f0 + i] = (LQ)q2[i];
        }
      }
    }
  }
}

template <typename LQ>
__global__ void __launch_bounds__(kThreads)
    fused_update_fail_kernel(const __grid_constant__ Table table, int mode) {
  int e = 0;
  for (long long t = blockIdx.x; t < table.tiles; t += gridDim.x) {
    // the tiles a block visits ascend, and so do the leaves' first tiles
    while (e + 1 < table.n && t >= table.leaf[e + 1].first_tile) ++e;
    const Leaf& lf = table.leaf[e];
    const bool quad = lf.L % 4 == 0;
    if (lf.vec) {
      if (quad) tile<LQ, true, true>(lf, t, mode);
      else      tile<LQ, false, true>(lf, t, mode);
    } else {
      if (quad) tile<LQ, true, false>(lf, t, mode);
      else      tile<LQ, false, false>(lf, t, mode);
    }
  }
}

bool on_grid(const void* p, int bytes) {
  return ((uintptr_t)p % (uintptr_t)bytes) == 0;
}

template <typename LQ>
int launch(const Table& table, int mode, cudaStream_t stream) {
  static int grid = 0;   // the persistent grid: blocks resident at once
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_update_fail_kernel<LQ>, kThreads, 0);
    grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long blocks = table.tiles < grid ? table.tiles : grid;
  fused_update_fail_kernel<LQ>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(table, mode);
  return (int)cudaGetLastError();
}

}  // namespace

// Load both counter widths' kernels into the current context (under CUDA's
// lazy loading a kernel is otherwise loaded at its first launch); launches
// nothing. Returns the first CUDA error, or 0.
extern "C" int rram_fused_epilogue_load_module() {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fused_update_fail_kernel<int16_t>);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&a, fused_update_fail_kernel<int32_t>);
  return (int)err;
}

// One launch for `n` leaves (1 <= n <= 16) of one counter width (2 or 4
// bytes). `ptrs` holds six pointers a leaf (data, upd, life_q, bank,
// data', life_q'), `plan` three numbers a leaf (cells, L, first tile), in
// `fused.b1_plan`'s order; `tiles` is the launch's tile count.
extern "C" int rram_fused_update_fail_leaves(int lq_bytes, int n,
                                             const void* const* ptrs,
                                             const long long* plan,
                                             long long tiles, int mode,
                                             void* stream) {
  if (n < 1 || n > kMaxLeaves || (lq_bytes != 2 && lq_bytes != 4) ||
      mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  Table table;
  table.n = n;
  table.tiles = tiles;
  long long first = 0;
  for (int e = 0; e < n; ++e) {
    Leaf& lf = table.leaf[e];
    const void* const* p = ptrs + 6 * e;
    lf.data = (const float*)p[0];
    lf.upd = (const float*)p[1];
    lf.lq = p[2];
    lf.bank = (const uint8_t*)p[3];
    lf.out_data = (float*)p[4];
    lf.out_lq = (void*)p[5];
    lf.cells = plan[3 * e];
    const long long L = plan[3 * e + 1];
    lf.first_tile = plan[3 * e + 2];
    // the plan's numbers must be the kernel's: tiles of kTileCells cells,
    // leaf after leaf
    if (lf.cells < 0 || lf.first_tile != first ||
        (lf.cells > 0 && (L < 1 || L > 0x7fffffff || lf.cells % L != 0)))
      return (int)cudaErrorInvalidValue;
    lf.L = (int)(L > 0 ? L : 1);
    lf.Lb = (lf.L + 3) / 4;
    lf.vec = on_grid(p[0], 16) && on_grid(p[1], 16) && on_grid(p[4], 16) &&
             on_grid(p[2], 4 * lq_bytes) && on_grid(p[5], 4 * lq_bytes);
    first += (lf.cells + kTileCells - 1) / kTileCells;
  }
  if (first != tiles) return (int)cudaErrorInvalidValue;
  if (tiles == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  return lq_bytes == 2 ? launch<int16_t>(table, mode, s)
                       : launch<int32_t>(table, mode, s);
}
