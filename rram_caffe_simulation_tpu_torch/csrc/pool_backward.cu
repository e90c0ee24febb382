// Max-pool backward (kernel B4): dx of a MAX pooling layer over f32 planes.
//
// Replaces the Pallas kernel of rram_caffe_simulation_tpu/ops/pool_backward.py
// (`_bwd_kernel` :46, launched by `_pallas_bwd` :141). Semantics, per window:
//   - the window's cotangent goes to the FIRST element, in row-major window
//     order, that attains the window max (torch.argmax's first occurrence;
//     a NaN counts as the max, the first NaN wins);
//   - positions outside the plane (the pooling layer's low padding and
//     Caffe's CEIL high padding) read as -inf, as the padded forward does;
//   - overlapping windows add into a shared element in ascending window
//     offset, from 0.f, with __fadd_rn: the reference kernel's order and the
//     plain version's (`max_pool_backward_plain`), matched bit for bit.
//
// Layout: x (P, H, W), g (P, Ho, Wo), dx (P, H, W), all row-major f32, any
// plane count P (the sweep folds batch x configs x channels into P). `ph`,
// `pw` are the low pads; window (oh, ow) covers padded rows oh*sh .. +kh.
//
// What bounds it on an H100: bytes. The function must read x and g once and
// write dx once (9 B per input element at CIFAR's 3/2 pool1) and does a few
// compares and adds per byte. So the design reads x and g once and writes dx
// once, in one launch, and keeps every intermediate in shared memory:
//   - Work unit, a tile (`pool_backward.b4_plan` chooses it): `pt` whole
//     planes where a plane fits the block's budget (then x and g of a tile
//     are each one contiguous span), else a band of `bh` input rows (and of
//     `bw` columns if need be) of one plane. A band's x region takes the
//     halo its windows need; edge windows are argmaxed by both neighbouring
//     tiles, which repeats a little arithmetic and keeps device scratch,
//     atomics and a second kernel out. The -inf frame never exists in memory: a read
//     outside the plane yields -inf.
//   - A persistent grid (as many blocks as fit on the card) walks the tiles
//     through a ring of two stages: the next tile's x and g are in flight
//     while the current tile computes. Whole-plane tiles whose spans are
//     16-byte aligned come in by Hopper's 1-D bulk copy (cp.async.bulk, one
//     thread, completion on an mbarrier); other spans by 16-byte cp.async
//     (4-byte at a ragged head or tail), neighbouring threads on neighbouring
//     addresses, column bands row by row.
//   - Compute, in shared memory and registers: each thread takes up to 8
//     windows of the tile, finds their first argmaxes in lockstep (their
//     loads in flight together) and keeps each argmax and cotangent in
//     registers; the x buffer, once read, takes the band's dx (zeroed),
//     and the cotangents are added at their argmaxes in ceil(kh/sh) *
//     ceil(kw/sw) passes of the block (4 at 3/2), ordered so that each
//     element adds in ascending window offset and no two windows of a pass
//     meet: no atomics, a barrier between passes. Then dx goes out in
//     16-byte stores (4-byte at a ragged head or tail). Index maps divide
//     by multiply-high magic numbers, never by a runtime division in a
//     loop; plane offsets are 64-bit, so one launch takes any plane count.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kHeader = (8 * kStages + 15) / 16 * 16;   // the mbarriers
constexpr int kWindows = 8;   // windows a thread; a tile has at most 2048

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (the magic
// number is computed once on the host).
struct FastDiv {
  uint32_t d, m, s;
};

FastDiv make_div(uint32_t d) {
  uint32_t s = 0;
  while (s < 32 && (1ULL << s) < d) ++s;
  const uint64_t m = ((1ULL << 32) * ((1ULL << s) - d)) / d + 1;
  return FastDiv{d, (uint32_t)m, s};
}

__device__ __forceinline__ int div(int n, FastDiv f) {
  const uint32_t t = __umulhi((uint32_t)n, f.m);
  return (int)((t + (uint32_t)n) >> f.s);
}

struct Geometry {
  int H, W, Ho, Wo, kh, kw, sh, sw, ph, pw;
  // the plan: planes a tile, band rows and columns, bands a plane, the x
  // region's rows and row pitch, the windows' rows and columns, g's pitch
  int pt, bh, bw, nbh, nbw, xh, xpitch, wh, ww, gpitch, dpitch;
  int passes, pass_cols;    // ceil(kh / sh) * ceil(kw / sw), ceil(kw / sw)
  long long planes, tiles;
  int x_floats, g_floats;   // a stage's buffers, 16-byte multiples
  bool bulk;                // whole-plane tiles, 16-byte spans
  FastDiv div_sh, div_sw, div_ww, div_wh, div_kw;
};

// The windows [lo, hi] of one axis that hold an element of input range
// [a, b), and the input range [xlo, xhi) they read, clipped to [0, n).
// `whole`: the axis is not banded, so every window and the whole axis.
__device__ __forceinline__ void band(int a, int b, int n, int k, FastDiv s,
                                     int p, int n_out, bool whole, int* lo,
                                     int* hi, int* xlo, int* xhi) {
  if (whole) {
    *lo = 0, *hi = n_out - 1, *xlo = 0, *xhi = n;
    return;
  }
  const int first = a + p - k + 1;
  *lo = first <= 0 ? 0 : div(first + (int)s.d - 1, s);
  const int top = div(b - 1 + p, s);
  *hi = top < n_out - 1 ? top : n_out - 1;
  const int r0 = *lo * (int)s.d - p, r1 = *hi * (int)s.d - p + k;
  *xlo = r0 > 0 ? r0 : 0;
  *xhi = r1 < n ? r1 : n;
}

// One tile's place: its planes, its band and its windows.
struct Tile {
  long long p0;
  int n;                    // planes in the tile
  int r0, r1, c0, c1;       // the band, input rows and columns
  int oh_lo, oh_hi, ow_lo, ow_hi;
  int xr0, xr1, xc0, xc1;   // the x region
};

__device__ __forceinline__ Tile locate(long long t, const Geometry& G) {
  Tile T;
  const long long per_group = (long long)G.nbh * G.nbw;
  const long long grp = per_group == 1 ? t : t / per_group;
  const int rest = (int)(t - grp * per_group);
  const int bi = rest / G.nbw, bj = rest - bi * G.nbw;
  T.p0 = grp * G.pt;
  const long long left = G.planes - T.p0;
  T.n = left < G.pt ? (int)left : G.pt;
  T.r0 = bi * G.bh;
  T.r1 = T.r0 + G.bh < G.H ? T.r0 + G.bh : G.H;
  T.c0 = bj * G.bw;
  T.c1 = T.c0 + G.bw < G.W ? T.c0 + G.bw : G.W;
  band(T.r0, T.r1, G.H, G.kh, G.div_sh, G.ph, G.Ho, G.nbh == 1, &T.oh_lo,
       &T.oh_hi, &T.xr0, &T.xr1);
  band(T.c0, T.c1, G.W, G.kw, G.div_sw, G.pw, G.Wo, G.nbw == 1, &T.ow_lo,
       &T.ow_hi, &T.xc0, &T.xc1);
  return T;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Float offset that puts a copy of `src` on the same 16-byte phase in
// shared memory, so 16-byte copies line up on both sides.
__device__ __forceinline__ int phase(const float* src) {
  return (int)(((uintptr_t)src >> 2) & 3);
}

// n floats from src to dst (dst and src on the same 16-byte phase), by
// workers t of nt: a 4-byte head up to the 16-byte grid, 16-byte body,
// 4-byte tail.
__device__ __forceinline__ void copy_span(float* dst, const float* src, int n,
                                          int t, int nt) {
  int head = (4 - phase(src)) & 3;
  head = head < n ? head : n;
  const int body = (n - head) >> 2;
  if (t < head) cp4(dst + t, src + t);
  for (int i = t; i < body; i += nt) cp16(dst + head + 4 * i, src + head + 4 * i);
  for (int i = head + 4 * body + t; i < n; i += nt) cp4(dst + i, src + i);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Start the loads of tile t into a stage: by one thread as bulk copies
// (the stage's mbarrier counts the bytes), or by every thread as cp.async
// (one commit group a stage, committed by the caller). x lands at its
// 16-byte phase `phase(src)` within the buffer; readers add the same.
__device__ void load_tile(long long t, const Geometry& G, const float* x,
                          const float* g, float* sx, float* sg,
                          uint64_t* bar) {
  if (t >= G.tiles) return;
  const Tile T = locate(t, G);
  const long long hw = (long long)G.H * G.W, ohw = (long long)G.Ho * G.Wo;
  const float* xs = x + T.p0 * hw + (long long)T.xr0 * G.W + T.xc0;
  const float* gs = g + T.p0 * ohw + (long long)T.oh_lo * G.Wo + T.ow_lo;
  if (G.bulk) {
    if (threadIdx.x == 0) {
      const uint32_t bx = (uint32_t)(T.n * hw * 4), bg = (uint32_t)(T.n * ohw * 4);
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_addr(bar)),
          "r"(bx + bg)
          : "memory");
      bulk_load(sx, xs, bx, bar);
      bulk_load(sg, gs, bg, bar);
    }
    return;
  }
  const int rows = T.xr1 - T.xr0, wrows = T.oh_hi - T.oh_lo + 1;
  if (G.nbw == 1) {
    // whole rows: the tile's x and g are each one contiguous span
    copy_span(sx + phase(xs), xs, T.n * rows * G.W, threadIdx.x, kThreads);
    if (wrows > 0)
      copy_span(sg + phase(gs), gs, T.n * wrows * G.Wo, threadIdx.x, kThreads);
    return;
  }
  // a column band: row by row, a warp a row (the pitches keep every row
  // of a region on the first row's 16-byte phase)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cols = T.xc1 - T.xc0, wcols = T.ow_hi - T.ow_lo + 1;
  const int px = phase(xs), pg = phase(gs);
  for (int r = warp; r < rows; r += kThreads / 32)
    copy_span(sx + px + r * G.xpitch, xs + (long long)r * G.W, cols, lane, 32);
  if (wcols > 0)
    for (int r = warp; r < wrows; r += kThreads / 32)
      copy_span(sg + pg + r * G.gpitch, gs + (long long)r * G.Wo, wcols, lane,
                32);
}

// n floats from src (shared memory) to dst (device memory), on the same
// 16-byte phase, by workers t of nt: 4-byte head and tail, 16-byte body.
__device__ __forceinline__ void store_span(float* dst, const float* src, int n,
                                           int t, int nt) {
  int head = (4 - phase(dst)) & 3;
  head = head < n ? head : n;
  const int body = (n - head) >> 2;
  if (t < head) dst[t] = src[t];
  for (int i = t; i < body; i += nt)
    *reinterpret_cast<float4*>(dst + head + 4 * i) =
        *reinterpret_cast<const float4*>(src + head + 4 * i);
  for (int i = head + 4 * body + t; i < n; i += nt) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
    pool_backward_kernel(const float* __restrict__ x,
                         const float* __restrict__ g, float* __restrict__ dx,
                         Geometry G) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* stage0 = reinterpret_cast<float*>(smem + kHeader);
  const int stage_floats = G.x_floats + G.g_floats;
  const long long hw = (long long)G.H * G.W, ohw = (long long)G.Ho * G.Wo;

  if (G.bulk && threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int s = 0; s < kStages; ++s) {
    float* sx = stage0 + s * stage_floats;
    load_tile(blockIdx.x + (long long)s * gridDim.x, G, x, g, sx,
              sx + G.x_floats, bars + s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = 0;; ++k) {
    const long long t = blockIdx.x + (long long)k * gridDim.x;
    if (t >= G.tiles) break;
    const int s = k % kStages;
    float* sx = stage0 + s * stage_floats;
    float* sg = sx + G.x_floats;
    if (G.bulk)
      bar_wait(bars + s, (uint32_t)((k / kStages) & 1));
    else
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    __syncthreads();

    const Tile T = locate(t, G);
    const float* xr = sx + phase(x + T.p0 * hw + (long long)T.xr0 * G.W + T.xc0);
    const float* gr =
        sg + phase(g + T.p0 * ohw + (long long)T.oh_lo * G.Wo + T.ow_lo);
    const int xplane = (T.xr1 - T.xr0) * G.xpitch;
    const int gplane = (T.oh_hi - T.oh_lo + 1) * G.gpitch;
    const int nwr = T.oh_hi - T.oh_lo + 1, nwc = T.ow_hi - T.ow_lo + 1;
    // dx of the band lands in the x buffer once the argmaxes are taken,
    // on the 16-byte phase of its place in device memory
    float* out = dx + T.p0 * hw + (long long)T.r0 * G.W + T.c0;
    const int pd = phase(out);
    const int rows = T.r1 - T.r0, dplane = rows * G.dpitch;

    // 1. the first argmax of each of the thread's windows, its windows in
    //    lockstep (their shared-memory loads in flight together)
    const float neg_inf = -__int_as_float(0x7f800000);
    const int windows = T.n * G.wh * G.ww;
    int h0[kWindows], w0[kWindows], base[kWindows], first[kWindows];
    float best[kWindows];
#pragma unroll
    for (int j = 0; j < kWindows; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int rowi = div(i, G.div_ww), b = i - rowi * G.ww;
      const int pl = div(rowi, G.div_wh), a = rowi - pl * G.wh;
      const bool live = i < windows && a < nwr && b < nwc;
      // a window that is not the tile's has no row in the plane
      h0[j] = live ? (T.oh_lo + a) * G.sh - G.ph : -(1 << 30);
      w0[j] = (T.ow_lo + b) * G.sw - G.pw;
      base[j] = live ? pl * xplane + (h0[j] - T.xr0) * G.xpitch +
                           (w0[j] - T.xc0)
                     : 0;
      best[j] = neg_inf;
      first[j] = 0;
    }
    for (int ii = 0, l = 0; ii < G.kh; ++ii) {
      bool row_in[kWindows];
#pragma unroll
      for (int j = 0; j < kWindows; ++j)
        row_in[j] = (unsigned)(h0[j] + ii) < (unsigned)G.H;
      for (int jj = 0; jj < G.kw; ++jj, ++l) {
        const int off = ii * G.xpitch + jj;
#pragma unroll
        for (int j = 0; j < kWindows; ++j) {
          const bool in = row_in[j] && (unsigned)(w0[j] + jj) < (unsigned)G.W;
          const float v = in ? xr[base[j] + off] : neg_inf;
          // strict > keeps the first of equal maxima; a NaN beats any
          // number and the first NaN stays (torch.argmax's rule)
          if (best[j] == best[j] && !(v <= best[j])) best[j] = v, first[j] = l;
        }
      }
    }

    // 2. each argmax inside the band gets its window's cotangent, added
    //    in a pass of the block: windows that can meet at an element take
    //    passes in the order of their offsets there (offset (ki, kj) in
    //    pass (ki / sh) * ceil(kw / sw) + kj / sw), and no two windows of
    //    one pass meet, so each element adds in ascending offset, from 0.f
    //    with __fadd_rn (the reference's order), with no atomics
    int pass[kWindows], pos[kWindows];
    float gv[kWindows];
#pragma unroll
    for (int j = 0; j < kWindows; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int rowi = div(i, G.div_ww), b = i - rowi * G.ww;
      const int pl = div(rowi, G.div_wh), a = rowi - pl * G.wh;
      const int ki = div(first[j], G.div_kw), kj = first[j] - ki * G.kw;
      const int h = h0[j] + ki, w = w0[j] + kj;
      const bool mine = h >= T.r0 && h < T.r1 && w >= T.c0 && w < T.c1;
      pass[j] = mine ? div(ki, G.div_sh) * G.pass_cols + div(kj, G.div_sw) : -1;
      pos[j] = mine ? pd + pl * dplane + (h - T.r0) * G.dpitch + (w - T.c0) : 0;
      gv[j] = mine ? gr[pl * gplane + a * G.gpitch + b] : 0.f;
    }
    __syncthreads();   // x is read: its buffer takes dx
    float4* z = reinterpret_cast<float4*>(sx);
    for (int i = threadIdx.x; i < (pd + T.n * dplane + 3) >> 2; i += kThreads)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < G.passes; ++p) {
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kWindows; ++j)
        if (pass[j] == p) sx[pos[j]] = __fadd_rn(sx[pos[j]], gv[j]);
    }
    __syncthreads();

    // 3. dx out: one contiguous span where bands are whole rows, else a
    //    warp a row (the pitch keeps each row on its 16-byte phase)
    if (G.nbw == 1) {
      store_span(out, sx + pd, T.n * rows * G.W, threadIdx.x, kThreads);
    } else {
      for (int r = warp; r < rows; r += kThreads / 32)
        store_span(out + (long long)r * G.W, sx + pd + r * G.dpitch,
                   T.c1 - T.c0, lane, 32);
    }
    // the block's writes and reads of the stage (generic proxy) come
    // before the next copy's writes (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    load_tile(t + (long long)kStages * gridDim.x, G, x, g, sx, sg, bars + s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

long long round4(long long n) { return (n + 3) / 4 * 4; }

// The row pitch of a band's dx in shared memory: W for whole rows, else
// the band's width rounded up to W's 16-byte phase.
int dx_pitch(int W, int bw) { return bw >= W ? W : bw + ((W - bw) % 4 + 4) % 4; }

// A stage's buffers in floats, each with 3 floats of room for a 16-byte
// phase: x (or, once read, the band's dx), and g.
long long x_buffer(int pt, int W, int bh, int bw, int xh, int xpitch) {
  const long long band = (long long)pt * bh * dx_pitch(W, bw);
  const long long xr = (long long)pt * xh * xpitch;
  return round4((xr > band ? xr : band) + 3);
}

long long g_buffer(int pt, int wh, int gpitch) {
  return round4((long long)pt * wh * gpitch + 3);
}

// The shared-memory bytes of a block for a plan (pool_backward.b4_smem
// computes the same): two mbarriers and two stages.
long long smem_bytes(int pt, int W, int bh, int bw, int xh, int xpitch, int wh,
                     int gpitch) {
  return kHeader + kStages * 4 *
                       (x_buffer(pt, W, bh, bw, xh, xpitch) +
                        g_buffer(pt, wh, gpitch));
}

}  // namespace

// Load the kernel into the current context (under CUDA's lazy loading it is
// otherwise loaded at its first launch); launches nothing. Returns the CUDA
// error, or 0.
extern "C" int rram_pool_backward_load_module() {
  cudaFuncAttributes a;
  return (int)cudaFuncGetAttributes(&a, pool_backward_kernel);
}

// dx from x and g over `planes` planes in one launch. The plan's numbers
// come from pool_backward.b4_plan; `smem` is its byte count, checked here
// against this file's own layout. Returns cudaGetLastError(), or
// cudaErrorInvalidValue on a window of more than 256 offsets or a plan
// that does not fit.
extern "C" int rram_max_pool_backward(const void* x, const void* g, void* dx,
                                      long long planes, int H, int W, int Ho,
                                      int Wo, int kh, int kw, int sh, int sw,
                                      int ph, int pw, int pt, int bh, int bw,
                                      int xh, int xpitch, int wh, int ww,
                                      int gpitch, int smem, void* stream) {
  if (kh * kw > 256 || sh < 1 || sw < 1 || pt < 1 || bh < 1 || bw < 1 ||
      wh < 1 || ww < 1 || (long long)pt * wh * ww > kThreads * kWindows)
    return (int)cudaErrorInvalidValue;
  if (planes <= 0 || (long long)H * W <= 0) return (int)cudaGetLastError();
  if (smem_bytes(pt, W, bh, bw, xh, xpitch, wh, gpitch) != smem ||
      smem > 232448)
    return (int)cudaErrorInvalidValue;
  Geometry G;
  G.H = H, G.W = W, G.Ho = Ho, G.Wo = Wo, G.kh = kh, G.kw = kw, G.sh = sh,
  G.sw = sw, G.ph = ph, G.pw = pw;
  G.pt = pt, G.bh = bh, G.bw = bw, G.nbh = (H + bh - 1) / bh,
  G.nbw = (W + bw - 1) / bw, G.xh = xh, G.xpitch = xpitch, G.wh = wh,
  G.ww = ww, G.gpitch = gpitch, G.dpitch = dx_pitch(W, bw);
  if ((pt > 1 && (G.nbh > 1 || G.nbw > 1)) || (G.nbw > 1 && bw % 4))
    return (int)cudaErrorInvalidValue;
  G.pass_cols = (kw + sw - 1) / sw;
  G.passes = (kh + sh - 1) / sh * G.pass_cols;
  G.planes = planes;
  G.tiles = (planes + pt - 1) / pt * G.nbh * G.nbw;
  G.x_floats = (int)x_buffer(pt, W, bh, bw, xh, xpitch);
  G.g_floats = (int)g_buffer(pt, wh, gpitch);
  G.bulk = G.nbh == 1 && G.nbw == 1 && ((long long)H * W) % 4 == 0 &&
           ((long long)Ho * Wo) % 4 == 0 && ((uintptr_t)x & 15) == 0 &&
           ((uintptr_t)g & 15) == 0;
  G.div_sh = make_div(sh), G.div_sw = make_div(sw), G.div_ww = make_div(ww),
  G.div_wh = make_div(wh), G.div_kw = make_div(kw);

  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  // the persistent grid: as many blocks as are resident at once
  cudaFuncSetAttribute(pool_backward_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pool_backward_kernel,
                                                kThreads, smem);
  if (per_sm < 1) per_sm = 1;
  const long long fill = (long long)per_sm * sms;
  const int grid = (int)(G.tiles < fill ? G.tiles : fill);
  pool_backward_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)g, (float*)dx, G);
  return (int)cudaGetLastError();
}
