// Implicit-im2col tiled crossbar read of a convolution (B3): y_c[:, jt] =
// sum over kt, ascending, of adc(x_c[:, kt] @ W_eff_c[kt, jt]) for every
// config lane c, where (kt, jt) runs over the layer's crossbar tiles (bk x
// bn cells of the (K, N) im2col view), adc is the tile's own ADC
// (quantize_ste at adc_levels with the partial product's max-abs over ALL M
// rows and the tile's columns), and the operand is gathered from the raw
// activation: element (m, k) is xflat[lane * x_lane_stride + row_base[m] +
// col_off[k]] of the zero-padded, flattened NCHW activation (the patch
// matrix never exists); rows >= M and columns >= K are exact zeros.
//
// Replaces `_make_implicit_kernel` (:743) / `_make_implicit_batched_kernel`
// (:814) with `_gather_block` (:725) of rram_caffe_simulation_tpu/fault/
// hw_aware.py, launched by `_pallas_forward_implicit[_batched]` (:905,
// :975). The dense tiled read (B2t) runs on B2's GEMM core in crossbar.cu.
//
// The TPU kernel pins M to one block so its in-block max-abs is the whole
// partial's. On the card that would leave conv2 with 7 blocks on 132 SMs, so
// the ADC's cross-block max takes two passes instead:
//   pass 1 (grid M-blocks x N-blocks x C*gk): each block forms W_eff of its
//     K-tile chunk by chunk in shared memory (rram::w_eff, the same Philox
//     counter k*N+n as B2, so tiling does not change the noise), multiplies
//     its (BM x BN) block over [kt*bk, min((kt+1)*bk, K)) with fmaf in
//     ascending k, writes the partial to scratch P[c, kt, m, n] and max-
//     reduces |partial| per N-tile column group into amax[c, kt, jt] with
//     atomicMax on the float's bits (values are >= 0, so integer order is
//     float order; a NaN partial gives NaN bits, as jnp.max does; max is
//     order-free, so the pass is deterministic);
//   pass 2 (rram::adc_sum_kernel, one thread per (c, m, n)): y = sum over kt
//     ascending of the partials through `_adc_read`'s straight-through
//     spelling, __f*_rn as in B2 so nothing contracts into an FMA.
//     adc_levels = 0 sums the raw partials.
// bk and bn are arbitrary (not multiples of the block), so a block can span
// two N-tiles; padding rows/columns never enter a max.
//
// What bounds it on an H100: conv2's read (M 25,600, K 800, N 32) is 1.31
// GFLOP, ~0.020 ms at 67 TFLOP/s f32, against ~3.4 MB of operands: compute-
// bound. This first version uses CUDA-core fmaf on a 64x32 block tile (4x2
// outputs a thread) and round-trips P (4 B per partial per K-tile) through
// device memory; B2t's GEMM core, its tile epilogue and operand strides
// (crossbar.cu) are its next step.
#include <cstdint>
#include <cuda_runtime.h>

#include "crossbar_weff.cuh"

namespace {

using rram::gauss;
using rram::w_eff;

constexpr int BM = 64, BN = 32, BK = 32;
constexpr int TX = 16, TY = 16;            // 256 threads
constexpr int RM = BM / TY, RN = BN / TX;  // 4 x 2 outputs a thread

__global__ void __launch_bounds__(TX * TY)
partials_kernel(const float* __restrict__ x, long long x_lane_stride,
                const int32_t* __restrict__ row_base,
                const int32_t* __restrict__ col_off,
                const float* __restrict__ w, const float* __restrict__ broken,
                const float* __restrict__ stuck,
                const float* __restrict__ eps,
                const float* __restrict__ scale,
                const int32_t* __restrict__ seeds, float sigma, float levels,
                int M, int K, int N, int bk, int bn, int gk, int gn,
                float* __restrict__ part, unsigned int* __restrict__ amax) {
  __shared__ float xs[BM][BK + 1];
  __shared__ float ws[BK][BN + 1];
  __shared__ long long rb[BM];
  __shared__ int co[BK];
  __shared__ unsigned int colmax[BN];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int c = blockIdx.z / gk, kt = blockIdx.z % gk;
  const int k_lo = kt * bk, k_hi = min(k_lo + bk, K);
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const float* xc = x + (long long)c * x_lane_stride;
  const long long lane = (long long)c * K * N;
  const float s =
      levels > 0.f ? __fdiv_rn(fmaxf(scale[c], 1e-12f), levels) : 0.f;
  const bool noise = sigma != 0.f;
  const uint32_t seed = (uint32_t)seeds[c];
  if (tid < BN) colmax[tid] = 0u;
  for (int i = tid; i < BM; i += TX * TY)
    rb[i] = m0 + i < M ? (long long)row_base[m0 + i] : 0;
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    if (tid < BK) co[tid] = k0 + tid < k_hi ? col_off[k0 + tid] : 0;
    __syncthreads();
    for (int i = tid; i < BM * BK; i += TX * TY) {
      const int r = i / BK, cc = i % BK, m = m0 + r, k = k0 + cc;
      float v = 0.f;
      if (m < M && k < k_hi) v = xc[rb[r] + co[cc]];
      xs[r][cc] = v;
    }
    for (int i = tid; i < BK * BN; i += TX * TY) {
      const int r = i / BN, cc = i % BN, k = k0 + r, n = n0 + cc;
      float v = 0.f;
      if (k < k_hi && n < N) {
        const long long cell = (long long)k * N + n;
        const long long off = lane + cell;
        float e = 0.f;
        if (noise) e = eps != nullptr ? eps[off] : gauss(seed, cell);
        v = w_eff(w[off], broken[off], stuck[off], levels, s, noise, sigma,
                  e);
      }
      ws[r][cc] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = xs[ty + i * TY][kk];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = ws[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* pc = part + ((long long)c * gk + kt) * M * N;
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    const int n = n0 + tx + j * TX;
    unsigned int mx = 0u;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int m = m0 + ty + i * TY;
      if (m < M && n < N) {
        pc[(long long)m * N + n] = acc[i][j];
        mx = max(mx, __float_as_uint(fabsf(acc[i][j])));
      }
    }
    if (n < N) atomicMax(&colmax[tx + j * TX], mx);
  }
  __syncthreads();
  // one global atomic per N-tile the block spans, by the tile's first
  // column in the block
  if (tid < BN) {
    const int n = n0 + tid, t = n / bn;
    if (n < N && (tid == 0 || (n - 1) / bn != t)) {
      unsigned int mx = 0u;
      for (int j = tid; j < BN && n0 + j < N && (n0 + j) / bn == t; ++j)
        mx = max(mx, colmax[j]);
      atomicMax(&amax[((long long)c * gk + kt) * gn + t], mx);
    }
  }
}

}  // namespace

// xflat (C or 1, F) the zero-padded flat activation, x_lane_stride = F or
// 0 (shared x); row_base (M,), col_off (K,) int32 offsets inside a lane;
// w, broken, stuck (and eps) dense f32 (C, K, N); scale (C,) the lanes'
// max |w|; part (C, gk, M, N) and amax (C, gk, gn) scratch.
extern "C" int rram_crossbar_implicit_forward(
    const void* x, long long x_lane_stride, const void* row_base,
    const void* col_off, const void* w, const void* broken, const void* stuck,
    const void* eps, const void* scale, const void* seeds, float sigma,
    float levels, float adc_levels, int C, int M, int K, int N, int bk,
    int bn, void* part, void* amax, void* out, void* stream) {
  if (C <= 0 || M <= 0 || N <= 0 || K <= 0 || bk <= 0 || bn <= 0)
    return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const int gk = (K + bk - 1) / bk, gn = (N + bn - 1) / bn;
  cudaError_t err = cudaMemsetAsync(
      amax, 0, sizeof(unsigned int) * (size_t)C * gk * gn, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, C * gk);
  partials_kernel<<<grid, dim3(TX, TY), 0, st>>>(
      (const float*)x, x_lane_stride, (const int32_t*)row_base,
      (const int32_t*)col_off, (const float*)w, (const float*)broken,
      (const float*)stuck, (const float*)eps, (const float*)scale,
      (const int32_t*)seeds, sigma, levels, M, K, N, bk, bn, gk, gn,
      (float*)part, (unsigned int*)amax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)rram::launch_adc_sum((const float*)part,
                                   (const unsigned int*)amax, adc_levels, C,
                                   M, N, bn, gk, gn, (float*)out, st);
}
