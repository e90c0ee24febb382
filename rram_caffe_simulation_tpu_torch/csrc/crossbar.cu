// Crossbar read GEMM: y_c = x_c @ W_eff_c for every config lane c.
//
// Replaces the Pallas kernels of rram_caffe_simulation_tpu/fault/hw_aware.py:
// `_make_crossbar_kernel` (one config, launched by `_pallas_forward`) and
// `_make_batched_kernel` (config grid, `_pallas_forward_batched`), with
// their host-noise twins. Per weight cell, the effective read `_w_eff`:
//   1. optional quantization onto the 2^(q-1)-1 level grid with the lane's
//      whole-matrix max-abs (`scale`, reduced outside the kernel as the
//      reference does): w = w + (clip(rint(w/s), -l, l)*s - w),
//      s = max(scale, 1e-12)/l;
//   2. forward-only conductance noise (sigma != 0): noisy = w*(1 + sigma*eps);
//   3. the stuck clamp in straight-through form: w + (sel - w) with
//      sel = broken > 0 ? stuck : noisy.
// eps comes from `eps` (C,K,N) when given (host-noise mode, for exact
// comparison), else from Philox4x32-10 drawn here: key = (lane seed, 0),
// counter = flat weight index k*N+n, Box-Muller on the first two words.
// Every M-block therefore sees the same weight noise whatever the tiling,
// which is what the TPU kernel's per-(j,k)-tile seeding guarantees.
//
// Bit-exact w_eff: the chain above uses __fdiv_rn/__fmul_rn/__fadd_rn, so
// nvcc cannot contract it into FMAs, and rintf rounds half to even like
// torch.round / jnp.round (roundf would round half away from zero). The
// file must not be built with --use_fast_math. Only the K-sum of the
// product is contracted (fmaf), so y differs from the plain version by
// f32 summation order alone.
//
// Layout: x (C or 1, M, K) row-major, `x_lane_stride` = M*K per lane or 0
// when every lane shares one x; w, broken (0/1 as f32), stuck, eps
// (C, K, N); seeds int32 (C,); scale f32 (C,); out (C, M, N).
//
// What bounds it on an H100: at the slice's shapes (M=100, K=1024, N=64
// and M=100, K=64, N=10) the work is ~13 MFLOP over ~1.2 MB, a few
// microseconds at best, so launch latency dominates; past that the bound
// is bytes (w, broken, stuck are 12 B per cell, read once per M-block).
// The design is the simple one: a 32x32 output tile per 256-thread block,
// the K loop inside the block (the TPU's sequential K grid axis), W_eff
// formed once per (BK x BN) tile in shared memory and reused by all BM
// rows. Tensor cores (wgmma, TMA) and split-K for the thin N are for a
// later change.
#include <cstdint>
#include <cuda_runtime.h>

#include "crossbar_weff.cuh"

namespace {

using rram::gauss;
using rram::w_eff;

constexpr int BM = 32, BN = 32, BK = 32;
constexpr int TX = 16, TY = 16;  // 256 threads, 2x2 outputs each

__global__ void __launch_bounds__(TX * TY)
crossbar_kernel(const float* __restrict__ x, long long x_lane_stride,
                const float* __restrict__ w, const float* __restrict__ broken,
                const float* __restrict__ stuck,
                const float* __restrict__ eps,
                const float* __restrict__ scale,
                const int32_t* __restrict__ seeds, float sigma,
                float levels, int M, int K, int N,
                float* __restrict__ out) {
  __shared__ float xs[BM][BK + 1];
  __shared__ float ws[BK][BN + 1];
  const int c = blockIdx.z;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const float* xc = x + (long long)c * x_lane_stride;
  const long long lane = (long long)c * K * N;
  const float s =
      levels > 0.f ? __fdiv_rn(fmaxf(scale[c], 1e-12f), levels) : 0.f;
  const bool noise = sigma != 0.f;
  const uint32_t seed = (uint32_t)seeds[c];
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += TX * TY) {
      const int r = i / BK, cc = i % BK, m = m0 + r, k = k0 + cc;
      xs[r][cc] = (m < M && k < K) ? xc[(long long)m * K + k] : 0.f;
    }
    for (int i = tid; i < BK * BN; i += TX * TY) {
      const int r = i / BN, cc = i % BN, k = k0 + r, n = n0 + cc;
      float v = 0.f;
      if (k < K && n < N) {
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
      const float a0 = xs[ty][kk], a1 = xs[ty + TY][kk];
      const float b0 = ws[kk][tx], b1 = ws[kk][tx + TX];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
  float* oc = out + (long long)c * M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + ty + i * TY, n = n0 + tx + j * TX;
      if (m < M && n < N) oc[(long long)m * N + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int rram_crossbar_forward(const void* x, long long x_lane_stride,
                                     const void* w, const void* broken,
                                     const void* stuck, const void* eps,
                                     const void* scale, const void* seeds,
                                     float sigma, float levels, int C, int M,
                                     int K, int N, void* out, void* stream) {
  if (C > 0 && M > 0 && N > 0) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, C);
    const dim3 block(TX, TY);
    crossbar_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)x, x_lane_stride, (const float*)w,
        (const float*)broken, (const float*)stuck, (const float*)eps,
        (const float*)scale, (const int32_t*)seeds, sigma, levels, M, K, N,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
