// What the crossbar kernels of crossbar.cu (B2, B2t, B3) share: the
// effective read of one weight cell
// (Philox4x32-10 noise on the flat weight index and the reference's
// `_w_eff` in its straight-through spelling), one tile partial's ADC
// (`_adc_read`) and the two-pass tiled read's second pass
// (rram_caffe_simulation_tpu/fault/hw_aware.py). See crossbar.cu for why
// every step is spelled __f*_rn and rintf.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace rram {

__device__ __forceinline__ uint2 philox4x32_10(uint32_t seed,
                                               unsigned long long ctr) {
  uint32_t c0 = (uint32_t)ctr, c1 = (uint32_t)(ctr >> 32), c2 = 0, c3 = 0;
  uint32_t k0 = seed, k1 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint2(c0, c1);
}

__device__ __forceinline__ float unit_interval(uint32_t bits) {
  const float u = __fmul_rn(__uint2float_rn(bits), 0x1p-32f);
  return __fsub_rn(u, floorf(u));
}

// N(0, 1) by Box-Muller, the reference's `_gauss_tile` formula
__device__ __forceinline__ float gauss(uint32_t seed,
                                       unsigned long long ctr) {
  const uint2 b = philox4x32_10(seed, ctr);
  const float u1 = fmaxf(unit_interval(b.x), 1e-12f);
  const float u2 = unit_interval(b.y);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.2831855f, u2)));
}

__device__ __forceinline__ float w_eff(float w, float broken, float stuck,
                                       float levels, float s, bool noise,
                                       float sigma, float eps) {
  if (levels > 0.f) {
    float r = rintf(__fdiv_rn(w, s));
    r = fminf(fmaxf(r, -levels), levels);
    w = __fadd_rn(w, __fsub_rn(__fmul_rn(r, s), w));
  }
  float noisy = w;
  if (noise) noisy = __fmul_rn(w, __fadd_rn(1.0f, __fmul_rn(sigma, eps)));
  const float sel = broken > 0.f ? stuck : noisy;
  return __fadd_rn(w, __fsub_rn(sel, w));
}

// A tile's ADC step from the max |partial| over its rows and columns:
// max(amax, 1e-12) / levels, clamp_min's way (a NaN max stays NaN)
__device__ __forceinline__ float adc_step(float amax, float levels) {
  return __fdiv_rn(amax < 1e-12f ? 1e-12f : amax, levels);
}

// p through the ADC of step s in `_adc_read`'s straight-through spelling
// p + (clip(rint(p / s), -l, l) * s - p)
__device__ __forceinline__ float adc_quantize(float p, float s,
                                              float levels) {
  float r = rintf(__fdiv_rn(p, s));
  r = fminf(fmaxf(r, -levels), levels);
  return __fadd_rn(p, __fsub_rn(__fmul_rn(r, s), p));
}

// The second pass of a two-pass tiled read, one thread per (c, m, n):
// y = sum over kt ascending of adc(part[c, kt, m, n]) with the step of
// tile (c, kt, n / bn) from amax (the float bits of its max |partial|);
// adc_levels = 0 sums the raw partials. blockIdx.y is the lane, so the
// index arithmetic is 32-bit; the lane's tile steps are formed once a
// block, in shared memory; a thread loads 8 K-tiles' partials before it
// sums them, so 8 reads are in flight; each is read once (streamed past
// the caches).
__global__ void adc_sum_kernel(const float* __restrict__ part,
                               const unsigned int* __restrict__ amax,
                               float adc_levels, int M, int N, int bn, int gk,
                               int gn, float* __restrict__ out) {
  constexpr int U = 8;
  extern __shared__ float steps[];      // (gk, gn) of the lane
  const int c = blockIdx.y, mn = M * N;
  const float* pc = part + (long long)c * gk * mn;
  const unsigned* ac = amax + (long long)c * gk * gn;
  float* oc = out + (long long)c * mn;
  if (adc_levels > 0.f) {
    for (int i = threadIdx.x; i < gk * gn; i += blockDim.x)
      steps[i] = adc_step(__uint_as_float(ac[i]), adc_levels);
    __syncthreads();
  }
  for (int rem = blockIdx.x * blockDim.x + threadIdx.x; rem < mn;
       rem += gridDim.x * blockDim.x) {
    const int t = rem % N / bn;
    float y = 0.f;
    for (int k0 = 0; k0 < gk; k0 += U) {
      float pv[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        pv[u] = k0 + u < gk ? __ldcs(pc + (long long)(k0 + u) * mn + rem)
                            : 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kt = k0 + u;
        if (kt >= gk) break;
        float p = pv[u];
        if (adc_levels > 0.f)
          p = adc_quantize(p, steps[kt * gn + t], adc_levels);
        y = kt == 0 ? p : __fadd_rn(y, p);
      }
    }
    oc[rem] = y;
  }
}

// The same sum for shapes adc_sum_kernel does not take: one thread per
// (c, m, n) over all lanes, 64-bit indices, each tile step formed from
// amax at its read (the same bits)
__global__ void adc_sum_any_kernel(const float* __restrict__ part,
                                   const unsigned int* __restrict__ amax,
                                   float adc_levels, int C, int M, int N,
                                   int bn, int gk, int gn,
                                   float* __restrict__ out) {
  const long long mn = (long long)M * N, total = C * mn;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long c = idx / mn, rem = idx - c * mn;
    const int t = (int)(rem % N) / bn;
    float y = 0.f;
    for (int kt = 0; kt < gk; ++kt) {
      float p = __ldcs(part + (c * gk + kt) * mn + rem);
      if (adc_levels > 0.f)
        p = adc_quantize(
            p, adc_step(__uint_as_float(amax[(c * gk + kt) * gn + t]),
                        adc_levels),
            adc_levels);
      y = kt == 0 ? p : __fadd_rn(y, p);
    }
    out[idx] = y;
  }
}

// The second pass's launch, one thread an output, about 64 blocks an SM
// over all lanes: adc_sum_kernel where C fits a grid's rows, a lane's
// index 32 bits and its gk * gn tile steps 48 KB of shared memory, else
// adc_sum_any_kernel (any shape)
inline cudaError_t launch_adc_sum(const float* part, const unsigned* amax,
                                  float adc_levels, int C, int M, int N,
                                  int bn, int gk, int gn, float* out,
                                  cudaStream_t stream) {
  const long long mn = (long long)M * N, smem = 4LL * gk * gn;
  const long long want = (mn + 255) / 256, most = (132LL * 64 + C - 1) / C;
  const int blocks = (int)(want < most ? want : most);
  if (C <= 65535 && mn + 256LL * blocks < (1LL << 31) &&
      (adc_levels == 0.f || smem <= 48 * 1024)) {
    adc_sum_kernel<<<dim3(blocks, C), 256, adc_levels > 0.f ? smem : 0,
                     stream>>>(part, amax, adc_levels, M, N, bn, gk, gn,
                               out);
  } else {
    const long long all = (C * mn + 255) / 256;
    adc_sum_any_kernel<<<(int)(all < 132LL * 64 ? all : 132LL * 64), 256, 0,
                         stream>>>(part, amax, adc_levels, C, M, N, bn, gk,
                                   gn, out);
  }
  return cudaGetLastError();
}

}  // namespace rram
