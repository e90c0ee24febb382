// Max-pool backward: dx of a MAX pooling layer over f32 planes.
//
// Replaces the Pallas kernel of rram_caffe_simulation_tpu/ops/pool_backward.py
// (`_bwd_kernel`, launched by `_pallas_bwd`). Semantics, per window:
//   - the window's cotangent goes to the FIRST element, in row-major window
//     order, that attains the window max (torch.argmax's first occurrence;
//     a NaN counts as the max, the first NaN wins);
//   - positions outside the plane (the pooling layer's low padding and
//     Caffe's CEIL high padding) read as -inf, as the padded forward does;
//   - overlapping windows (stride < kernel) add into a shared element.
//
// Layout: x (P, H, W), g (P, Ho, Wo), dx (P, H, W), all row-major f32, any
// plane count P (the sweep folds batch x configs x channels into P). `ph`,
// `pw` are the low pads; window (oh, ow) covers padded rows oh*sh .. +kh.
//
// Design: two passes in one call, a deterministic gather with no atomics.
//   1. One thread per window finds its first argmax and stores the window
//      offset ki*kw + kj as one byte (scratch `arg`, P*Ho*Wo bytes).
//   2. One thread per input element walks the window offsets (ki, kj) in
//      ascending row-major order; for each window that holds the element
//      at that offset and whose stored argmax is that offset, it adds the
//      window's g. The addition order (ascending offset) is the reference
//      kernel's own, so the plain PyTorch version `max_pool_backward_plain`,
//      which adds in the same order, is matched bit for bit, and the result
//      does not vary from run to run.
//
// What bounds it on an H100: bytes. The function must read x and g once and
// write dx once (9 B per input element at CIFAR's 3/2 pool1, where g is a
// quarter of x). Pass 1's k*k reads per window overlap and hit L1/L2; the
// argmax scratch adds 2 bytes per window (a 1/4 byte per input element at
// 3/2). A first version that recomputed every window's argmax in pass 2,
// once per element it holds (up to 4 windows of 9 loads), ran far above the
// bound (PERF.md). Index math is 32-bit (the call splits the planes into
// launches of fewer than 2^31 elements), its divisions multiply-high by
// magic numbers, and each element visits only the windows that hold it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (the magic
// number is computed once on the host): runtime integer division costs
// some twenty instructions a time, and this kernel is short enough that
// they showed in its time.
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
  FastDiv hw, w, ohw, wo, div_sh, div_sw;
};

__global__ void window_argmax_kernel(const float* __restrict__ x,
                                     uint8_t* __restrict__ arg, int windows,
                                     Geometry G) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= windows) return;
  const int plane = div(idx, G.ohw);
  const int r = idx - plane * G.Ho * G.Wo;
  const int oh = div(r, G.wo), ow = r - oh * G.Wo;
  const float* xp = x + (long long)plane * G.H * G.W;
  const int h0 = oh * G.sh - G.ph, w0 = ow * G.sw - G.pw;
  float best = 0.f;
  int first = 0;
  for (int i = 0; i < G.kh; ++i) {
    const int hh = h0 + i;
    const bool row_in = hh >= 0 && hh < G.H;
    for (int j = 0; j < G.kw; ++j) {
      const int ww = w0 + j;
      const float v = (row_in && ww >= 0 && ww < G.W)
                          ? __ldg(xp + hh * G.W + ww)
                          : -__int_as_float(0x7f800000);  // -inf
      const int lin = i * G.kw + j;
      // strict > keeps the first of equal maxima; a NaN beats any number
      // and the first NaN stays (torch.argmax's rule)
      if (lin == 0 || v > best || (v != v && best == best)) {
        best = v;
        first = lin;
      }
    }
  }
  arg[idx] = (uint8_t)first;
}

// The windows along one axis that hold padded coordinate p: anchors
// o*s <= p < o*s + k, i.e. o in [ceil((p - k + 1) / s), p / s], within
// [0, n).
__device__ __forceinline__ void window_range(int p, int k, int n, FastDiv s,
                                             int* lo, int* hi) {
  const int top = div(p, s);
  *hi = top < n - 1 ? top : n - 1;
  const int a = p - k + 1;
  *lo = a <= 0 ? 0 : div(a + (int)s.d - 1, s);
}

__global__ void gather_dx_kernel(const uint8_t* __restrict__ arg,
                                 const float* __restrict__ g,
                                 float* __restrict__ dx, int elements,
                                 Geometry G) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= elements) return;
  const int plane = div(idx, G.hw);
  const int r = idx - plane * G.H * G.W;
  const int h = div(r, G.w), w = r - h * G.W;
  const int base = plane * G.Ho * G.Wo;
  const int hp = h + G.ph, wp = w + G.pw;  // padded coordinates
  int oh_lo, oh_hi, ow_lo, ow_hi;
  window_range(hp, G.kh, G.Ho, G.div_sh, &oh_lo, &oh_hi);
  window_range(wp, G.kw, G.Wo, G.div_sw, &ow_lo, &ow_hi);
  float acc = 0.f;
  // ascending window offset (ki, kj) = descending window (oh, ow)
  for (int oh = oh_hi; oh >= oh_lo; --oh) {
    const int ki = hp - oh * G.sh;
    for (int ow = ow_hi; ow >= ow_lo; --ow) {
      const int kj = wp - ow * G.sw;
      const int win = base + oh * G.Wo + ow;
      if (__ldg(arg + win) == ki * G.kw + kj) {
        acc = __fadd_rn(acc, __ldg(g + win));
      }
    }
  }
  dx[idx] = acc;
}

}  // namespace

// `arg` is scratch of at least P*Ho*Wo bytes. Returns cudaGetLastError(),
// or cudaErrorInvalidValue when a window has more than 256 offsets.
extern "C" int rram_max_pool_backward(const void* x, const void* g, void* dx,
                                      void* arg, long long planes, int H,
                                      int W, int Ho, int Wo, int kh, int kw,
                                      int sh, int sw, int ph, int pw,
                                      void* stream) {
  if (kh * kw > 256 || sh < 1 || sw < 1) return (int)cudaErrorInvalidValue;
  const long long per_plane = (long long)H * W > (long long)Ho * Wo
                                  ? (long long)H * W
                                  : (long long)Ho * Wo;
  if (planes <= 0 || per_plane <= 0) return (int)cudaGetLastError();
  const Geometry G{H, W, Ho, Wo, kh, kw, sh, sw, ph, pw,
                   make_div(H * W), make_div(W), make_div(Ho * Wo),
                   make_div(Wo), make_div(sh), make_div(sw)};
  const long long chunk = ((1LL << 31) - 1) / per_plane;  // planes a launch
  cudaStream_t s = (cudaStream_t)stream;
  for (long long p0 = 0; p0 < planes; p0 += chunk) {
    const int n = (int)(planes - p0 < chunk ? planes - p0 : chunk);
    const float* xc = (const float*)x + p0 * H * W;
    const float* gc = (const float*)g + p0 * Ho * Wo;
    float* dxc = (float*)dx + p0 * H * W;
    uint8_t* ac = (uint8_t*)arg + p0 * Ho * Wo;
    const int windows = n * Ho * Wo, elements = n * H * W;
    window_argmax_kernel<<<(windows + kThreads - 1) / kThreads, kThreads, 0,
                           s>>>(xc, ac, windows, G);
    gather_dx_kernel<<<(elements + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        ac, gc, dxc, elements, G);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
