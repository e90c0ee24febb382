// Fused ApplyUpdate + Fail epilogue for the packed fault banks.
//
// Replaces the Pallas kernel of rram_caffe_simulation_tpu/fault/fused.py
// (`_make_fused_kernel` / `_epilogue_tile`, launched by `_fused_call` and
// `_fused_call_batched`). Per cell, exactly `data - upd` followed by
// `fault/packed.py fail_packed`:
//   new   = data - upd
//   lq'   = lq - 1 where lq > 0, gated by mode: 0 write (|upd| >= 1e-20f),
//           1 always, 2 never (lq' = lq)
//   data' = lq' <= 0 ? stuck : new, stuck = ((byte >> 2i) & 3) - 1
//
// Layout: data/upd/life_q are (rows, L) row-major with any leading axes
// (the sweep's config axis C included) folded into rows; the stuck bank is
// (rows, ceil(L/4)) uint8, four 2-bit codes per byte, the last byte of a
// row padded. One thread owns one byte, i.e. four cells of one row, and
// never touches the padding columns.
//
// What bounds it on an H100: bytes. Per cell it reads 8 B of f32, 2 or
// 4 B of counter and 1/4 B of bank and writes 4 B + the counter again,
// with a handful of integer/float ops: ~0.5 op per byte, far below the
// card's ~20 f32 op/byte balance point. The design streams every operand
// once (one pass, no scratch, no second kernel for the clamp); at the
// slice's leaf sizes (at most 64x1024 cells) one launch is a few
// microseconds of launch latency, not bandwidth. Vector (16-byte) loads
// are left for a later change.
//
// Bit exactness: the subtract is one IEEE f32 op (__fsub_rn), the write
// gate compares |upd| with the float32 value of 1e-20 as the reference
// does, and the counter arithmetic is integer, so outputs equal the plain
// PyTorch version bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kEpsilon = 1e-20f;  // failure_maker.cu:25

template <typename LQ>
__global__ void fused_update_fail_kernel(const float* __restrict__ data,
                                         const float* __restrict__ upd,
                                         const LQ* __restrict__ lq,
                                         const uint8_t* __restrict__ bank,
                                         float* __restrict__ out_data,
                                         LQ* __restrict__ out_lq,
                                         long long rows, int L, int mode) {
  const int Lb = (L + 3) / 4;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * Lb) return;
  const long long row = idx / Lb;
  const int b = (int)(idx - row * Lb);
  const unsigned byte = bank[idx];
  const long long base = row * L + 4LL * b;
  const int n = min(4, L - 4 * b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= n) break;
    const long long off = base + i;
    const float u = upd[off];
    const float nw = __fsub_rn(data[off], u);
    const LQ q = lq[off];
    LQ q2 = q;
    if (q > 0 && (mode == 1 || (mode == 0 && fabsf(u) >= kEpsilon))) {
      q2 = (LQ)(q - 1);
    }
    const float stuck = (float)((byte >> (2 * i)) & 3u) - 1.0f;
    out_data[off] = (q2 <= 0) ? stuck : nw;
    out_lq[off] = q2;
  }
}

template <typename LQ>
int launch(const float* data, const float* upd, const LQ* lq,
           const uint8_t* bank, float* out_data, LQ* out_lq,
           long long rows, int L, int mode, void* stream) {
  const long long n = rows * ((L + 3) / 4);
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    fused_update_fail_kernel<LQ>
        <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            data, upd, lq, bank, out_data, out_lq, rows, L, mode);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rram_fused_update_fail_i16(const void* data, const void* upd,
                               const void* lq, const void* bank,
                               void* out_data, void* out_lq,
                               long long rows, int L, int mode,
                               void* stream) {
  return launch<int16_t>((const float*)data, (const float*)upd,
                         (const int16_t*)lq, (const uint8_t*)bank,
                         (float*)out_data, (int16_t*)out_lq, rows, L, mode,
                         stream);
}

int rram_fused_update_fail_i32(const void* data, const void* upd,
                               const void* lq, const void* bank,
                               void* out_data, void* out_lq,
                               long long rows, int L, int mode,
                               void* stream) {
  return launch<int32_t>((const float*)data, (const float*)upd,
                         (const int32_t*)lq, (const uint8_t*)bank,
                         (float*)out_data, (int32_t*)out_lq, rows, L, mode,
                         stream);
}

}  // extern "C"
