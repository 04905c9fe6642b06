// F1 ef_sign: fused EF-SignSGD step over a stack of clients.
//
// Replaces the TPU kernel ef_update_pallas (K4, src/repro/kernels/efsign/
// efsign.py:39, body _ef_kernel :27), which the reference runs once per
// client under vmap; here the client axis is the second grid dimension, so
// one launch covers the cohort. For client row c and element j < d_pad:
//   p  = g[c,j] + e[c,j]            (e read as 0 for j >= d)
//   q  = p >= 0 ? +scale_c : -scale_c   (= scale_c * (+1|-1), exact)
//   e' = p - q
//   bit j%8 of byte j/8 of the row's payload = p >= 0
// q and e' are stored for j < d only: past d they would be padding, which
// the reference slices off. q is optional (the encode form drops it), and
// e' is stored only for live rows (live == null, or live[c] > 0), so a dead
// client keeps its residual bit-exactly. e' may be written over e in place
// (e_out == e): each element is read and then written by the same thread.
//
// Float order: __fadd_rn / __fsub_rn, no fast-math, so nvcc cannot contract
// p - q with the product scale * (+1|-1) (which is exact anyway).
//
// Bound: bytes. Per element it reads 8 bytes (g, e), writes 4 (e') and 1/8
// (payload), plus 4 with q; at n = 8 and qwen2-0.5B width that is 47.9 GB
// (~14.3 ms at 3.35 TB/s) without q and 63.7 GB (~19.0 ms) with it.
//
// Design: one block of 256 threads (8 warps) per (8192-element tile,
// client); each warp owns 1024 consecutive elements and walks them 32 at a
// time, lane l holding element base + l: every load and store is one
// coalesced 128-byte line per warp, and __ballot_sync(p >= 0) is the step's
// 32 wire bits in order (four little-endian bytes). Lane `it` keeps step
// it's word; the warp stores its 32 words (128 bytes) at once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
ef_sign_kernel(const float* __restrict__ g, long long g_ld, const float* e,
               long long e_ld, float* e_out, long long eo_ld,
               float* __restrict__ q, long long q_ld,
               const float* __restrict__ scale,
               const float* __restrict__ live, uint32_t* __restrict__ packed,
               long long d, long long d_pad) {
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long j0 = (long long)blockIdx.x * 8192 + warp * 1024;
  const float s = scale[c];
  const bool write_e = live == nullptr || live[c] > 0.0f;
  const float* gr = g + (long long)c * g_ld;
  const float* er = e + (long long)c * e_ld;
  float* eor = e_out + (long long)c * eo_ld;
  float* qr = q == nullptr ? nullptr : q + (long long)c * q_ld;
  uint32_t mine = 0;
#pragma unroll 4
  for (int it = 0; it < 32; ++it) {
    const long long j = j0 + it * 32 + lane;
    const bool in = j < d;
    const float p = __fadd_rn(gr[j], in ? er[j] : 0.0f);
    const bool pos = p >= 0.0f;
    const float qv = pos ? s : -s;
    if (in) {
      if (write_e) eor[j] = __fsub_rn(p, qv);
      if (qr != nullptr) qr[j] = qv;
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, pos);
    if (lane == it) mine = bits;
  }
  packed[((long long)c * d_pad + j0) / 32 + lane] = mine;
}

}  // namespace

// g: n rows of g_ld f32 (d_pad read per row, d_pad % 8192 == 0); e, e_out,
// q: n rows of their leading dimension (the first d elements used; q may be
// null, e_out may equal e); scale: (n,) f32; live: (n,) f32 or null;
// packed: (n, d_pad/8) uint8, 4-byte aligned.
extern "C" int ef_sign_launch(const void* g, long long g_ld, const void* e,
                              long long e_ld, void* e_out, long long eo_ld,
                              void* q, long long q_ld, const void* scale,
                              const void* live, void* packed, int n,
                              long long d, long long d_pad, void* stream) {
  if (n < 1 || n > 65535 || d_pad < 8192 || d_pad % 8192 || d < 1 ||
      d > d_pad || g_ld < d_pad)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(d_pad / 8192), (unsigned)n);
  ef_sign_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), g_ld, static_cast<const float*>(e), e_ld,
      static_cast<float*>(e_out), eo_ld, static_cast<float*>(q), q_ld,
      static_cast<const float*>(scale), static_cast<const float*>(live),
      static_cast<uint32_t*>(packed), d, d_pad);
  return (int)cudaGetLastError();
}
