// C1 zsign_compress: dense-noise sign encode + 8:1 bitpack.
//
// Replaces the TPU kernel compress_pallas (K5, src/repro/kernels/zsign/
// zsign.py:68, body _compress_kernel :59): for each client row c and
// element j, y = x[c,j] + sigma_c * noise[c,j], and bit j%8 of byte j/8 of
// the row's payload is y >= 0 (little-endian, NaN packs as 0). The noise is
// a dense operand drawn outside (finite z > 1 has no counter stream), so the
// row layout is the reference's: tile-padded, padded noise zero.
//
// Float order: y = __fadd_rn(x, __fmul_rn(sigma, noise)). The product and
// the sum are rounded separately, as the reference writes them; a fused
// multiply-add would round once and can flip the sign of y where |y| is
// within an ulp of 0. The file compiles without fast-math.
//
// Bound: bytes. Per element it reads 8 bytes (x, noise) and writes 1/8
// byte; at n = 8 and qwen2-0.5B width that is ~32.1 GB, ~9.6 ms at
// 3.35 TB/s. Two f32 ops per element are far below that.
//
// Design: one block of 256 threads (8 warps) per (8192-element tile,
// client); each warp owns 1024 consecutive elements and walks them 32 at a
// time, lane l holding element base + l, so every load is one coalesced
// 128-byte line per warp. __ballot_sync of y >= 0 gives the 32 bits of the
// step in wire order (bit l = element base + l, i.e. four little-endian
// bytes); lane `it` keeps step it's word, and the warp stores its 32 words
// (128 bytes) at once. No shared memory, no sync.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
zsign_compress_kernel(const float* __restrict__ x,
                      const float* __restrict__ noise,
                      const float* __restrict__ sigma,
                      uint32_t* __restrict__ out, long long d_pad) {
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base =
      (long long)c * d_pad + (long long)blockIdx.x * 8192 + warp * 1024;
  const float sig = sigma[c];
  uint32_t mine = 0;
#pragma unroll 8
  for (int it = 0; it < 32; ++it) {
    const long long i = base + it * 32 + lane;
    const float y = __fadd_rn(x[i], __fmul_rn(sig, noise[i]));
    const uint32_t bits = __ballot_sync(0xffffffffu, y >= 0.0f);
    if (lane == it) mine = bits;
  }
  out[base / 32 + lane] = mine;
}

}  // namespace

// x, noise: (n, d_pad) f32 contiguous, d_pad % 8192 == 0; sigma: (n,) f32;
// out: (n, d_pad/8) uint8, 4-byte aligned.
extern "C" int zsign_compress_launch(const void* x, const void* noise,
                                     const void* sigma, void* out, int n,
                                     long long d_pad, void* stream) {
  if (n < 1 || n > 65535 || d_pad < 8192 || d_pad % 8192)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(d_pad / 8192), (unsigned)n);
  zsign_compress_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(noise),
      static_cast<const float*>(sigma), static_cast<uint32_t*>(out), d_pad);
  return (int)cudaGetLastError();
}
