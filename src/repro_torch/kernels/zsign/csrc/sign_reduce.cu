// R1 sign_reduce: weighted sum of +/-1 signs straight from packed bytes.
//
// Replaces the TPU kernel sign_reduce_pallas (K3, src/repro/kernels/zsign/
// zsign.py:226, body _sign_reduce_kernel :207): out[8i+k] =
// sum_c w_c * (bit k of packed[c, i] ? +1 : -1), optionally plus a carried
// sum, in one of two orders:
//   add mode   acc + out, the block sum first and the carry last (as
//              compression.sign_reduce adds a flat carry on the kernel
//              route, the reference's Pallas route; 0/1-mask streams);
//   fold mode  the carry is the starting value and every block partial is
//              added to it in order, ((carry + b0) + b1) + ..., written back
//              over the carry in place (the shard-partition-invariant
//              SignFoldAcc fold of f32-weighted streams).
//
// Summation order is pinned, because it is what makes the result bit-exact
// with the reference (wire.unpack_sum and the Pallas kernel): clients in
// blocks of 8; within a block a left fold in client order starting from
// +0.0; the block partials then added one after another, the first block
// initialising the sum (add mode) or added to the carry (fold mode); acc
// added last in add mode. No tree, no atomics, no split over
// clients: the kernel parallelises over wire bytes only. Clients past n (the
// zero-weight padding of the last block) would each add -0.0 or +0.0 to a
// partial that already holds a value or +0.0, which changes nothing, so the
// kernel does not visit them.
//
// Bound: bytes. It reads n bytes per wire column and writes 8 f32 (32
// bytes); at n = 8 and qwen2-0.5B width that is ~2.47 GB, ~0.74 ms at
// 3.35 TB/s; fold mode also reads the carry (8*nb f32, ~1.98 GB more).
// Arithmetic is 2 ops per client and output, far below that.
//
// Design: one thread per byte column i. Per client the warp reads 32
// consecutive bytes (one sector) of that client's row; the 8 partial sums
// live in registers; the 8 outputs go out as two float4 stores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
sign_reduce_kernel(const uint8_t* __restrict__ packed,
                   const float* __restrict__ w,
                   const float* __restrict__ acc, float* __restrict__ out,
                   int n, long long nb, int fold) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nb) return;
  float4* o = reinterpret_cast<float4*>(out + 8 * i);
  float a[8];
  if (fold) {
    const float4 c0 = o[0], c1 = o[1];
    a[0] = c0.x; a[1] = c0.y; a[2] = c0.z; a[3] = c0.w;
    a[4] = c1.x; a[5] = c1.y; a[6] = c1.z; a[7] = c1.w;
  }
  for (int b0 = 0; b0 < n; b0 += 8) {
    float p[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = 0.0f;
    const int b1 = min(b0 + 8, n);
    for (int c = b0; c < b1; ++c) {
      const uint32_t byte = packed[(long long)c * nb + i];
      const float wc = w[c];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        p[k] = __fadd_rn(p[k], ((byte >> k) & 1u) ? wc : -wc);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      a[k] = (b0 == 0 && !fold) ? p[k] : __fadd_rn(a[k], p[k]);
  }
  if (acc != nullptr) {
    const float4* ac = reinterpret_cast<const float4*>(acc + 8 * i);
    const float4 c0 = ac[0], c1 = ac[1];
    const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = __fadd_rn(cv[k], a[k]);
  }
  o[0] = make_float4(a[0], a[1], a[2], a[3]);
  o[1] = make_float4(a[4], a[5], a[6], a[7]);
}

}  // namespace

// packed: (n, nb) uint8 contiguous; w: (n,) f32; acc: (8*nb,) f32 or null
// (add mode only); out: (8*nb,) f32, holding the carry on entry when fold
// is non-zero. n >= 1.
extern "C" int sign_reduce_launch(const void* packed, const void* w,
                                  const void* acc, void* out, int n,
                                  long long nb, int fold, void* stream) {
  if (n < 1 || nb < 1 || (fold && acc != nullptr))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((nb + 255) / 256);
  sign_reduce_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(w),
      static_cast<const float*>(acc), static_cast<float*>(out), n, nb, fold);
  return (int)cudaGetLastError();
}
