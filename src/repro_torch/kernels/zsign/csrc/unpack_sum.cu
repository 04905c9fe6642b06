// U1 unpack_sum: unweighted sum of +/-1 signs over a packed client stack.
//
// Replaces the TPU kernel unpack_sum_pallas (K6, src/repro/kernels/zsign/
// zsign.py:193, body _unpack_sum_kernel :184): out[8i+k] =
// sum_c (bit k of packed[c, i] ? +1 : -1).
//
// Exactness: every partial sum is an integer of magnitude <= n, exact in
// f32 in any order while n < 2^24, so the kernel counts the set bits in
// int32 and writes 2*ones - n once. A balanced column gives +0.0, as the
// reference's f32 sum of +1.0 and -1.0 does.
//
// Bound: bytes. It reads n bytes per wire column and writes 8 f32 (32
// bytes); at n = 8 and qwen2-0.5B width that is ~2.47 GB, ~0.74 ms at
// 3.35 TB/s.
//
// Design: R1's layout without weights. One thread per byte column i; per
// client the warp reads 32 consecutive bytes of that client's row; the 8
// counts live in registers; the 8 outputs go out as two float4 stores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
unpack_sum_kernel(const uint8_t* __restrict__ packed, float* __restrict__ out,
                  int n, long long nb) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nb) return;
  int ones[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int c = 0; c < n; ++c) {
    const uint32_t byte = packed[(long long)c * nb + i];
#pragma unroll
    for (int k = 0; k < 8; ++k) ones[k] += (byte >> k) & 1u;
  }
  float a[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = (float)(2 * ones[k] - n);
  float4* o = reinterpret_cast<float4*>(out + 8 * i);
  o[0] = make_float4(a[0], a[1], a[2], a[3]);
  o[1] = make_float4(a[4], a[5], a[6], a[7]);
}

}  // namespace

// packed: (n, nb) uint8 contiguous; out: (8*nb,) f32, 16-byte aligned.
// 1 <= n < 2^24.
extern "C" int unpack_sum_launch(const void* packed, void* out, int n,
                                 long long nb, void* stream) {
  if (n < 1 || n >= (1 << 24) || nb < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((nb + 255) / 256);
  unpack_sum_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<float*>(out), n, nb);
  return (int)cudaGetLastError();
}
