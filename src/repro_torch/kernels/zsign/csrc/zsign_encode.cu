// E1 zsign_encode: fused counter-noise stochastic-sign encode + 8:1 bitpack.
//
// Replaces the TPU kernels compress_rng_pallas (K1, src/repro/kernels/zsign/
// zsign.py:123, body _compress_rng_kernel :95) and its client-batched form
// compress_rng_pallas_batched (K2, zsign.py:145). n == 1 is K1.
//
// What it computes, per client c and 8192-element tile t (tile ids restart
// at tile0 for every client: 0 for a whole vector, the global id of a flat
// range's first tile on the model-sharded replica, as the reference's tile
// ids are an operand, zsign.py:129, :168), for element e = q*2048 + l of
// the tile:
//   counter   = t*2048 + l
//   (y0, y1)  = threefry2x32-13(key_c, (counter, 0))
//   u         = (half + 0.5) * 2^-16, half = lo16(y0), hi16(y0), lo16(y1),
//               hi16(y1) for q = 0..3
//   bit       = u > 1 - P_z(x * (1/max(sigma_c, 1e-30)))  if sigma_c > 0
//               x >= 0                                      otherwise
// and bit j of output byte i is element 8i+j. The stream is the reference's
// counter scheme, so the output bytes are the reference's exact bytes.
//
// Bound: bytes. Per element it reads 4 bytes and writes 1/8 byte (n = 8 at
// qwen2-0.5B width: ~16.3 GB, ~4.9 ms at 3.35 TB/s). The integer work is
// ~77 int32 ops per counter (13 threefry rounds of add/rotate/xor plus key
// injections), i.e. ~19 per element, plus ~8 f32 ops per element and an
// erff for z = 1: of the same order as the byte time, so the design keeps
// one threefry call per 4 elements (one counter feeds all four quarters).
//
// Design: one block of 256 threads per (tile, client). Thread j owns the 8
// consecutive counters 8j..8j+7 of its tile: it runs threefry 8 times, keeps
// the 16 words in registers, then for each quarter q reads the 8 floats at
// tile offset q*2048 + 8j (32 contiguous bytes, two float4 loads; a warp
// reads 1 KB contiguous) and writes byte q*256 + j (a warp writes 32
// consecutive bytes). No shared memory, no sync.
//
// Float order: the threshold math uses __fdiv_rn / __fmul_rn / __fadd_rn /
// __fsub_rn so that nvcc cannot contract a multiply-add that the reference
// rounds twice; with no fast-math, erff is the CUDA math library's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 13 rounds (Random123 structure; the trailing partial group
// of one round ends without a key injection), counter (c, 0).
__device__ __forceinline__ void threefry13(uint32_t k0, uint32_t k1,
                                           uint32_t c, uint32_t& y0,
                                           uint32_t& y1) {
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c + k0;
  uint32_t x1 = k1;
#define TF_ROUND(R) x0 += x1; x1 = rotl32(x1, R) ^ x0;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += ks2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += ks2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17)
#undef TF_ROUND
  y0 = x0;
  y1 = x1;
}

// mode: 0 = noise off (x >= 0), 1 = z = inf (uniform), 2 = z = 1 (Gaussian)
template <int MODE>
__global__ void __launch_bounds__(256)
zsign_encode_kernel(const float* __restrict__ x,
                    const long long* __restrict__ keys,
                    const float* __restrict__ sigma,
                    uint8_t* __restrict__ out, long long d_pad,
                    long long tile0) {
  const int j = threadIdx.x;                    // 0..255
  const long long t = blockIdx.x;               // tile within the rows
  const int c = blockIdx.y;                     // client
  const float* xt = x + (long long)c * d_pad + t * 8192;
  uint8_t* ot = out + (long long)c * (d_pad / 8) + t * 1024;

  uint32_t y0[8], y1[8];
  float thr_inv = 0.0f;
  bool noisy = false;
  if (MODE != 0) {
    const float sig = sigma[c];
    noisy = sig > 0.0f;
    thr_inv = __fdiv_rn(1.0f, fmaxf(sig, 1e-30f));
    const uint32_t k0 = (uint32_t)keys[2 * c];
    const uint32_t k1 = (uint32_t)keys[2 * c + 1];
    const uint32_t cbase = (uint32_t)((tile0 + t) * 2048) + 8u * j;
#pragma unroll
    for (int k = 0; k < 8; ++k) threefry13(k0, k1, cbase + k, y0[k], y1[k]);
  }

#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4* src = reinterpret_cast<const float4*>(xt + q * 2048 + 8 * j);
    const float4 a = src[0], b = src[1];
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint32_t byte = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      bool bit = v[k] >= 0.0f;
      if (MODE != 0 && noisy) {
        const uint32_t w = (q < 2) ? y0[k] : y1[k];
        const uint32_t half = (q & 1) ? (w >> 16) : (w & 0xFFFFu);
        const float u = __fmul_rn(__fadd_rn((float)half, 0.5f),
                                  1.52587890625e-05f);   // 2^-16
        const float r = __fmul_rn(v[k], thr_inv);
        float p;
        if (MODE == 1) {
          p = __fmul_rn(0.5f, __fadd_rn(r, 1.0f));
          p = fminf(fmaxf(p, 0.0f), 1.0f);
        } else {
          p = __fmul_rn(0.5f,
                        __fadd_rn(1.0f, erff(__fmul_rn(r, 0.70710678118654752f))));
        }
        bit = u > __fsub_rn(1.0f, p);
      }
      byte |= (uint32_t)bit << k;
    }
    ot[q * 256 + j] = (uint8_t)byte;
  }
}

}  // namespace

// x: (n, d_pad) f32 contiguous, d_pad % 8192 == 0; keys: (n, 2) int64 holding
// the uint32 key words; sigma: (n,) f32; out: (n, d_pad/8) uint8; tile0: the
// global tile id of each row's first tile.
extern "C" int zsign_encode_launch(const void* x, const void* keys,
                                   const void* sigma, void* out, int n,
                                   long long d_pad, int mode, long long tile0,
                                   void* stream) {
  const dim3 grid((unsigned)(d_pad / 8192), (unsigned)n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const long long* kk = static_cast<const long long*>(keys);
  const float* sg = static_cast<const float*>(sigma);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (mode == 0) {
    zsign_encode_kernel<0><<<grid, 256, 0, s>>>(xf, kk, sg, o, d_pad,
                                                   tile0);
  } else if (mode == 1) {
    zsign_encode_kernel<1><<<grid, 256, 0, s>>>(xf, kk, sg, o, d_pad,
                                                   tile0);
  } else if (mode == 2) {
    zsign_encode_kernel<2><<<grid, 256, 0, s>>>(xf, kk, sg, o, d_pad,
                                                   tile0);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
