// Stochastic int8 quantization of every row of an (M, P) f32 buffer,
// returned dequantized (DESIGN.md §18.1), with the row's own threefry key.
//
// No Pallas kernel to replace: this is the counterpart of the jnp
// src/repro/core/compress.py:int8_quantize and its jax.random.bernoulli
// draw, bit for bit as XLA compiles it (its division by the constant 127
// becomes a multiply by the float32 reciprocal). Per row m:
//   scale = max(max_i |x_i| * (1/127), 1e-30)    (NaN propagates, as jnp.max)
//   y = x_i / scale,  lo = floor(y)
//   u = uniform bits of threefry2x32(key_m, (0, i))   (jax_threefry_
//       partitionable: each coordinate hashes its own 64-bit counter)
//   out_i = clamp(lo + (u < y - lo), -127, 127) * scale
// The arithmetic is IEEE and spelled out with the _rn intrinsics (no FMA
// contraction, a true division; the library is built without fast math):
// one ulp of y - lo flips a coordinate by a whole quantum. The clamp is
// written with compares so that a NaN passes through, as jnp.clip's does.
//
// The max is taken over the magnitudes' bits, bits(x) & 0x7fffffff, as
// unsigned integers: for non-negative floats their order is the float
// order, and a NaN's bits lie above +inf's, so an atomicMax of the bits
// propagates NaN where fmaxf would drop it.
//
// What bounds it: the threefry's integer work. Each coordinate costs 74
// 32-bit integer operations (the counter's add, 20 rounds of add/rotate/
// xor, 5 key injections of two adds, the output xor, the uniform's shift
// and or) against 8 bytes of traffic (one read, one write); at (M, P) =
// (10, 6,603,712) that is 4.9e9 operations (0.29 ms at the H100's
// 16.7 Tops/s int32: 132 SMs x 64 lanes x 1.98 GHz) against 528 MB
// (0.16 ms).
// Design: two launches after a 4-byte-per-row memset, a max-abs reduction
// (contiguous chunks per block, warp and block max, one atomicMax per
// block) and the quantizer, one float4 of coordinates per thread per step,
// with the 20 rounds unrolled in registers (csrc/threefry.cuh).
#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned mag_bits(float f) {
  return __float_as_uint(f) & 0x7fffffffu;
}

__global__ void __launch_bounds__(kThreads)
int8_absmax(const float4* __restrict__ X, long long q, long long chunk,
            unsigned* __restrict__ rowmax) {
  __shared__ unsigned warp_max[kThreads / 32];
  const int m = blockIdx.y;
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = lo + chunk < q ? lo + chunk : q;
  const float4* xr = X + (long long)m * q;
  unsigned v = 0u;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float4 f = __ldg(xr + i);
    v = max(v, max(max(mag_bits(f.x), mag_bits(f.y)),
                   max(mag_bits(f.z), mag_bits(f.w))));
  }
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0u;
    v = __reduce_max_sync(0xffffffffu, v);
    if (threadIdx.x == 0 && v) atomicMax(&rowmax[m], v);
  }
}

__device__ __forceinline__ float quant1(float x, float scale, unsigned k0,
                                        unsigned k1, unsigned i) {
  const float y = __fdiv_rn(x, scale);
  const float lo = floorf(y);
  const float u = threefry::unit_uniform(threefry::threefry_bits(k0, k1, i));
  float qv = __fadd_rn(lo, u < __fsub_rn(y, lo) ? 1.f : 0.f);
  qv = qv < -127.f ? -127.f : (qv > 127.f ? 127.f : qv);
  return __fmul_rn(qv, scale);
}

__global__ void __launch_bounds__(kThreads)
int8_quant(const float4* __restrict__ X, const unsigned* __restrict__ keys,
           const unsigned* __restrict__ rowmax, float4* __restrict__ Y,
           long long q) {
  const int m = blockIdx.y;
  // 1/127 rounded to float32, as XLA folds the constant divisor
  const float s = __fmul_rn(__uint_as_float(rowmax[m]),
                            __uint_as_float(0x3c010204u));
  const float scale = s != s ? s : fmaxf(s, 1e-30f);   // NaN stays NaN
  const unsigned k0 = keys[2 * m], k1 = keys[2 * m + 1];
  const float4* xr = X + (long long)m * q;
  float4* yr = Y + (long long)m * q;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < q;
       i += (long long)gridDim.x * kThreads) {
    const float4 v = __ldg(xr + i);
    const unsigned c = (unsigned)(4 * i);
    yr[i] = make_float4(quant1(v.x, scale, k0, k1, c),
                        quant1(v.y, scale, k0, k1, c + 1),
                        quant1(v.z, scale, k0, k1, c + 2),
                        quant1(v.w, scale, k0, k1, c + 3));
  }
}

}  // namespace

// X, Y (M, P) row-major f32, P % 4 == 0, 16-byte aligned, P < 2^32;
// keys (M, 2) uint32 threefry keys; rowmax: M 32-bit words of scratch.
extern "C" int int8_quant_f32(const void* X, const void* keys, void* Y,
                              void* rowmax, int M, long long P, void* stream) {
  if (M < 1 || M > 65535 || P < 4 || P % 4 || P >= (1ll << 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long q = P / 4;
  cudaError_t err = cudaMemsetAsync(rowmax, 0, sizeof(unsigned) * M, s);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (q + kThreads - 1) / kThreads;
  const long long per_row = blocks < 256 ? blocks : 256;
  const long long chunk = (q + per_row - 1) / per_row;
  int8_absmax<<<dim3((unsigned)per_row, (unsigned)M), kThreads, 0, s>>>(
      (const float4*)X, q, chunk, (unsigned*)rowmax);
  const unsigned grid_x = (unsigned)(blocks < 2048 ? blocks : 2048);
  int8_quant<<<dim3(grid_x, (unsigned)M), kThreads, 0, s>>>(
      (const float4*)X, (const unsigned*)keys, (const unsigned*)rowmax,
      (float4*)Y, q);
  return (int)cudaGetLastError();
}
