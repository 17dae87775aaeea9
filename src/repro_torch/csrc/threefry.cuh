// Threefry-2x32 (20 rounds) on the device, bit-equal to jax.random's
// threefry in its partitionable mode and to the port's core/prng.py:
// element i of a draw under key (k0, k1) hashes the 64-bit counter (0, i)
// and takes the two output words' xor. Shared by int8_quant.cu (the
// stochastic rounding's uniforms) and corrupt_rows.cu (the fault noise's
// normals).
#pragma once

namespace threefry {

__device__ __forceinline__ unsigned rotl(unsigned v, int r) {
  return __funnelshift_l(v, v, r);
}

// threefry2x32 of the counter (0, i) under (k0, k1); returns the 32
// random bits b1 ^ b2 that jax.random.bits draws for element i.
__device__ __forceinline__ unsigned threefry_bits(unsigned k0, unsigned k1,
                                                  unsigned i) {
  const unsigned k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  unsigned a = k0, b = i + k1;
#define TF_MIX(r) \
  a += b;         \
  b = rotl(b, r) ^ a;
  TF_MIX(13) TF_MIX(15) TF_MIX(26) TF_MIX(6)
  a += k1; b += k2 + 1u;
  TF_MIX(17) TF_MIX(29) TF_MIX(16) TF_MIX(24)
  a += k2; b += k0 + 2u;
  TF_MIX(13) TF_MIX(15) TF_MIX(26) TF_MIX(6)
  a += k0; b += k1 + 3u;
  TF_MIX(17) TF_MIX(29) TF_MIX(16) TF_MIX(24)
  a += k1; b += k2 + 4u;
  TF_MIX(13) TF_MIX(15) TF_MIX(26) TF_MIX(6)
  a += k2; b += k0 + 5u;
#undef TF_MIX
  return a ^ b;
}

// jax.random.uniform's float transform on [0, 1): 23 random mantissa bits
// under 1.0's exponent, minus 1.
__device__ __forceinline__ float unit_uniform(unsigned bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.f);
}

}  // namespace threefry
