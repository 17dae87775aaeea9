// Threefry-2x32 (20 rounds) on the device, bit-equal to jax.random's
// threefry in its partitionable mode and to the port's core/prng.py:
// element i of a draw under key (k0, k1) hashes the 64-bit counter (0, i)
// and takes the two output words' xor. Shared by int8_quant.cu (the
// stochastic rounding's uniforms), corrupt_rows.cu (the fault noise's
// normals) and dirichlet_rows.cu (the gamma draws' keys and variates).
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

// Both output words of threefry2x32 of the counter (x0, x1) under
// (k0, k1): split(key, n)[i] and fold_in(key, i) are (o0, o1) of the
// counter (0, i).
__device__ __forceinline__ void threefry2x32(unsigned k0, unsigned k1,
                                             unsigned x0, unsigned x1,
                                             unsigned& o0, unsigned& o1) {
  const unsigned k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  unsigned a = x0 + k0, b = x1 + k1;
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
  o0 = a;
  o1 = b;
}

// jax.random.uniform's float transform on [0, 1): 23 random mantissa bits
// under 1.0's exponent, minus 1.
__device__ __forceinline__ float unit_uniform(unsigned bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.f);
}

// Giles' single-precision erfinv as XLA evaluates it (core/prng.py erfinv)
__device__ __forceinline__ float erfinv_giles(float x) {
  const float w = -log1pf(__fmul_rn(-x, x));
  float p;
  if (w < 5.f) {
    const float t = __fsub_rn(w, 2.5f);
    p = 0x1.e2cb1p-26f;
    p = fmaf(p, t, 0x1.70966cp-22f);
    p = fmaf(p, t, -0x1.d8e6aep-19f);
    p = fmaf(p, t, -0x1.26b582p-18f);
    p = fmaf(p, t, 0x1.ca65b6p-13f);
    p = fmaf(p, t, -0x1.48a81p-10f);
    p = fmaf(p, t, -0x1.11c9dep-8f);
    p = fmaf(p, t, 0x1.f91ec6p-3f);
    p = fmaf(p, t, 0x1.805c5ep+0f);
  } else {
    const float t = __fsub_rn(sqrtf(w), 3.f);
    p = -0x1.a3e136p-13f;
    p = fmaf(p, t, 0x1.a76ad6p-14f);
    p = fmaf(p, t, 0x1.61b8e4p-10f);
    p = fmaf(p, t, -0x1.e17bcep-9f);
    p = fmaf(p, t, 0x1.7824f6p-8f);
    p = fmaf(p, t, -0x1.f38baep-8f);
    p = fmaf(p, t, 0x1.354afcp-7f);
    p = fmaf(p, t, 0x1.006db6p+0f);
    p = fmaf(p, t, 0x1.6a9efcp+1f);
  }
  return fabsf(x) == 1.f ? __fmul_rn(x, __int_as_float(0x7f800000))
                         : __fmul_rn(p, x);
}

// jax.random.normal of one coordinate's threefry bits
__device__ __forceinline__ float normal_from_bits(unsigned bits) {
  const float lo = -0x1.fffffep-1f;          // nextafter(-1, 0)
  // (maxval - minval) rounds to 2 in float32
  const float u = fmaxf(__fadd_rn(__fmul_rn(unit_uniform(bits),
                                            2.f), lo), lo);
  return __fmul_rn(0x1.6a09e6p+0f, erfinv_giles(u));   // float32(sqrt 2)
}

}  // namespace threefry
