// Per-device Dirichlet rows, two callers: the drifted class distributions
// of the dynamic environments (DESIGN.md §13) and the resident devices of
// the lazy population (DESIGN.md §17). Per row r of OUT (R, F), F <= 64:
// the row of BASE rolled by its class shift, or, where its trace flags it
// (the redraw and churn schedules) or where there is no BASE (the lazy
// population: every row drawn), a Dirichlet draw under the row's key.
//
// No Pallas kernel to replace: this is the counterpart of the
// jax.random.dirichlet that src/repro/data/streaming.py:make_drift_fn
// draws under vmap, and of the one LazyPopulation.probs_for draws
// (src/repro/data/population.py). TRACE (R, 4) int64 holds per row the
// shift s, the drawn flag and the key words (k0, k1) (data/streaming.py
// DriftFn.trace); with no BASE only the key words are read (the
// population's staged words: factory id, writer id, k0, k1). The
// concentration is the scalar ALPHA for every element (the drift), or,
// where ALPHA_ROWS is given, an (R, F) f32 tensor read per element (the
// population: row r is its factory's row of the concentration table,
// gathered by the caller). A row that is not drawn is
// out[j] = base[(j - s) mod F]. A drawn row is
// the softmax of F log-gamma samples, element j under split(key, F)[j]
// (threefry of the counter (0, j)), each by jax._src.random._gamma_one in
// log space (Marsaglia and Tsang, with the alpha < 1 boost):
//   key, sub = split(key); X, V, U = 0, 1, 2
//   while U >= 1 - 0.0331 X^2 and log U >= X/2 + d (1 - V + log V):
//     key, x_key, U_key = split(key, 3); v = -1
//     while v <= 0: x_key, k = split(x_key); x = normal(k); v = 1 + x c
//     X, V, U = x^2, v^3, uniform(U_key)
//   log d + log V + (alpha < 1 ? log1p(-uniform(sub)) / alpha : 0)
// with d = a - 1/3, c = (1/3) / sqrt(d), a = alpha (+ 1 when alpha < 1).
// The multiply-adds that XLA contracts on the CPU are fmaf here and single
// roundings in the plain version (core/prng.py loggamma_t); every other
// operation is spelled __f*_rn so that nothing else contracts; logf,
// log1pf and expf are the CUDA library's, which PyTorch's log, log1p and
// exp call on the card. The softmax sums in the order of prng.softmax_rows.
//
// What bounds it: neither bytes (8 per element and 32 per row, 4 more
// per element with ALPHA_ROWS) nor operations (about 11 threefry hashes
// of ~74 integer operations per element and acceptance pass) at the
// drift's and the population's (350, 62): a few microseconds of work at
// the card's rates. The chain of one element is serial (each split feeds
// the next), so a row's time is its slowest element's chain of hashes,
// logs and the erfinv.
// Design: one warp per row, lane l holds elements l and l + 32 and runs
// both rejection loops in registers; the row's max and sum are warp
// butterflies. The grid does not depend on the trace or the
// concentrations (a CUDA graph captures the launch).
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kWarps = 8;                    // rows per 256-thread block
constexpr float kThird = 0x1.555556p-2f;     // float32(1 / 3)
constexpr float kSqueeze = 0x1.0f27bcp-5f;   // float32(0.0331)

__device__ __forceinline__ float uniform_of(unsigned k0, unsigned k1) {
  return threefry::unit_uniform(threefry::threefry_bits(k0, k1, 0u));
}

// Does the state (X, V, U) reject (keep the outer loop running)?
__device__ __forceinline__ bool rejects(float X, float V, float U, float d) {
  if (!(U >= fmaf(__fmul_rn(X, X), -kSqueeze, 1.f))) return false;
  const float tail = __fmul_rn(d, __fadd_rn(__fsub_rn(1.f, V), logf(V)));
  return logf(U) >= fmaf(X, 0.5f, tail);
}

__device__ float loggamma_one(unsigned k0, unsigned k1, float alpha) {
  const bool boost = alpha >= 1.f;
  const float a = boost ? alpha : __fadd_rn(alpha, 1.f);
  const float d = __fsub_rn(a, kThird);
  const float c = __fdiv_rn(kThird, __fsqrt_rn(d));
  unsigned key0, key1, sub0, sub1;
  threefry::threefry2x32(k0, k1, 0u, 0u, key0, key1);
  threefry::threefry2x32(k0, k1, 0u, 1u, sub0, sub1);
  float X = 0.f, V = 1.f, U = 2.f;
  while (rejects(X, V, U, d)) {
    unsigned n0, n1, xk0, xk1, uk0, uk1;
    threefry::threefry2x32(key0, key1, 0u, 0u, n0, n1);
    threefry::threefry2x32(key0, key1, 0u, 1u, xk0, xk1);
    threefry::threefry2x32(key0, key1, 0u, 2u, uk0, uk1);
    key0 = n0;
    key1 = n1;
    float x = 0.f, v = -1.f;
    while (v <= 0.f) {
      unsigned m0, m1, s0, s1;
      threefry::threefry2x32(xk0, xk1, 0u, 0u, m0, m1);
      threefry::threefry2x32(xk0, xk1, 0u, 1u, s0, s1);
      xk0 = m0;
      xk1 = m1;
      x = threefry::normal_from_bits(threefry::threefry_bits(s0, s1, 0u));
      v = fmaf(x, c, 1.f);
    }
    X = __fmul_rn(x, x);
    V = __fmul_rn(__fmul_rn(v, v), v);
    U = uniform_of(uk0, uk1);
  }
  const float log_u = log1pf(-uniform_of(sub0, sub1));
  const float boost_term = (boost || log_u == 0.f)
                               ? 0.f
                               : __fmul_rn(log_u, __fdiv_rn(1.f, alpha));
  return __fadd_rn(__fadd_rn(logf(d), logf(V)), boost_term);
}

__global__ void __launch_bounds__(kWarps * 32)
dirichlet_rows_kernel(const float* __restrict__ base,
                      const long long* __restrict__ trace,
                      const float* __restrict__ alpha_rows,
                      float* __restrict__ out, int R, int F, float alpha) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;                        // the whole warp leaves
  const long long* tr = trace + 4ll * r;
  float* orow = out + (long long)r * F;
  if (base != nullptr && tr[1] == 0) {       // rolled by its shift
    const float* br = base + (long long)r * F;
    long long s = tr[0] % F;
    if (s < 0) s += F;
    for (int j = lane; j < F; j += 32) {
      int src = j - (int)s;
      if (src < 0) src += F;
      orow[j] = br[src];
    }
    return;
  }
  const unsigned k0 = (unsigned)tr[2], k1 = (unsigned)tr[3];
  const float* ar = alpha_rows ? alpha_rows + (long long)r * F : nullptr;
  float lg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    lg[h] = -__int_as_float(0x7f800000);
    if (j < F) {
      unsigned e0, e1;
      threefry::threefry2x32(k0, k1, 0u, (unsigned)j, e0, e1);
      lg[h] = loggamma_one(e0, e1, ar ? ar[j] : alpha);
    }
  }
  float m = fmaxf(lg[0], lg[1]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float e[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    e[h] = lane + 32 * h < F ? expf(__fsub_rn(lg[h], m)) : 0.f;
  float s = __fadd_rn(e[0], e[1]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (lane + 32 * h < F) orow[lane + 32 * h] = __fdiv_rn(e[h], s);
}

}  // namespace

// base (R, F) row-major f32 or null (every row drawn), trace (R, 4) int64
// (shift, drawn flag, key words), alpha_rows (R, F) f32 or null (the
// scalar alpha > 0 for every element), out (R, F) f32; 1 <= F <= 64.
extern "C" int dirichlet_rows_f32(const void* base, const void* trace,
                                  const void* alpha_rows, void* out, int R,
                                  int F, float alpha, void* stream) {
  if (R < 0 || F < 1 || F > 64 || (alpha_rows == nullptr && !(alpha > 0.f)))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((R + kWarps - 1) / kWarps);
  dirichlet_rows_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)base, (const long long*)trace, (const float*)alpha_rows,
      (float*)out, R, F, alpha);
  return (int)cudaGetLastError();
}
