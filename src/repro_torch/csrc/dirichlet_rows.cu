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
// exp call on the card. The softmax sums in the order of prng.softmax_rows:
// element j + element j + 32, then a warp's butterfly.
//
// What bounds it: neither bytes (8 per element and 32 per row, 4 more
// per element with ALPHA_ROWS) nor operations (about 10 threefry hashes
// of ~74 integer operations per element and pass) at the drift's and the
// population's (350, 62): about a microsecond of work at the card's
// rates, the time of an empty CUDA-graph node. A launch is bound by its
// longest dependent chain, the slowest element's, and by the INT32 pipes
// of the SM sub-partitions that hold two of its warps. Each pass's key
// comes from the last (key_{i+1} = split(key_i)[0]) whatever the
// acceptance test says, and a candidate is three hashes deep (x_key, its
// split, the normal's bits) before its normal, v^3 and the test. At
// α = 0.3, 3.1% of elements reject their first candidate and 0.14% their
// second (the plain version's statistics at the drift's and the
// population's (350, 62)): nearly every row has an element that takes two
// passes, and each launch one that takes three. chip_smoke.py prices the
// chain that no implementation can shorten (dirichlet_chain) at latencies
// the card measures (csrc/probe/latency_probe.cu).
// Design: one 64-thread block per row, one element per thread, so no
// thread runs two elements' chains back to back and the 350 rows spread
// over every SM. Within a thread the independent hashes of a step run
// side by side, round by round (threefry2x32_n): the pass's split into
// key, x_key and U_key, then the normal's and U's bits; the boost's
// uniform is drawn beside the first pass, off the chain's end. The outer
// passes run one after the other. The key chain could be walked ahead and
// later passes' candidates drawn beside the first (the same candidates in
// the same order, the same bits), but each extra candidate costs every
// warp its hashes, and the INT32 pipes are already shared by two warps on
// many sub-partitions: groups of 2 and 3 passes measured slower on the
// card (PERF.md §6). The x_key redraw (v <= 0, 0.2% of candidates)
// runs only where needed.
// The softmax: the upper warp hands its 32 log-gamma values to the lower
// one through shared memory, which sums each pair, then the butterfly.
// The grid is R blocks whatever the trace or the concentrations (a CUDA
// graph captures the launch).
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kRowThreads = 64;              // one element each, F <= 64
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

// One outer pass from the key (key0, key1), its hashes side by side: true
// with V of the candidate if it is accepted, else false with the key
// advanced to the next pass's.
__device__ __forceinline__ bool one_pass(unsigned& key0, unsigned& key1,
                                         float c, float d, float& V) {
  const unsigned a0[3] = {key0, key0, key0}, a1[3] = {key1, key1, key1};
  const unsigned ctr[3] = {0u, 1u, 2u};
  unsigned r0[3], r1[3];
  threefry::threefry2x32_n<3>(a0, a1, ctr, r0, r1);   // key, x_key, U_key
  unsigned xk0 = r0[1], xk1 = r1[1], s0, s1;
  threefry::threefry2x32(xk0, xk1, 0u, 1u, s0, s1);    // _, k = split(x_key)
  const unsigned h0[2] = {s0, r0[2]}, h1[2] = {s1, r1[2]}, zeros[2] = {0u, 0u};
  unsigned o0[2], o1[2];                     // the normal's and U's bits
  threefry::threefry2x32_n<2>(h0, h1, zeros, o0, o1);
  float x = threefry::normal_from_bits(o0[0] ^ o1[0]);
  float v = fmaf(x, c, 1.f);
  const float U = threefry::unit_uniform(o0[1] ^ o1[1]);
  while (v <= 0.f) {                         // x_key, k = split(x_key)
    unsigned t0, t1;
    threefry::threefry2x32(xk0, xk1, 0u, 0u, xk0, xk1);
    threefry::threefry2x32(xk0, xk1, 0u, 1u, t0, t1);
    x = threefry::normal_from_bits(threefry::threefry_bits(t0, t1, 0u));
    v = fmaf(x, c, 1.f);
  }
  const float Vc = __fmul_rn(__fmul_rn(v, v), v);
  if (rejects(__fmul_rn(x, x), Vc, U, d)) {
    key0 = r0[0];
    key1 = r1[0];
    return false;
  }
  V = Vc;
  return true;
}

__device__ float loggamma_one(unsigned k0, unsigned k1, float alpha) {
  const bool boost = alpha >= 1.f;
  const float a = boost ? alpha : __fadd_rn(alpha, 1.f);
  const float d = __fsub_rn(a, kThird);
  const float c = __fdiv_rn(kThird, __fsqrt_rn(d));
  const unsigned e0[2] = {k0, k0}, e1[2] = {k1, k1}, ctr[2] = {0u, 1u};
  unsigned r0[2], r1[2];                     // key, sub = split(key)
  threefry::threefry2x32_n<2>(e0, e1, ctr, r0, r1);
  // the boost's uniform beside the first pass, off the passes' chain
  const float log_u = log1pf(-uniform_of(r0[1], r1[1]));
  unsigned key0 = r0[0], key1 = r1[0];
  float V;
  while (!one_pass(key0, key1, c, d, V)) {
  }
  const float boost_term = (boost || log_u == 0.f)
                               ? 0.f
                               : __fmul_rn(log_u, __fdiv_rn(1.f, alpha));
  return __fadd_rn(__fadd_rn(logf(d), logf(V)), boost_term);
}

__global__ void __launch_bounds__(kRowThreads)
dirichlet_rows_kernel(const float* __restrict__ base,
                      const long long* __restrict__ trace,
                      const float* __restrict__ alpha_rows,
                      float* __restrict__ out, int F, float alpha) {
  __shared__ float upper[32];
  const int j = threadIdx.x, r = blockIdx.x;
  const long long* tr = trace + 4ll * r;
  float* orow = out + (long long)r * F;
  if (base != nullptr && tr[1] == 0) {       // rolled by its shift
    if (j < F) {
      const float* br = base + (long long)r * F;
      long long s = tr[0] % F;
      if (s < 0) s += F;
      int src = j - (int)s;
      if (src < 0) src += F;
      orow[j] = br[src];
    }
    return;                                  // the whole block leaves
  }
  float lg = -__int_as_float(0x7f800000);
  if (j < F) {
    unsigned e0, e1;
    threefry::threefry2x32((unsigned)tr[2], (unsigned)tr[3], 0u, (unsigned)j,
                           e0, e1);
    lg = loggamma_one(
        e0, e1, alpha_rows ? alpha_rows[(long long)r * F + j] : alpha);
  }
  if (j >= 32) upper[j - 32] = lg;
  __syncthreads();
  if (j >= 32) return;
  const float hi = upper[j];
  float m = fmaxf(lg, hi);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float e_lo = j < F ? expf(__fsub_rn(lg, m)) : 0.f;
  const float e_hi = j + 32 < F ? expf(__fsub_rn(hi, m)) : 0.f;
  float s = __fadd_rn(e_lo, e_hi);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  if (j < F) orow[j] = __fdiv_rn(e_lo, s);
  if (j + 32 < F) orow[j + 32] = __fdiv_rn(e_hi, s);
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
  dirichlet_rows_kernel<<<R, kRowThreads, 0, (cudaStream_t)stream>>>(
      (const float*)base, (const long long*)trace, (const float*)alpha_rows,
      (float*)out, F, alpha);
  return (int)cudaGetLastError();
}
