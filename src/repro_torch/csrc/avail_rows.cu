// The availability trace of DESIGN.md §14: for R flat device ids at
// internal iteration t, each device's effective up-mask (its latency
// deadline folded in) and its latency draw, under one of three schedules.
//
// No Pallas kernel to replace: this is the counterpart of the
// jax.random.bernoulli / uniform draws that src/repro/data/streaming.py:
// make_availability_fn takes under vmap, bit for bit. Every number is
// uniform(key, ()): 23 bits of threefry2x32(key, (0, 0)) under 1.0's
// exponent, minus 1; fold_in(key, d) is threefry2x32(key, (0, d)). With
// K = fold_in(k, id):
//   latency  lat = max(u * 1 + 0.5, 0.5), u of fold_in(fold_in(k_lat, id), t)
//   bernoulli up = u(fold_in(K, t)) < prob
//   markov   up_0 = u(fold_in(K, 0)) < prob; for s = 1 .. t mod horizon:
//            u_s = u(fold_in(K, s)); up = up ? u_s >= p_ud : u_s < p_du
//   straggler tail = u(K) < prob; lat *= tail ? slow : 1; up = 1
//   mask = up && lat <= deadline
// The comparison constants arrive as float32, as JAX compares a float32
// draw with a Python float; the latency's multiply and add are spelled
// __f*_rn so that nothing contracts.
//
// What bounds it: at the CLI's 350 ids neither bytes (20 per id) nor
// operations (about 74 integer operations per hash; 6 hashes per id, and
// for markov 2 more per step, 8,196 per id at t mod horizon = 4,095) come
// near a microsecond at the card's rates. The markov chain is serial in
// its state, but each step's uniform does not depend on it: a step is
// one of the four maps of {0, 1} to itself, and maps compose
// associatively.
// Design: one warp per id. Lane l hashes a contiguous chunk of the steps
// and composes their maps in order in registers; a shuffle-down tree
// composes the 32 lanes' maps in lane order (lower lanes' steps first);
// lane 0 draws the initial state and the latency and writes. t is read
// from device memory, so the grid does not depend on it and a CUDA graph
// captures the launch once for every t.
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kWarps = 8;                 // ids per 256-thread block
constexpr int kBernoulli = 0, kMarkov = 1, kStraggler = 2;

struct Params {
  int schedule;
  unsigned k0, k1;        // the schedule's key
  unsigned l0, l1;        // the latency key
  float prob, p_ud, p_du, slow, deadline;
  int horizon;
};

__device__ __forceinline__ void fold_in(unsigned k0, unsigned k1,
                                        unsigned d, unsigned& o0,
                                        unsigned& o1) {
  threefry::threefry2x32(k0, k1, 0u, d, o0, o1);
}

// uniform(key, ()) on [0, 1)
__device__ __forceinline__ float unit(unsigned k0, unsigned k1) {
  return threefry::unit_uniform(threefry::threefry_bits(k0, k1, 0u));
}

__device__ __forceinline__ float unit_at(unsigned k0, unsigned k1,
                                         unsigned d) {
  unsigned a, b;
  fold_in(k0, k1, d, a, b);
  return unit(a, b);
}

__global__ void __launch_bounds__(kWarps * 32)
avail_rows_kernel(const long long* __restrict__ ids,
                  const long long* __restrict__ tp, float* __restrict__ mask,
                  float* __restrict__ lat_out, int R, Params p) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;                   // the whole warp leaves together
  const long long t = *tp;
  const unsigned id = (unsigned)ids[row];
  unsigned K0, K1;                        // K = fold_in(k, id)
  fold_in(p.k0, p.k1, id, K0, K1);
  // the markov chain's steps as a composed map: state x -> x ? f1 : f0
  bool f0 = false, f1 = true;             // the identity
  if (p.schedule == kMarkov) {
    const int tm = (int)(t % (long long)p.horizon);
    const int per = (tm + 31) / 32;
    const int s0 = 1 + lane * per;
    const int s1 = min(tm, s0 + per - 1);
    for (int s = s0; s <= s1; ++s) {
      const float u = unit_at(K0, K1, (unsigned)s);
      const bool stay = u >= p.p_ud, rise = u < p.p_du;
      const bool n0 = f0 ? stay : rise, n1 = f1 ? stay : rise;
      f0 = n0;
      f1 = n1;
    }
    // compose in lane order: lane l (a multiple of 2·off) holds the steps
    // of lanes [l, l + off), lane l + off those of [l + off, l + 2·off)
    for (int off = 1; off < 32; off <<= 1) {
      const bool g0 = __shfl_down_sync(0xffffffffu, (int)f0, off) != 0;
      const bool g1 = __shfl_down_sync(0xffffffffu, (int)f1, off) != 0;
      if ((lane & (2 * off - 1)) == 0) {
        const bool n0 = f0 ? g1 : g0, n1 = f1 ? g1 : g0;
        f0 = n0;
        f1 = n1;
      }
    }
  }
  if (lane != 0) return;
  unsigned a, b;
  fold_in(p.l0, p.l1, id, a, b);
  const float u = unit_at(a, b, (unsigned)t);
  float lat = fmaxf(__fadd_rn(__fmul_rn(u, 1.f), 0.5f), 0.5f);
  bool up = true;
  if (p.schedule == kBernoulli) {
    up = unit_at(K0, K1, (unsigned)t) < p.prob;
  } else if (p.schedule == kMarkov) {
    up = (unit_at(K0, K1, 0u) < p.prob) ? f1 : f0;
  } else if (unit(K0, K1) < p.prob) {     // a straggler of the tail
    lat = __fmul_rn(lat, p.slow);
  }
  mask[row] = (up && lat <= p.deadline) ? 1.f : 0.f;
  lat_out[row] = lat;
}

}  // namespace

extern "C" int avail_rows_f32(const void* ids, const void* t, void* mask,
                              void* lat, int R, int schedule, unsigned k0,
                              unsigned k1, unsigned l0, unsigned l1,
                              float prob, float p_ud, float p_du,
                              int horizon, float slow, float deadline,
                              void* stream) {
  if (R < 0 || horizon < 1 || schedule < kBernoulli || schedule > kStraggler)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const Params p{schedule, k0, k1, l0, l1, prob, p_ud, p_du, slow, deadline,
                 horizon};
  const unsigned grid = (unsigned)((R + kWarps - 1) / kWarps);
  avail_rows_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const long long*)ids, (const long long*)t, (float*)mask, (float*)lat,
      R, p);
  return (int)cudaGetLastError();
}
