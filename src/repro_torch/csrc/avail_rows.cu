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
// What bounds it. Bytes never do (20 per id). The hashes do at large t:
// 6 an id, and for markov 2 more a step, 8,196 an id at t mod horizon =
// 4,095, 2.87 M at the CLI's 350 ids (8 us at the card's measured 3.6e11
// hashes a second). At small t, the latency of one launch: a graph node
// and the three dependent hashes of the latency draw (or of K, the
// state's key and its bits), which no implementation can shorten. The
// markov chain is serial in its state, but each step's uniform does not
// depend on it: a step is one of the four maps of {0, 1} to itself, and
// maps compose associatively.
// Design: one block an id. Markov: 4 warps of steps and one warp of
// draws (160 threads), so that 350 ids spread over the 132 SMs and the
// steps over all 4 schedulers of each (a launch pays for each warp; `python3
// scripts/rng_kernels_ab.py --split` times 8, 3 and 2 step warps). Lane 0
// of the draws warp, the writer, hashes the latency chain and the state
// chain (K, the state's key, its draw) side by side. A chain of tm < 32
// steps runs on the draws warp alone: lane s hashes step s in the same
// three stages, so the warp takes them in one instruction stream, and the
// step warps leave at once. A longer one: thread k of the step warps takes
// steps [1 + k·per, (k + 1)·per], per = ceil(tm / 128), two at a time side
// by side (their fold_in hashes interleaved, then their draws; one at a
// time when per is 1), and composes their maps in step order. A map of
// {0, 1} is the identity, a flip or a constant, so a warp composes its
// lanes' maps in lane order by three ballots (the last constant, then the
// parity of the flips after it), and the writer composes the 4 warps'
// maps in warp order from shared memory. Bernoulli and straggler_tail: the
// draws warp alone (32 threads an id). t is read from device memory, so
// the grid does not depend on it and a CUDA graph captures the launch once
// for every t.
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kStepWarps = 4;             // markov: warps of steps an id
constexpr int kGroup = 2;                 // steps hashed side by side
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

// (f0, f1) := (g0, g1) after (f0, f1): the state x -> x ? f1 : f0
__device__ __forceinline__ void then(bool& f0, bool& f1, bool g0, bool g1) {
  const bool n0 = f0 ? g1 : g0, n1 = f1 ? g1 : g0;
  f0 = n0;
  f1 = n1;
}

// The composition, first position first, of maps of {0, 1} given by
// position bit masks: c the constant maps, v their values, f the flips
// (the rest the identity). The last constant sets the state; the flips
// after it toggle it.
__device__ __forceinline__ void compose(unsigned c, unsigned v, unsigned f,
                                        bool& g0, bool& g1) {
  if (c) {
    const int last = 31 - __clz(c);
    const unsigned after = last == 31 ? 0u : f >> (last + 1);
    g0 = g1 = ((v >> last) ^ (unsigned)__popc(after)) & 1u;
  } else {
    g0 = __popc(f) & 1;
    g1 = !g0;
  }
}

// the warp's lanes' maps composed in lane order; every lane holds it
__device__ __forceinline__ void compose_warp(bool& f0, bool& f1) {
  const unsigned c = __ballot_sync(0xffffffffu, f0 == f1);
  compose(c, __ballot_sync(0xffffffffu, f0 == f1 && f0),
          __ballot_sync(0xffffffffu, f0 && !f1), f0, f1);
}

__device__ __forceinline__ float step_u(unsigned K0, unsigned K1, int s) {
  unsigned a, b;
  fold_in(K0, K1, (unsigned)s, a, b);
  return threefry::unit_uniform(threefry::threefry_bits(a, b, 0u));
}

// this thread's markov steps composed in step order, then the warp's in
// lane order (every lane holds it)
__device__ __forceinline__ void step_map(unsigned K0, unsigned K1, int tm,
                                         const Params& p, bool& f0,
                                         bool& f1) {
  const int per = (tm + kStepWarps * 32 - 1) / (kStepWarps * 32);
  const int s0 = 1 + (int)threadIdx.x * per;
  const int s1 = min(tm, s0 + per - 1);
  if (per < kGroup) {                     // a short chain: one at a time
    for (int s = s0; s <= s1; ++s) {
      const float u = step_u(K0, K1, s);
      then(f0, f1, u < p.p_du, u >= p.p_ud);
    }
  } else {
    for (int s = s0; s <= s1; s += kGroup) {
      unsigned k0[kGroup], k1[kGroup], x[kGroup], a[kGroup], b[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        k0[i] = K0;
        k1[i] = K1;
        x[i] = (unsigned)(s + i);
      }
      threefry::threefry2x32_n<kGroup>(k0, k1, x, a, b);  // the steps' keys
#pragma unroll
      for (int i = 0; i < kGroup; ++i) x[i] = 0u;
      threefry::threefry2x32_n<kGroup>(a, b, x, k0, k1);  // their bits
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        if (s + i <= s1) {
          const float u = threefry::unit_uniform(k0[i] ^ k1[i]);
          then(f0, f1, u < p.p_du, u >= p.p_ud);
        }
    }
  }
  compose_warp(f0, f1);
}

__global__ void __launch_bounds__((kStepWarps + 1) * 32)
avail_rows_kernel(const long long* __restrict__ ids,
                  const long long* __restrict__ tp, float* __restrict__ mask,
                  float* __restrict__ lat_out, Params p) {
  __shared__ int maps[kStepWarps];        // bit 0: f0, bit 1: f1
  const int row = blockIdx.x, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, draws = blockDim.x / 32 - 1;
  const long long t = *tp;
  const unsigned id = (unsigned)ids[row];
  const int tm = p.schedule != kMarkov ? 0
                 : t < (1ll << 32) ? (int)((unsigned)t % (unsigned)p.horizon)
                                   : (int)(t % (long long)p.horizon);
  bool f0 = false, f1 = true;             // the identity map
  float lat = 0.f;
  bool state = false;
  if (warp < draws) {                     // markov steps
    if (tm < 32) return;                  // the writer's warp takes them
    unsigned K0, K1;                      // K = fold_in(k, id)
    fold_in(p.k0, p.k1, id, K0, K1);
    step_map(K0, K1, tm, p, f0, f1);
    if (lane == 0) maps[warp] = (int)f0 | (int)f1 << 1;
  } else {
    // lane 0 hashes the latency chain and the state chain side by side:
    // fold_in(k_lat, id) and K; fold_in(., t) and the state's key
    // (bernoulli fold_in(K, t), markov fold_in(K, 0): the initial state;
    // straggler_tail K's own bits); then the two draws. Lane s of a markov
    // chain shorter than 32 steps hashes step s (K, fold_in(K, s), its
    // bits) in the same three stages, one instruction stream.
    unsigned k0[2] = {p.l0, p.k0}, k1[2] = {p.l1, p.k1}, x[2] = {id, id};
    unsigned a[2], b[2];
    threefry::threefry2x32_n<2>(k0, k1, x, a, b);
    x[0] = (unsigned)t;
    x[1] = lane ? (unsigned)lane
                : p.schedule == kBernoulli ? (unsigned)t : 0u;
    threefry::threefry2x32_n<2>(a, b, x, k0, k1);
    x[0] = x[1] = 0u;
    threefry::threefry2x32_n<2>(k0, k1, x, a, b);
    lat = fmaxf(__fadd_rn(__fmul_rn(threefry::unit_uniform(a[0] ^ b[0]), 1.f),
                          0.5f), 0.5f);
    const float u = threefry::unit_uniform(
        p.schedule == kStraggler ? k0[1] ^ k1[1] : a[1] ^ b[1]);
    state = u < p.prob;
    if (tm > 0 && tm < 32) {
      if (lane >= 1 && lane <= tm) then(f0, f1, u < p.p_du, u >= p.p_ud);
      compose_warp(f0, f1);
    }
  }
  if (tm >= 32) {                         // markov: the warps' maps in order
    __syncthreads();
    if (warp == draws && lane == 0) {
      unsigned c = 0u, v = 0u, f = 0u;
#pragma unroll
      for (int w = 0; w < kStepWarps; ++w) {
        c |= (unsigned)(maps[w] == 0 || maps[w] == 3) << w;
        v |= (unsigned)(maps[w] == 3) << w;
        f |= (unsigned)(maps[w] == 1) << w;
      }
      compose(c, v, f, f0, f1);
    }
  }
  if (warp != draws || lane != 0) return;
  bool up = true;
  if (p.schedule == kBernoulli)
    up = state;
  else if (p.schedule == kMarkov)
    up = state ? f1 : f0;
  else if (state)
    lat = __fmul_rn(lat, p.slow);
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
  const int threads = schedule == kMarkov ? (kStepWarps + 1) * 32 : 32;
  avail_rows_kernel<<<(unsigned)R, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)ids, (const long long*)t, (float*)mask, (float*)lat,
      p);
  return (int)cudaGetLastError();
}
