// GBP-CS: the whole bounded permutation loop of Alg. 2, one warp per group.
//
// Replaces the two Pallas kernels of src/repro/kernels/gbp_cs/kernel.py —
// `residual` (_residual_kernel: r = A x - y, d^2 = |r|^2) and `select_swap`
// (_select_kernel: g = A^T r, masked argmin over x=0 / argmax over x=1 with
// first-index ties, Eqs. 15-16) — together with the lax.while_loop of
// src/repro/core/gbp_cs.py:gbp_cs_minimize that drives them.
//
// What bounds it: neither bytes nor FLOP. One instance is A (F x K, 62 x 33
// floats on the main path, about 8 KB) and a step is about 2·F·K flops; the
// cost is a latency chain of up to `max_iters` dependent steps per group,
// the groups running side by side. So the design shortens the chain of one
// step and keeps it inside one warp:
//
// * One warp per group (block = 32 threads). A sits in shared memory, copied
//   by 16-byte cp.async (all in flight at once, overlapping the loads of x0
//   and y) into a buffer whose 16-byte phase matches the source (a scalar
//   head and tail around the float4 body), so any row width K takes the
//   vector copy. Lanes own rows f = lane + 32 i (the residual) and
//   columns k = lane + 32 j (x and the gradient). The loop runs on shuffles
//   and __syncwarp, with no block barrier.
// * A·x is carried, not recomputed. The counts in A and x are small
//   integers, so A·x is exact in f32 in any order. A swap (i0 -> 1,
//   i1 -> 0) gives A·x_next = A·x + a_{i0} - a_{i1}, an O(F) column update,
//   and r = A·x_next - y is one subtraction: bit-equal to the plain step's
//   r. Each step does one O(F·K) product (A^T r, four accumulators per
//   column over a float4 of r) instead of three.
// * Reductions are shuffle butterflies in a fixed order: |r|^2 (xor
//   butterfly: every lane ends with the same bits) and the masked
//   argmin/argmax over (value, index) pairs under a total order, the lower
//   index winning a tie (Eqs. 15-16) and NaN ranking first, as torch's
//   argmin/argmax do.
//
// The per-step dependent chain is then: the A^T r chain (F/4 + F%4 + 2
// FMA-class ops, one division), 5 shuffle rounds of the argmin/argmax, 1
// shuffle for x at the two indices, the column update (shared loads and
// FP ops), 5 shuffle rounds of |r|^2, a square root, and the residual's
// round trip through shared memory. gbp_cs_chain (at the end of this file)
// is the one count of it; chip_smoke.py prices it into the kernel's
// latency floor with latencies measured by csrc/probe/latency_probe.cu.
//
// F, K <= 128 take the register-resident templates below (NF, NK up to 4
// rows and columns per lane). Larger F or K, up to what fits in shared
// memory (F·K about 56 K floats), take gbp_cs_warp_any: the same
// arithmetic in the same order, with x, y, A·x and r in shared memory and
// strided loops over the lanes, so its outputs are bit-equal.
//
// Output: x (G, K), d (G), iterations (G, int32), trace (G, max_iters + 1).
#include <cfloat>
#include <cmath>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

// (ov, oi) ranks before (v, i) in the argmin order: NaN first, then the
// smaller value, then the lower index. A total order, so the butterfly
// leaves every lane with the same pair.
__device__ __forceinline__ bool before_min(float ov, int oi, float v, int i) {
  const bool on = isnan(ov), n = isnan(v);
  if (on != n) return on;
  if (!on && ov != v) return ov < v;
  return oi < i;
}

__device__ __forceinline__ bool before_max(float ov, int oi, float v, int i) {
  const bool on = isnan(ov), n = isnan(v);
  if (on != n) return on;
  if (!on && ov != v) return ov > v;
  return oi < i;
}

// 16 bytes from device memory into shared memory, not through registers
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// A's F·K floats into shared memory, phase-matched to the source so that
// the body moves as float4 (cp.async, committed, not yet waited for); the
// scalar head and tail by plain loads. Returns A's start in smem.
__device__ __forceinline__ const float* load_A(float* smem, const float* Ag,
                                               int FK, int lane) {
  const int phase = (int)((reinterpret_cast<uintptr_t>(Ag) >> 2) & 3);
  float* A = smem + phase;
  const int head = min((4 - phase) & 3, FK);
  const int n4 = (FK - head) >> 2;
  const float4* src4 = reinterpret_cast<const float4*>(Ag + head);
  float4* dst4 = reinterpret_cast<float4*>(A + head);
  for (int e = lane; e < n4; e += 32) cp_async16(dst4 + e, src4 + e);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int e = lane; e < head; e += 32) A[e] = __ldg(Ag + e);
  for (int e = head + 4 * n4 + lane; e < FK; e += 32) A[e] = __ldg(Ag + e);
  return A;
}

template <bool kMin>
__device__ __forceinline__ void reduce_pair(float& v, int& i) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, m);
    const int oi = __shfl_xor_sync(kFull, i, m);
    if (kMin ? before_min(ov, oi, v, i) : before_max(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// NF = ceil(F/32) rows and NK = ceil(K/32) columns per lane.
template <int NF, int NK>
__global__ void __launch_bounds__(32)
gbp_cs_warp(const float* __restrict__ A_g, const float* __restrict__ y_g,
            const float* __restrict__ x0_g, float* __restrict__ x_out,
            float* __restrict__ d_out, int* __restrict__ iters_out,
            float* __restrict__ trace_out, int F, int K, int max_iters) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int grp = blockIdx.x, lane = threadIdx.x;
  const int FK = F * K;
  const float* A = load_A(smem, A_g + (size_t)grp * FK, FK, lane);
  float* rs = smem + ((4 + FK + 3) & ~3);   // r (F), 16-byte aligned
  float* xs = rs + ((F + 3) & ~3);          // x0 (K)

  float xr[NK], yr[NF], ax[NF], rr[NF];
  int kc[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const int k = lane + 32 * j;
    kc[j] = min(k, K - 1);
    xr[j] = k < K ? x0_g[(size_t)grp * K + k] : 0.f;
    if (k < K) xs[k] = xr[j];
  }
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int f = lane + 32 * i;
    yr[i] = f < F ? y_g[(size_t)grp * F + f] : 0.f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();

  // the one full product: A·x0, exact for integer counts and a 0/1 x0
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int f = lane + 32 * i;
    const float* row = A + min(f, F - 1) * K;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) acc = fmaf(row[k], xs[k], acc);
    ax[i] = f < F ? acc : 0.f;
    rr[i] = ax[i] - yr[i];
    if (f < F) {
      part = fmaf(rr[i], rr[i], part);
      rs[f] = rr[i];
    }
  }
  float ss = warp_sum(part);
  float d = sqrtf(fmaxf(ss, 0.f));
  float* trace = trace_out + (size_t)grp * (max_iters + 1);
  if (lane == 0) trace[0] = d;
  __syncwarp();

  int s = 0;
  while (s < max_iters) {
    // gradient g = A^T r / |r| of the current x (Alg. 2 line 5)
    const float dg = sqrtf(fmaxf(ss, 1e-12f));
    float acc[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
    int f = 0;
#pragma unroll 4
    for (; f + 4 <= F; f += 4) {
      const float4 r4 = *reinterpret_cast<const float4*>(rs + f);
      const float rq[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* row = A + (f + q) * K;
#pragma unroll
        for (int j = 0; j < NK; ++j)
          acc[j][q] = fmaf(row[kc[j]], rq[q], acc[j][q]);
      }
    }
    for (; f < F; ++f) {
      const float rq = rs[f];
#pragma unroll
      for (int j = 0; j < NK; ++j)
        acc[j][0] = fmaf(A[f * K + kc[j]], rq, acc[j][0]);
    }
    // swap pair (Eqs. 15-16): masked argmin over x=0, argmax over x=1
    float vmin = INFINITY, vmax = -INFINITY;
    int imin = INT_MAX, imax = INT_MAX;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int k = lane + 32 * j;
      if (k < K) {
        const float g = __fdiv_rn((acc[j][0] + acc[j][1]) +
                                  (acc[j][2] + acc[j][3]), dg);
        const bool one = xr[j] > 0.5f;
        const float v0 = one ? FLT_MAX : g, v1 = one ? g : -FLT_MAX;
        if (before_min(v0, k, vmin, imin)) { vmin = v0; imin = k; }
        if (before_max(v1, k, vmax, imax)) { vmax = v1; imax = k; }
      }
    }
    reduce_pair<true>(vmin, imin);
    reduce_pair<false>(vmax, imax);
    const int i01 = imin, i10 = imax;
    float xa = xr[0], xb = xr[0];
#pragma unroll
    for (int j = 1; j < NK; ++j) {
      if ((i01 >> 5) == j) xa = xr[j];
      if ((i10 >> 5) == j) xb = xr[j];
    }
    xa = __shfl_sync(kFull, xa, i01 & 31);
    xb = __shfl_sync(kFull, xb, i10 & 31);
    // Eq. 17 as a column update of A·x: x[i01] = 1, then x[i10] = 0
    float da = 1.f - xa, db = -xb;
    if (i01 == i10) { da = -xa; db = 0.f; }
    float axn[NF], rn[NF];
    part = 0.f;
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int fr = lane + 32 * i;
      const float* row = A + min(fr, F - 1) * K;
      axn[i] = fmaf(db, row[i10], fmaf(da, row[i01], ax[i]));
      rn[i] = axn[i] - yr[i];
      if (fr < F) part = fmaf(rn[i], rn[i], part);
    }
    const float ssn = warp_sum(part);
    const float dn = sqrtf(fmaxf(ssn, 0.f));
    ++s;
    if (!(dn < d)) {   // stop when d_{s+1} >= d_s (Alg. 2 line 10)
      if (lane == 0) trace[s] = d;
      break;
    }
    d = dn;
    ss = ssn;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int k = lane + 32 * j;
      if (k == i01) xr[j] = 1.f;
      if (k == i10) xr[j] = 0.f;
    }
    __syncwarp();   // every lane has read rs
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int fr = lane + 32 * i;
      ax[i] = axn[i];
      if (fr < F) rs[fr] = rn[i];
    }
    __syncwarp();
    if (lane == 0) trace[s] = d;
  }
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const int k = lane + 32 * j;
    if (k < K) x_out[(size_t)grp * K + k] = xr[j];
  }
  for (int j = s + 1 + lane; j <= max_iters; j += 32) trace[j] = d;
  if (lane == 0) {
    d_out[grp] = d;
    iters_out[grp] = s;
  }
}

// Any F, K whose A fits in shared memory: gbp_cs_warp's arithmetic in its
// order (rows f = lane + 32 i, columns k = lane + 32 j, four accumulators
// per column), with x, y, A·x and r in shared memory. A·x and r are double
// buffered: a step writes the candidate's into the spare pair and an
// accepted step swaps the pointers.
__global__ void __launch_bounds__(32)
gbp_cs_warp_any(const float* __restrict__ A_g, const float* __restrict__ y_g,
                const float* __restrict__ x0_g, float* __restrict__ x_out,
                float* __restrict__ d_out, int* __restrict__ iters_out,
                float* __restrict__ trace_out, int F, int K, int max_iters) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int grp = blockIdx.x, lane = threadIdx.x;
  const int FK = F * K, F4 = (F + 3) & ~3;
  const float* A = load_A(smem, A_g + (size_t)grp * FK, FK, lane);
  float* rs = smem + ((4 + FK + 3) & ~3);   // r (F), 16-byte aligned
  float* rn = rs + F4;                      // the candidate's r
  float* ax = rn + F4;
  float* axn = ax + F4;
  float* ys = axn + F4;
  float* xs = ys + F4;                      // x (K)
  for (int k = lane; k < K; k += 32) xs[k] = x0_g[(size_t)grp * K + k];
  for (int f = lane; f < F; f += 32) ys[f] = y_g[(size_t)grp * F + f];
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();

  float part = 0.f;
  for (int f = lane; f < F; f += 32) {
    const float* row = A + f * K;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(row[k], xs[k], acc);
    const float r = acc - ys[f];
    ax[f] = acc;
    rs[f] = r;
    part = fmaf(r, r, part);
  }
  float ss = warp_sum(part);
  float d = sqrtf(fmaxf(ss, 0.f));
  float* trace = trace_out + (size_t)grp * (max_iters + 1);
  if (lane == 0) trace[0] = d;
  __syncwarp();

  int s = 0;
  while (s < max_iters) {
    const float dg = sqrtf(fmaxf(ss, 1e-12f));
    float vmin = INFINITY, vmax = -INFINITY;
    int imin = INT_MAX, imax = INT_MAX;
    for (int k = lane; k < K; k += 32) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      int f = 0;
      for (; f + 4 <= F; f += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rs + f);
        acc[0] = fmaf(A[f * K + k], r4.x, acc[0]);
        acc[1] = fmaf(A[(f + 1) * K + k], r4.y, acc[1]);
        acc[2] = fmaf(A[(f + 2) * K + k], r4.z, acc[2]);
        acc[3] = fmaf(A[(f + 3) * K + k], r4.w, acc[3]);
      }
      for (; f < F; ++f) acc[0] = fmaf(A[f * K + k], rs[f], acc[0]);
      const float g = __fdiv_rn((acc[0] + acc[1]) + (acc[2] + acc[3]), dg);
      const bool one = xs[k] > 0.5f;
      const float v0 = one ? FLT_MAX : g, v1 = one ? g : -FLT_MAX;
      if (before_min(v0, k, vmin, imin)) { vmin = v0; imin = k; }
      if (before_max(v1, k, vmax, imax)) { vmax = v1; imax = k; }
    }
    reduce_pair<true>(vmin, imin);
    reduce_pair<false>(vmax, imax);
    const int i01 = imin, i10 = imax;
    const float xa = xs[i01], xb = xs[i10];
    float da = 1.f - xa, db = -xb;
    if (i01 == i10) { da = -xa; db = 0.f; }
    part = 0.f;
    for (int f = lane; f < F; f += 32) {
      const float* row = A + f * K;
      const float a = fmaf(db, row[i10], fmaf(da, row[i01], ax[f]));
      const float r = a - ys[f];
      axn[f] = a;
      rn[f] = r;
      part = fmaf(r, r, part);
    }
    const float ssn = warp_sum(part);
    const float dn = sqrtf(fmaxf(ssn, 0.f));
    ++s;
    if (!(dn < d)) {   // stop when d_{s+1} >= d_s (Alg. 2 line 10)
      if (lane == 0) trace[s] = d;
      break;
    }
    d = dn;
    ss = ssn;
    __syncwarp();   // every lane has read rs and xs, and written rn
    if (lane == 0) {
      xs[i01] = 1.f;
      xs[i10] = 0.f;
    }
    float* t = rs; rs = rn; rn = t;
    t = ax; ax = axn; axn = t;
    __syncwarp();
    if (lane == 0) trace[s] = d;
  }
  for (int k = lane; k < K; k += 32) x_out[(size_t)grp * K + k] = xs[k];
  for (int j = s + 1 + lane; j <= max_iters; j += 32) trace[j] = d;
  if (lane == 0) {
    d_out[grp] = d;
    iters_out[grp] = s;
  }
}

struct Args {
  const float *A, *y, *x0;
  float *x, *d;
  int* iters;
  float* trace;
  int G, F, K, max_iters;
};

template <int NF, int NK>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int F = a.F, K = a.K;
  const size_t floats = (size_t)((4 + F * K + 3) & ~3) + ((F + 3) & ~3) + K;
  const size_t smem = sizeof(float) * floats;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gbp_cs_warp<NF, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  gbp_cs_warp<NF, NK><<<a.G, 32, smem, stream>>>(
      a.A, a.y, a.x0, a.x, a.d, a.iters, a.trace, F, K, a.max_iters);
  return cudaGetLastError();
}

template <int NF>
cudaError_t launch_k(const Args& a, cudaStream_t stream) {
  if (a.K <= 32) return launch<NF, 1>(a, stream);
  if (a.K <= 64) return launch<NF, 2>(a, stream);
  return launch<NF, 4>(a, stream);
}

cudaError_t launch_any(const Args& a, cudaStream_t stream) {
  const int F = a.F, K = a.K;
  const size_t floats =
      (size_t)((4 + F * K + 3) & ~3) + 5 * (size_t)((F + 3) & ~3) + K;
  const size_t smem = sizeof(float) * floats;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gbp_cs_warp_any, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  gbp_cs_warp_any<<<a.G, 32, smem, stream>>>(a.A, a.y, a.x0, a.x, a.d,
                                             a.iters, a.trace, F, K,
                                             a.max_iters);
  return cudaGetLastError();
}

}  // namespace

// A (G, F, K), y (G, F), x0 (G, K) float32, contiguous, F, K >= 1 with A
// in shared memory (an error code when it does not fit); outputs x (G, K),
// d (G) float32, iterations (G) int32, trace (G, max_iters + 1) float32.
extern "C" int gbp_cs_minimize_f32(const void* A, const void* y, const void* x0,
                                   void* x, void* d, void* iters, void* trace,
                                   int G, int F, int K, int max_iters,
                                   void* stream) {
  if (G < 1 || F < 1 || K < 1 || max_iters < 0)
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)A, (const float*)y, (const float*)x0, (float*)x,
               (float*)d,       (int*)iters,     (float*)trace,     G,
               F,               K,               max_iters};
  cudaStream_t s = (cudaStream_t)stream;
  if (F > 128 || K > 128) return (int)launch_any(a, s);
  if (F <= 32) return (int)launch_k<1>(a, s);
  if (F <= 64) return (int)launch_k<2>(a, s);
  return (int)launch_k<4>(a, s);
}

// The dependent chain of gbp_cs_warp (F, K <= 128), in operations of each
// kind: out[0..4] = shuffle rounds, shared-memory loads, FMA-class ops,
// divisions and square roots of one step; out[5..9] the same for the
// set-up before the first step, A's load from device memory left out.
// A step: A^T r's longest accumulator chain (F/4 FMAs, the F % 4 tail,
// two adds combining the four), the column update (2 FMAs, the
// subtraction, then one square-and-add per row a lane holds), 5 + 5
// butterfly rounds and the shuffle of x, the shared loads of A (twice) and
// of r, a division and a square root; K does not lengthen it, columns run
// on lanes. The set-up: A·x0 (K FMAs from shared memory), the square, the
// |r|^2 butterfly and its square root.
extern "C" int gbp_cs_chain(int F, int K, int* out) {
  if (F < 1 || K < 1 || F > 128 || K > 128) return (int)cudaErrorInvalidValue;
  const int step[5] = {5 + 1 + 5, 3, F / 4 + F % 4 + 2 + 3 + (F + 31) / 32,
                       1, 1};
  const int init[5] = {5, 1, K + 1, 0, 1};
  for (int i = 0; i < 5; ++i) {
    out[i] = step[i];
    out[5 + i] = init[i];
  }
  return 0;
}
