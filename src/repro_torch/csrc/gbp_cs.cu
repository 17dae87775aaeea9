// GBP-CS: the whole bounded permutation loop of Alg. 2, one block per group.
//
// Replaces the two Pallas kernels of src/repro/kernels/gbp_cs/kernel.py —
// `residual` (_residual_kernel: r = A x - y, d^2 = |r|^2) and `select_swap`
// (_select_kernel: g = A^T r, masked argmin over x=0 / argmax over x=1 with
// first-index ties, Eqs. 15-16) — together with the lax.while_loop of
// src/repro/core/gbp_cs.py:gbp_cs_minimize that drives them.
//
// What bounds it: neither bytes nor operations. One instance is A (F x K,
// 62 x 33 floats, about 8 KB) and a step is about 4·F·K flops; the cost is
// the latency of a chain of up to `max_iters` dependent steps per group. On
// the TPU the loop stays on the scalar core around two kernel calls; here a
// loop on the host would cost a device->host sync per step to test
// termination. So one block per group keeps A, x, r and g in shared memory
// and runs the loop to its end (d_next >= d or max_iters) in one launch.
//
// Arithmetic: the counts in A and x are small integers, so A x is exact in
// f32 in any order, and r = A x - y is one subtraction after that sum. A swap
// of two identical count columns therefore gives exactly the same d, and the
// trip count does not depend on summation order. The remaining sums (|r|^2,
// A^T r) run in a fixed order with explicitly rounded mul/add (no FMA
// contraction); they agree with the plain PyTorch step to rounding.
#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// r = A x - y into r[], returns |r|^2 (computed by thread 0, broadcast).
__device__ float residual(const float* A, const float* x, const float* y,
                          float* r, float* scratch, int F, int K) {
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = __fadd_rn(acc, __fmul_rn(A[i * K + k], x[k]));
    r[i] = __fsub_rn(acc, y[i]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ss = 0.f;
    for (int i = 0; i < F; ++i) ss = __fadd_rn(ss, __fmul_rn(r[i], r[i]));
    scratch[0] = ss;
  }
  __syncthreads();
  float ss = scratch[0];
  __syncthreads();
  return ss;
}

__global__ void gbp_cs_kernel(const float* __restrict__ A_g,
                              const float* __restrict__ y_g,
                              const float* __restrict__ x0_g,
                              float* __restrict__ x_out,
                              float* __restrict__ d_out,
                              int* __restrict__ iters_out,
                              float* __restrict__ trace_out,
                              int F, int K, int max_iters) {
  extern __shared__ float smem[];
  float* A = smem;              // F*K, row-major (f, k)
  float* y = A + F * K;         // F
  float* r = y + F;             // F
  float* x = r + F;             // K   current selection
  float* xn = x + K;            // K   candidate after the swap
  float* g = xn + K;            // K   gradient
  float* scratch = g + K;       // 4

  const int grp = blockIdx.x;
  A_g += (size_t)grp * F * K;
  y_g += (size_t)grp * F;
  x0_g += (size_t)grp * K;
  float* trace = trace_out + (size_t)grp * (max_iters + 1);

  for (int e = threadIdx.x; e < F * K; e += blockDim.x) A[e] = A_g[e];
  for (int i = threadIdx.x; i < F; i += blockDim.x) y[i] = y_g[i];
  for (int k = threadIdx.x; k < K; k += blockDim.x) x[k] = x0_g[k];
  __syncthreads();

  float d = sqrtf(fmaxf(residual(A, x, y, r, scratch, F, K), 0.f));
  if (threadIdx.x == 0) trace[0] = d;
  int s = 0;
  bool done = false;
  while (!done && s < max_iters) {
    // gradient g = A^T r / |r| of the current x (Alg. 2 line 5)
    float ss = residual(A, x, y, r, scratch, F, K);
    float dg = sqrtf(fmaxf(ss, 1e-12f));
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      float acc = 0.f;
      for (int i = 0; i < F; ++i) acc = __fadd_rn(acc, __fmul_rn(A[i * K + k], r[i]));
      g[k] = __fdiv_rn(acc, dg);
    }
    __syncthreads();
    // swap pair (Eqs. 15-16), first index wins ties; then permute (Eq. 17)
    if (threadIdx.x == 0) {
      int i01 = 0, i10 = 0;
      float best0 = x[0] > 0.5f ? FLT_MAX : g[0];
      float best1 = x[0] > 0.5f ? g[0] : -FLT_MAX;
      for (int k = 1; k < K; ++k) {
        float v0 = x[k] > 0.5f ? FLT_MAX : g[k];
        float v1 = x[k] > 0.5f ? g[k] : -FLT_MAX;
        if (v0 < best0) { best0 = v0; i01 = k; }
        if (v1 > best1) { best1 = v1; i10 = k; }
      }
      for (int k = 0; k < K; ++k) xn[k] = x[k];
      xn[i01] = 1.f;
      xn[i10] = 0.f;
    }
    __syncthreads();
    float d_next = sqrtf(fmaxf(residual(A, xn, y, r, scratch, F, K), 0.f));
    bool improved = d_next < d;   // stop when d_{s+1} >= d_s (Alg. 2 line 10)
    if (improved) {
      for (int k = threadIdx.x; k < K; k += blockDim.x) x[k] = xn[k];
      d = d_next;
    }
    if (threadIdx.x == 0) trace[s + 1] = d;
    done = !improved;
    ++s;
    __syncthreads();
  }
  for (int k = threadIdx.x; k < K; k += blockDim.x) x_out[(size_t)grp * K + k] = x[k];
  for (int j = s + 1 + threadIdx.x; j <= max_iters; j += blockDim.x) trace[j] = d;
  if (threadIdx.x == 0) {
    d_out[grp] = d;
    iters_out[grp] = s;
  }
}

}  // namespace

extern "C" int gbp_cs_minimize_f32(const void* A, const void* y, const void* x0,
                                   void* x, void* d, void* iters, void* trace,
                                   int G, int F, int K, int max_iters,
                                   void* stream) {
  size_t smem = sizeof(float) * ((size_t)F * K + 2 * F + 3 * K + 4);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gbp_cs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gbp_cs_kernel<<<G, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)A, (const float*)y, (const float*)x0, (float*)x,
      (float*)d, (int*)iters, (float*)trace, F, K, max_iters);
  return (int)cudaGetLastError();
}
