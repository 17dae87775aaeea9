// Weighted aggregation over stacked models: out[p] = sum_k w[k] · X[k, p].
//
// Replaces src/repro/kernels/agg_weighted/kernel.py:agg_weighted_kernel
// (_agg_kernel), the (1 x K)(K x P) product behind Eq. 5 (and Eq. 4 on the
// model-average paths). The weights arrive already normalised.
//
// What bounds it: bytes. Eq. 5 over the paper's CNN reads K = 10 stacked
// models of P = 6.6 M floats (264 MB) and writes one; at 2 flops per 4-byte
// element it is far below the card's balance point. Design: a pure stream —
// each thread owns one float4 of coordinates and walks the K members with
// the weights in shared memory, so every input byte is read exactly once
// with 16-byte coalesced loads and the sum never leaves registers.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void agg_weighted_kernel(const float4* __restrict__ X,
                                    const float* __restrict__ w,
                                    float4* __restrict__ out, int K,
                                    long long P4) {
  extern __shared__ float ws[];
  for (int k = threadIdx.x; k < K; k += blockDim.x) ws[k] = w[k];
  __syncthreads();
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P4) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float4 v = X[(long long)k * P4 + i];
    float wk = ws[k];
    acc.x = fmaf(wk, v.x, acc.x);
    acc.y = fmaf(wk, v.y, acc.y);
    acc.z = fmaf(wk, v.z, acc.z);
    acc.w = fmaf(wk, v.w, acc.w);
  }
  out[i] = acc;
}

}  // namespace

// X (K, P) row-major with P % 4 == 0, w (K,), out (P,).
extern "C" int agg_weighted_f32(const void* X, const void* w, void* out, int K,
                                long long P, void* stream) {
  long long P4 = P / 4;
  long long blocks = (P4 + kThreads - 1) / kThreads;
  agg_weighted_kernel<<<(unsigned)blocks, kThreads, K * sizeof(float),
                        (cudaStream_t)stream>>>(
      (const float4*)X, (const float*)w, (float4*)out, K, P4);
  return (int)cudaGetLastError();
}
