// Latencies of the operations on gbp_cs's dependent chain, measured on the
// card (not a port of any Pallas kernel; no path runs it, and the kernel
// library leaves it out: chip_smoke.py compiles it into a library of its
// own).
//
// chip_smoke.py reckons the gbp_cs kernel's latency floor from them: the
// floor of one launch is a graph node's cost (the empty kernel below,
// timed inside a CUDA graph) plus the chain of one launch (gbp_cs_chain in
// csrc/gbp_cs.cu counts it) in these latencies. One warp, one block; each
// chain is `n` dependent operations timed with clock64(), and the SM clock
// is read against %globaltimer over the same kernel.
//
// out[0..6] (int64): cycles of n shuffle+add rounds, n shared-memory load
// round trips, n FMAs, n IEEE divisions, n square roots, then the cycles
// and nanoseconds of a spin of 1e6 cycles; out[7] keeps the chains live.
#include <cuda_runtime.h>

namespace {

__global__ void noop_kernel() {}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void latency_kernel(long long* out, int n) {
  __shared__ int chase[64];
  const int lane = threadIdx.x;
  chase[lane] = (lane + 1) & 31;
  chase[lane + 32] = lane;
  __syncwarp();
  float v = 1.0f + lane * 1e-7f, a = 0.999f, b = 1e-4f;

  long long t0 = clock64();
  for (int i = 0; i < n; ++i) v += __shfl_xor_sync(0xffffffffu, v, 1);
  long long t1 = clock64();
  int idx = lane;
  for (int i = 0; i < n; ++i) idx = chase[idx];
  long long t2 = clock64();
  float f = v;
  for (int i = 0; i < n; ++i) f = fmaf(f, a, b);
  long long t3 = clock64();
  float q = f + 2.0f;
  for (int i = 0; i < n; ++i) q = __fdiv_rn(q, a) - b;
  long long t4 = clock64();
  float r = q + 1.0f;
  for (int i = 0; i < n; ++i) r = sqrtf(r) + 1.0f;
  long long t5 = clock64();
  unsigned long long ns0 = global_ns();
  long long c0 = clock64();
  while (clock64() - c0 < 1000000) {
  }
  long long c1 = clock64();
  unsigned long long ns1 = global_ns();
  if (lane == 0) {
    out[0] = t1 - t0;
    out[1] = t2 - t1;
    out[2] = t3 - t2;
    out[3] = t4 - t3;
    out[4] = t5 - t4;
    out[5] = c1 - c0;
    out[6] = (long long)(ns1 - ns0);
    out[7] = idx + (v + f + q + r > 1e30f ? 1 : 0);
  }
}

}  // namespace

extern "C" int noop_launch(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// out: 8 int64 on the card.
extern "C" int latency_probe(void* out, int n, void* stream) {
  latency_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((long long*)out, n);
  return (int)cudaGetLastError();
}
