// Latencies and one throughput of the operations on the dependent chains
// of gbp_cs.cu and dirichlet_rows.cu, and the threefry hash rate that
// bounds corrupt_rows.cu's Gaussian rows, measured on the card (not a port
// of any Pallas kernel; no path runs it, and the kernel library leaves it
// out: chip_smoke.py compiles it into a library of its own).
//
// chip_smoke.py reckons the latency floors from them: the floor of one
// launch is a graph node's cost (the empty kernel below, timed inside a
// CUDA graph) plus the kernel's chain (gbp_cs_chain in csrc/gbp_cs.cu
// counts gbp_cs's; chip_smoke.dirichlet_chain dirichlet_rows') in these
// latencies. One warp, one block; each chain is `n` dependent operations
// timed with clock64(), and the SM clock is read against %globaltimer over
// the same kernel.
//
// out[0..6] (int64): cycles of n shuffle+add rounds, n shared-memory load
// round trips, n FMAs, n IEEE divisions, n square roots, then the cycles
// and nanoseconds of a spin of 1e6 cycles; out[7] keeps the chains live;
// out[8..11]: cycles of n threefry mix rounds (a += b; b = rotl(b, r) ^ a,
// the rotations of threefry.cuh in turn), n normals (jax.random.normal of
// the previous normal's bits), n logf and n expf.
//
// hash_rate: every thread of `blocks` 256-thread blocks hashes 4 counters
// at a time under one key (threefry::threefry_bits, as corrupt_rows.cu's
// Gaussian rows do), n hashes in all; out[thread] keeps them live.
#include <cuda_runtime.h>

#include "../threefry.cuh"

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

  unsigned ma = (unsigned)idx + 0x9E3779B9u, mb = __float_as_uint(r);
  long long m0 = clock64();
  for (int i = 0; i < n; i += 4) {
    ma += mb; mb = threefry::rotl(mb, 13) ^ ma;
    ma += mb; mb = threefry::rotl(mb, 15) ^ ma;
    ma += mb; mb = threefry::rotl(mb, 26) ^ ma;
    ma += mb; mb = threefry::rotl(mb, 6) ^ ma;
  }
  long long m1 = clock64();
  float z = threefry::normal_from_bits(ma ^ mb);
  for (int i = 0; i < n; ++i) z = threefry::normal_from_bits(__float_as_uint(z));
  long long m2 = clock64();
  float g = fabsf(z) + 2.0f;
  for (int i = 0; i < n; ++i) g = logf(g) + 2.0f;
  long long m3 = clock64();
  float e = g * 1e-3f;
  for (int i = 0; i < n; ++i) e = expf(e) * 1e-3f;
  long long m4 = clock64();
  if (lane == 0) {
    out[0] = t1 - t0;
    out[1] = t2 - t1;
    out[2] = t3 - t2;
    out[3] = t4 - t3;
    out[4] = t5 - t4;
    out[5] = c1 - c0;
    out[6] = (long long)(ns1 - ns0);
    out[7] = idx + (v + f + q + r + z + e > 1e30f ? 1 : 0) + (ma ^ mb);
    out[8] = m1 - m0;
    out[9] = m2 - m1;
    out[10] = m3 - m2;
    out[11] = m4 - m3;
  }
}

__global__ void __launch_bounds__(256)
hash_rate_kernel(unsigned* out, int n) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned k0 = 0x243F6A88u ^ t, k1 = 0x85A308D3u;
  unsigned acc = 0u;
  for (int i = 0; i < n; i += 4) {
    const unsigned c = t * (unsigned)n + (unsigned)i;
    acc ^= threefry::threefry_bits(k0, k1, c) ^
           threefry::threefry_bits(k0, k1, c + 1u) ^
           threefry::threefry_bits(k0, k1, c + 2u) ^
           threefry::threefry_bits(k0, k1, c + 3u);
  }
  out[t] = acc;
}

}  // namespace

extern "C" int noop_launch(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// out: 16 int64 on the card.
extern "C" int latency_probe(void* out, int n, void* stream) {
  latency_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((long long*)out, n);
  return (int)cudaGetLastError();
}

// out: blocks * 256 uint32 on the card; n a multiple of 4.
extern "C" int hash_rate(void* out, int blocks, int n, void* stream) {
  if (blocks < 1 || n < 4 || n % 4) return (int)cudaErrorInvalidValue;
  hash_rate_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((unsigned*)out,
                                                             n);
  return (int)cudaGetLastError();
}
