// Top-k magnitude selection over every row of an (M, P) f32 buffer
// (DESIGN.md §18.2): keep the k largest |x| of each row, ties to the LOWER
// index, zero the rest.
//
// Replaces src/repro/kernels/topk_compress/kernel.py:topk_select_kernel
// (_make_kernel). Same result: the Pallas kernel ranks each coordinate by
// pairwise compares against the whole vector,
//   rank_i = #{ j : |x_j| > |x_i| or (|x_j| == |x_i| and j < i) },
// and keeps rank < k. That is O(P^2) compares: at the CNN's |θ| = 6.6 M it
// is 4.4e13 per row and cannot run. Here an exact radix select finds each
// row's k-th largest magnitude τ instead, then one ordered pass keeps
// every |x| > τ and the first (k - #{|x| > τ}) coordinates with |x| == τ in
// index order: the same set.
//
// The magnitude's key is bits(x) & 0x7fffffff: for non-negative floats the
// unsigned order of the bits is the float order, +0 and -0 share key 0,
// and a NaN (key above +inf's 0x7f800000) ranks above everything, as in the
// plain version's descending stable sort. The key has 31 bits, selected in
// three radix passes of 11, 10 and 10 bits. Each pass is a histogram
// kernel over all M rows (grid.y = row, shared-memory bins, only the
// coordinates whose higher bits equal the prefix chosen so far count) and
// a one-block-per-row select kernel that walks the bins from the top,
// fixes the next digit of τ and the number of τ-ties still to keep, and
// clears the bins for the next pass. Then a count kernel writes how many
// coordinates equal τ in each block's contiguous chunk, and the keep
// kernel turns those counts into each block's place in index order: a
// block whose ties all fall before the cut keeps them all, one whose ties
// all fall after keeps none, and only the block that straddles the cut
// ranks its ties by a block-wide scan, tile by tile. An atomic counter
// could not do this: its order is not the index order.
//
// What bounds it: bytes. At the §18 path's shape, (M, P) = (10, 6,603,712)
// f32 (264 MB), the least work is one read and one write of the buffer
// (0.158 ms at 3.35 TB/s); the design reads it five times (three
// histograms, the tie count, the keep pass) and writes it once, with
// 16-byte loads. Launches: one memset and eight kernels per call, for all
// rows together.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins0 = 2048;  // pass 0: key bits 30..20
constexpr int kBins = 1024;   // passes 1, 2: bits 19..10, 9..0

__device__ __forceinline__ unsigned key_of(float f) {
  return __float_as_uint(f) & 0x7fffffffu;
}

// Exclusive prefix sum of v over the block's threads in thread order;
// *total gets the block's sum. Every thread of the block must call it.
__device__ __forceinline__ unsigned block_excl_scan(unsigned v,
                                                    unsigned* smem,
                                                    unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned n = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < kWarps ? smem[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += n;
    }
    if (lane < kWarps) smem[lane] = w;
  }
  __syncthreads();
  const unsigned base = warp ? smem[warp - 1] : 0u;
  *total = smem[kWarps - 1];
  __syncthreads();  // smem may be reused by the next call
  return base + inc - v;
}

template <int PASS>
struct Pass {
  static constexpr int kShift = PASS == 0 ? 20 : PASS == 1 ? 10 : 0;
  static constexpr int kNB = PASS == 0 ? kBins0 : kBins;
};

// Row m's coordinates [lo, hi) in float4 units: block b's contiguous chunk.
__device__ __forceinline__ void chunk_of(long long q, long long chunk,
                                         long long* lo, long long* hi) {
  *lo = (long long)blockIdx.x * chunk;
  const long long e = *lo + chunk;
  *hi = e < q ? e : q;
}

template <int PASS>
__global__ void __launch_bounds__(kThreads)
topk_hist(const float4* __restrict__ X, long long q, long long chunk,
          const unsigned* __restrict__ state, unsigned* __restrict__ hist) {
  constexpr int S = Pass<PASS>::kShift, NB = Pass<PASS>::kNB;
  __shared__ unsigned bins[NB];
  for (int i = threadIdx.x; i < NB; i += kThreads) bins[i] = 0u;
  const int m = blockIdx.y;
  // the digits fixed by the earlier passes (bits above S + 10)
  const unsigned want = PASS == 0 ? 0u : state[2 * m] >> (S + 10);
  __syncthreads();
  long long lo, hi;
  chunk_of(q, chunk, &lo, &hi);
  const float4* xr = X + (long long)m * q;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float4 v = __ldg(xr + i);
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned key = key_of(f[c]);
      if (PASS == 0 || (key >> (S + 10)) == want)
        atomicAdd(&bins[(key >> S) & (NB - 1)], 1u);
    }
  }
  __syncthreads();
  unsigned* h = hist + (long long)m * kBins0;
  for (int i = threadIdx.x; i < NB; i += kThreads)
    if (bins[i]) atomicAdd(&h[i], bins[i]);
}

// One block per row: the bin holding the need-th largest key among those
// that match the prefix fixes this pass's digit; state = (prefix, need).
template <int PASS>
__global__ void __launch_bounds__(kThreads)
topk_select(unsigned* __restrict__ hist, unsigned* __restrict__ state,
            unsigned k) {
  constexpr int S = Pass<PASS>::kShift, NB = Pass<PASS>::kNB;
  constexpr int PER = NB / kThreads;
  __shared__ unsigned smem[32];
  const int m = blockIdx.x;
  unsigned* h = hist + (long long)m * kBins0;
  const unsigned need = PASS == 0 ? k : state[2 * m + 1];
  const unsigned prefix = PASS == 0 ? 0u : state[2 * m];
  // thread t owns bins top, top-1, ..., top-PER+1: thread 0 the highest,
  // so the scan in thread order counts from the top
  const int top = NB - 1 - (int)threadIdx.x * PER;
  unsigned c[PER], sum = 0u;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    c[j] = h[top - j];
    sum += c[j];
  }
  unsigned total;
  unsigned above = block_excl_scan(sum, smem, &total);
  if (above < need && need <= above + sum) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (above + c[j] >= need) {
        state[2 * m] = prefix | ((unsigned)(top - j) << S);
        state[2 * m + 1] = need - above;
        break;
      }
      above += c[j];
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) h[top - j] = 0u;  // ready for the next pass
}

// eq[m, b] = #{ coordinates of block b's chunk with key == τ_m }.
__global__ void __launch_bounds__(kThreads)
topk_count_ties(const float4* __restrict__ X, long long q, long long chunk,
                const unsigned* __restrict__ state,
                unsigned* __restrict__ eq) {
  __shared__ unsigned smem[32];
  const int m = blockIdx.y;
  const unsigned tau = state[2 * m];
  long long lo, hi;
  chunk_of(q, chunk, &lo, &hi);
  const float4* xr = X + (long long)m * q;
  unsigned cnt = 0u;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float4 v = __ldg(xr + i);
    cnt += (key_of(v.x) == tau) + (key_of(v.y) == tau) +
           (key_of(v.z) == tau) + (key_of(v.w) == tau);
  }
  unsigned total;
  block_excl_scan(cnt, smem, &total);
  if (threadIdx.x == 0) eq[(long long)m * gridDim.x + blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
topk_keep(const float4* __restrict__ X, float4* __restrict__ Y, long long q,
          long long chunk, const unsigned* __restrict__ state,
          const unsigned* __restrict__ eq) {
  __shared__ unsigned smem[32];
  const int m = blockIdx.y, b = blockIdx.x;
  const unsigned tau = state[2 * m], need = state[2 * m + 1];
  const unsigned* eqm = eq + (long long)m * gridDim.x;
  // ties in the chunks before this one
  unsigned part = 0u;
  for (int j = threadIdx.x; j < b; j += kThreads) part += eqm[j];
  unsigned run;
  block_excl_scan(part, smem, &run);
  const bool all = run + eqm[b] <= need;   // block-uniform
  const bool none = run >= need;
  long long lo, hi;
  chunk_of(q, chunk, &lo, &hi);
  const float4* xr = X + (long long)m * q;
  float4* yr = Y + (long long)m * q;
  // a block-uniform trip count: every thread takes part in every scan
  for (long long t0 = lo; t0 < hi; t0 += kThreads) {
    const long long i = t0 + threadIdx.x;
    const bool in = i < hi;
    const float4 v = in ? __ldg(xr + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    float f[4] = {v.x, v.y, v.z, v.w};
    unsigned key[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) key[c] = key_of(f[c]);
    bool keep_tie[4] = {all, all, all, all};
    if (!all && !none) {
      const unsigned ties = in ? (key[0] == tau) + (key[1] == tau) +
                                     (key[2] == tau) + (key[3] == tau)
                               : 0u;
      unsigned tile;
      unsigned r = run + block_excl_scan(ties, smem, &tile);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (key[c] == tau) {
          keep_tie[c] = r < need;
          ++r;
        }
      }
      run += tile;
    }
    if (in) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (!(key[c] > tau || (key[c] == tau && keep_tie[c]))) f[c] = 0.f;
      yr[i] = make_float4(f[0], f[1], f[2], f[3]);
    }
  }
}

}  // namespace

// X, Y (M, P) row-major f32, P % 4 == 0, 16-byte aligned; 1 <= k <= P;
// scratch: M * (2048 + 2 + blocks) 32-bit words (bins, (τ, need) per row,
// tie counts per block). blocks = chunks per row (grid.x).
extern "C" int topk_compress_f32(const void* X, void* Y, void* scratch, int M,
                                 long long P, long long k, int blocks,
                                 void* stream) {
  if (M < 1 || M > 65535 || P < 4 || P % 4 || k < 1 || k > P ||
      P >= (1ll << 32) || blocks < 1 || blocks > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long q = P / 4;
  const long long chunk = (q + blocks - 1) / blocks;
  unsigned* hist = (unsigned*)scratch;
  unsigned* state = hist + (long long)M * kBins0;
  unsigned* eq = state + 2ll * M;
  const float4* x = (const float4*)X;
  cudaError_t err =
      cudaMemsetAsync(hist, 0, sizeof(unsigned) * M * kBins0, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks, (unsigned)M);
  const unsigned kk = (unsigned)k;
  topk_hist<0><<<grid, kThreads, 0, s>>>(x, q, chunk, state, hist);
  topk_select<0><<<M, kThreads, 0, s>>>(hist, state, kk);
  topk_hist<1><<<grid, kThreads, 0, s>>>(x, q, chunk, state, hist);
  topk_select<1><<<M, kThreads, 0, s>>>(hist, state, kk);
  topk_hist<2><<<grid, kThreads, 0, s>>>(x, q, chunk, state, hist);
  topk_select<2><<<M, kThreads, 0, s>>>(hist, state, kk);
  topk_count_ties<<<grid, kThreads, 0, s>>>(x, q, chunk, state, eq);
  topk_keep<<<grid, kThreads, 0, s>>>(x, (float4*)Y, q, chunk, state, eq);
  return (int)cudaGetLastError();
}
