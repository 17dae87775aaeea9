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
// three radix digits of 11, 10 and 10 bits.
//
// What bounds it: bytes. At the §18 path's shape, (M, P) = (10, 6,603,712)
// f32 (264 MB, five times the 50 MB L2), the least work is one read and
// one write of the buffer (0.158 ms at 3.35 TB/s). Each row is cut into
// `blocks` contiguous chunks, one CTA each (grid.y = row); one call serves
// all rows:
//  1. topk_hist0 reads x once: an 11-bit histogram of key bits 30..20 per
//     chunk, kept per chunk (bhist) and summed per row by atomics.
//  2. topk_select<0>, one CTA per row, walks the row's bins from the top and
//     fixes τ's top digit d0 and the number of τ-ties still to keep. The
//     coordinates whose key starts with d0 are the candidates: every tie
//     is one. Their count in each chunk is bhist[chunk][d0], so a scan over
//     the chunks places each chunk's candidates; a row whose total exceeds
//     the candidate buffer's `cap` takes the second route below.
//  3. topk_compact reads x again and writes each chunk's candidate keys, in
//     index order, at its place in the row's candidate buffer: a block-wide
//     scan per tile of 4 x 256 float4s orders them within the chunk. No
//     atomic order: it is not the index order.
//  4. topk_hist<1>, topk_select<1>, topk_hist<2>, topk_select<2> fix the
//     other two digits, and topk_count_ties counts each chunk's ties, on
//     the candidate buffer: chunk b's candidates are chunk b's slice of it
//     (~0.2% of the row at the §18 path's k = 1%, which stays in L2).
//  5. topk_keep reads x and writes y: a chunk whose ties all fall before
//     the cut keeps them all, one whose ties all fall after keeps none, and
//     only the chunk that straddles the cut ranks its ties by a block-wide
//     scan, tile by tile.
// HBM traffic: three reads and one write of the buffer (1.057 GB at the
// §18 path's shape, 0.315 ms at 3.35 TB/s), against five reads and a write
// for the three histograms over x. The passes over x keep 4 float4 loads
// in flight per thread. Overflow route: a row with more than `cap`
// candidates (say, one magnitude with a few larger values) skips the
// compaction, and step 4's kernels read its chunks of x instead: the same
// function, exact, at five reads and a write. `stats` records each row's
// route.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins0 = 2048;  // digit 0: key bits 30..20
constexpr int kBins = 1024;   // digits 1, 2: bits 19..10, 9..0
constexpr int kMaxBlocks = kThreads;  // topk_select<0> scans one per thread
constexpr int kUnroll = 4;    // float4 loads in flight per thread

// stats[m]: τ's key (its prefix until the last digit), ties still to
// keep, candidates, route (1: the candidate buffer; 0: x, on overflow)
enum { kTau, kNeed, kCand, kRoute, kStats };

__device__ __forceinline__ unsigned key_of(float f) {
  return __float_as_uint(f) & 0x7fffffffu;
}

// Exclusive prefix sum of v over the block's threads in thread order;
// *total gets the block's sum. Every thread of the block must call it.
// T = unsigned long long scans four 16-bit counts at once.
template <typename T>
__device__ __forceinline__ T block_excl_scan(T v, T* smem, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T n = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? smem[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += n;
    }
    if (lane < kWarps) smem[lane] = w;
  }
  __syncthreads();
  const T base = warp ? smem[warp - 1] : T(0);
  *total = smem[kWarps - 1];
  __syncthreads();  // smem may be reused by the next call
  return base + inc - v;
}

template <int PASS>
struct Pass {
  static constexpr int kShift = PASS == 0 ? 20 : PASS == 1 ? 10 : 0;
  static constexpr int kNB = PASS == 0 ? kBins0 : kBins;
};

// Row m's chunk b: its float4s [lo, hi) of x.
__device__ __forceinline__ void chunk_of(long long q, long long chunk,
                                         long long* lo, long long* hi) {
  *lo = (long long)blockIdx.x * chunk;
  const long long e = *lo + chunk;
  *hi = e < q ? e : q;
}

// Hands f(i, v) each float4 v = xr[i] of [lo, hi), strided over the block
// with kUnroll loads in flight per thread.
template <typename F>
__device__ __forceinline__ void for_chunk_x(const float4* __restrict__ xr,
                                            long long lo, long long hi,
                                            F f) {
  for (long long i0 = lo + threadIdx.x; i0 < hi; i0 += kUnroll * kThreads) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * kThreads;
      if (i < hi) v[u] = __ldg(xr + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * kThreads;
      if (i < hi) f(i, v[u]);
    }
  }
}

// Pass 0 over x: the chunk's histogram of digit 0 into bhist, and summed
// into the row's hist.
__global__ void __launch_bounds__(kThreads)
topk_hist0(const float4* __restrict__ X, long long q, long long chunk,
           unsigned* __restrict__ hist, unsigned* __restrict__ bhist) {
  __shared__ unsigned bins[kBins0];
  for (int i = threadIdx.x; i < kBins0; i += kThreads) bins[i] = 0u;
  const int m = blockIdx.y;
  __syncthreads();
  long long lo, hi;
  chunk_of(q, chunk, &lo, &hi);
  for_chunk_x(X + (long long)m * q, lo, hi, [&](long long, float4 v) {
    atomicAdd(&bins[key_of(v.x) >> 20], 1u);
    atomicAdd(&bins[key_of(v.y) >> 20], 1u);
    atomicAdd(&bins[key_of(v.z) >> 20], 1u);
    atomicAdd(&bins[key_of(v.w) >> 20], 1u);
  });
  __syncthreads();
  unsigned* h = hist + (long long)m * kBins0;
  unsigned* bh = bhist + ((long long)m * gridDim.x + blockIdx.x) * kBins0;
  for (int i = threadIdx.x; i < kBins0; i += kThreads) {
    const unsigned n = bins[i];
    bh[i] = n;
    if (n) atomicAdd(&h[i], n);
  }
}

// Passes 1, 2 (and the tie count below) read the chunk's candidate keys on
// the candidate route, its float4s of x on the overflow route, and hand
// each key to f.
template <typename F>
__device__ __forceinline__ void for_chunk_keys(
    const float4* __restrict__ X, long long q, long long chunk,
    const unsigned* __restrict__ stats, const unsigned* __restrict__ off,
    const unsigned* __restrict__ cand, long long cap, F f) {
  const int m = blockIdx.y;
  if (stats[kStats * m + kRoute]) {
    const unsigned* om = off + (long long)m * (gridDim.x + 1);
    const unsigned* cm = cand + (long long)m * cap;
    for (unsigned i = om[blockIdx.x] + threadIdx.x; i < om[blockIdx.x + 1];
         i += kThreads)
      f(cm[i]);
  } else {
    long long lo, hi;
    chunk_of(q, chunk, &lo, &hi);
    for_chunk_x(X + (long long)m * q, lo, hi, [&](long long, float4 v) {
      f(key_of(v.x));
      f(key_of(v.y));
      f(key_of(v.z));
      f(key_of(v.w));
    });
  }
}

// Passes 1, 2: the histogram of the digit among the keys that match the
// digits fixed so far.
template <int PASS>
__global__ void __launch_bounds__(kThreads)
topk_hist(const float4* __restrict__ X, long long q, long long chunk,
          const unsigned* __restrict__ stats,
          const unsigned* __restrict__ off,
          const unsigned* __restrict__ cand, long long cap,
          unsigned* __restrict__ hist) {
  constexpr int S = Pass<PASS>::kShift, NB = Pass<PASS>::kNB;
  __shared__ unsigned bins[NB];
  for (int i = threadIdx.x; i < NB; i += kThreads) bins[i] = 0u;
  const int m = blockIdx.y;
  const unsigned want = stats[kStats * m + kTau] >> (S + 10);
  __syncthreads();
  for_chunk_keys(X, q, chunk, stats, off, cand, cap, [&](unsigned key) {
    if ((key >> (S + 10)) == want) atomicAdd(&bins[(key >> S) & (NB - 1)], 1u);
  });
  __syncthreads();
  unsigned* h = hist + (long long)m * kBins0;
  for (int i = threadIdx.x; i < NB; i += kThreads)
    if (bins[i]) atomicAdd(&h[i], bins[i]);
}

// One block per row: the bin holding the need-th largest key among those
// that match the prefix fixes this pass's digit. Pass 0 also places each
// chunk's candidates (off[m][b], b <= blocks) and picks the row's route.
template <int PASS>
__global__ void __launch_bounds__(kThreads)
topk_select(unsigned* __restrict__ hist, unsigned* __restrict__ stats,
            unsigned k, const unsigned* __restrict__ bhist,
            unsigned* __restrict__ off, int blocks, long long cap) {
  constexpr int S = Pass<PASS>::kShift, NB = Pass<PASS>::kNB;
  constexpr int PER = NB / kThreads;
  __shared__ unsigned smem[32];
  __shared__ unsigned s_digit;
  const int m = blockIdx.x;
  unsigned* h = hist + (long long)m * kBins0;
  unsigned* st = stats + kStats * m;
  const unsigned need = PASS == 0 ? k : st[kNeed];
  const unsigned prefix = PASS == 0 ? 0u : st[kTau];
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
        st[kTau] = prefix | ((unsigned)(top - j) << S);
        st[kNeed] = need - above;
        s_digit = (unsigned)(top - j);
        break;
      }
      above += c[j];
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) h[top - j] = 0u;  // ready for the next pass
  if (PASS == 0) {
    __syncthreads();
    const int b = threadIdx.x;
    const unsigned n =
        b < blocks ? bhist[((long long)m * blocks + b) * kBins0 + s_digit]
                   : 0u;
    unsigned all;
    const unsigned before = block_excl_scan(n, smem, &all);
    unsigned* om = off + (long long)m * (blocks + 1);
    if (b < blocks) om[b] = before;
    if (b == 0) {
      om[blocks] = all;
      st[kCand] = all;
      st[kRoute] = (long long)all <= cap;
    }
  }
}

// Candidate route: chunk b's keys whose digit 0 is τ's, in index order, at
// off[m][b] of the row's candidate buffer. A tile is kUnroll x kThreads
// float4s (element (u, t) at u * kThreads + t); the four counts of a
// thread, 16 bits each, share one 64-bit block scan. The next tile's loads
// are in flight while a tile is scanned.
__global__ void __launch_bounds__(kThreads)
topk_compact(const float4* __restrict__ X, long long q, long long chunk,
             const unsigned* __restrict__ stats,
             const unsigned* __restrict__ off, unsigned* __restrict__ cand,
             long long cap) {
  static_assert(kUnroll == 4, "four 16-bit counts in one 64-bit word");
  constexpr long long kTile = kUnroll * kThreads;
  __shared__ unsigned long long smem[32];
  const int m = blockIdx.y;
  const unsigned* om = off + (long long)m * (gridDim.x + 1);
  if (!stats[kStats * m + kRoute] || om[blockIdx.x] == om[blockIdx.x + 1])
    return;                       // block-uniform
  const unsigned d0 = stats[kStats * m + kTau] >> 20;
  unsigned* out = cand + (long long)m * cap + om[blockIdx.x];
  long long lo, hi;
  chunk_of(q, chunk, &lo, &hi);
  const float4* xr = X + (long long)m * q;
  float4 next[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = lo + u * kThreads + threadIdx.x;
    if (i < hi) next[u] = __ldg(xr + i);
  }
  unsigned run = 0u;
  for (long long t0 = lo; t0 < hi; t0 += kTile) {
    unsigned key[kUnroll][4];
    unsigned long long n = 0ull;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = t0 + u * kThreads + threadIdx.x;
      const float4 v = next[u];
      const bool in = i < hi;
      key[u][0] = key_of(v.x);
      key[u][1] = key_of(v.y);
      key[u][2] = key_of(v.z);
      key[u][3] = key_of(v.w);
      unsigned c = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) c += in && (key[u][e] >> 20) == d0;
      n |= (unsigned long long)c << (16 * u);
      if (i + kTile < hi) next[u] = __ldg(xr + i + kTile);
    }
    unsigned long long tile;
    const unsigned long long before = block_excl_scan(n, smem, &tile);
    unsigned base = run;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = t0 + u * kThreads + threadIdx.x;
      unsigned r = base + (unsigned)(before >> (16 * u) & 0xffffu);
      if (i < hi)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if ((key[u][e] >> 20) == d0) out[r++] = key[u][e];
      base += (unsigned)(tile >> (16 * u) & 0xffffu);
    }
    run = base;
  }
}

// eq[m, b] = #{ coordinates of chunk b with key == τ_m }.
__global__ void __launch_bounds__(kThreads)
topk_count_ties(const float4* __restrict__ X, long long q, long long chunk,
                const unsigned* __restrict__ stats,
                const unsigned* __restrict__ off,
                const unsigned* __restrict__ cand, long long cap,
                unsigned* __restrict__ eq) {
  __shared__ unsigned smem[32];
  const int m = blockIdx.y;
  const unsigned tau = stats[kStats * m + kTau];
  unsigned cnt = 0u;
  for_chunk_keys(X, q, chunk, stats, off, cand, cap,
                 [&](unsigned key) { cnt += key == tau; });
  unsigned total;
  block_excl_scan(cnt, smem, &total);
  if (threadIdx.x == 0) eq[(long long)m * gridDim.x + blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
topk_keep(const float4* __restrict__ X, float4* __restrict__ Y, long long q,
          long long chunk, const unsigned* __restrict__ stats,
          const unsigned* __restrict__ eq) {
  __shared__ unsigned smem[32];
  const int m = blockIdx.y, b = blockIdx.x;
  const unsigned tau = stats[kStats * m + kTau];
  const unsigned need = stats[kStats * m + kNeed];
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
  if (all || none) {              // every chunk but the one at the cut
    for_chunk_x(xr, lo, hi, [&](long long i, float4 v) {
      float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned key = key_of(f[c]);
        if (!(key > tau || (key == tau && all))) f[c] = 0.f;
      }
      yr[i] = make_float4(f[0], f[1], f[2], f[3]);
    });
    return;
  }
  // a block-uniform trip count: every thread takes part in every scan
  for (long long t0 = lo; t0 < hi; t0 += kThreads) {
    const long long i = t0 + threadIdx.x;
    const bool in = i < hi;
    const float4 v = in ? __ldg(xr + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    float f[4] = {v.x, v.y, v.z, v.w};
    unsigned key[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) key[c] = key_of(f[c]);
    bool keep_tie[4];
    const unsigned ties = in ? (key[0] == tau) + (key[1] == tau) +
                                   (key[2] == tau) + (key[3] == tau)
                             : 0u;
    unsigned tile;
    unsigned r = run + block_excl_scan(ties, smem, &tile);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      keep_tie[c] = r < need;
      if (key[c] == tau) ++r;
    }
    run += tile;
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
// 1 <= blocks <= 256 chunks per row (grid.x); cap candidates per row.
// scratch (32-bit words): hist M * 2048 | bhist M * blocks * 2048 | off
// M * (blocks + 1) | eq M * blocks | cand M * cap. stats: M * 4 words
// (τ's key, ties kept, candidates, route).
extern "C" int topk_compress_f32(const void* X, void* Y, void* scratch,
                                 void* stats, int M, long long P,
                                 long long k, int blocks, long long cap,
                                 void* stream) {
  if (M < 1 || M > 65535 || P < 4 || P % 4 || k < 1 || k > P ||
      P >= (1ll << 32) || blocks < 1 || blocks > kMaxBlocks || cap < 0 ||
      cap > P)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long q = P / 4;
  const long long chunk = (q + blocks - 1) / blocks;
  unsigned* hist = (unsigned*)scratch;
  unsigned* bhist = hist + (long long)M * kBins0;
  unsigned* off = bhist + (long long)M * blocks * kBins0;
  unsigned* eq = off + (long long)M * (blocks + 1);
  unsigned* cand = eq + (long long)M * blocks;
  unsigned* st = (unsigned*)stats;
  const float4* x = (const float4*)X;
  cudaError_t err =
      cudaMemsetAsync(hist, 0, sizeof(unsigned) * M * kBins0, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks, (unsigned)M);
  const unsigned kk = (unsigned)k;
  topk_hist0<<<grid, kThreads, 0, s>>>(x, q, chunk, hist, bhist);
  topk_select<0><<<M, kThreads, 0, s>>>(hist, st, kk, bhist, off, blocks,
                                        cap);
  topk_compact<<<grid, kThreads, 0, s>>>(x, q, chunk, st, off, cand, cap);
  topk_hist<1><<<grid, kThreads, 0, s>>>(x, q, chunk, st, off, cand, cap,
                                         hist);
  topk_select<1><<<M, kThreads, 0, s>>>(hist, st, kk, bhist, off, blocks,
                                        cap);
  topk_hist<2><<<grid, kThreads, 0, s>>>(x, q, chunk, st, off, cand, cap,
                                         hist);
  topk_select<2><<<M, kThreads, 0, s>>>(hist, st, kk, bhist, off, blocks,
                                        cap);
  topk_count_ties<<<grid, kThreads, 0, s>>>(x, q, chunk, st, off, cand, cap,
                                            eq);
  topk_keep<<<grid, kThreads, 0, s>>>(x, (float4*)Y, q, chunk, st, eq);
  return (int)cudaGetLastError();
}
