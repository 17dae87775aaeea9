// Stochastic int8 quantization of every row of an (M, P) f32 buffer,
// returned dequantized (DESIGN.md §18.1), with the row's own threefry key.
//
// No Pallas kernel to replace: this is the counterpart of the jnp
// src/repro/core/compress.py:int8_quantize and its jax.random.bernoulli
// draw, bit for bit as XLA compiles it (its division by the constant 127
// becomes a multiply by the float32 reciprocal). Per row m:
//   scale = max(max_i |x_i| * (1/127), 1e-30)    (NaN propagates, as jnp.max)
//   y = x_i / scale,  lo = floor(y),  d = y - lo
//   u = uniform bits of threefry2x32(key_m, (0, i))   (jax_threefry_
//       partitionable: each coordinate hashes its own 64-bit counter)
//   out_i = clamp(lo + (u < d), -127, 127) * scale
// The arithmetic is IEEE and spelled out with the _rn intrinsics (no FMA
// contraction, a true division; the library is built without fast math):
// one ulp of d flips a coordinate by a whole quantum. The clamp is written
// with compares so that a NaN passes through, as jnp.clip's does.
// Since u lies in [0, 1), u < d is false wherever !(d > 0): at every zero
// (-0.0 too: d = +0, and lo + 0 = +0), every y that is an integer, and
// every NaN y (a row whose scale is inf or NaN, where even a zero comes
// out NaN). Such a coordinate's draw cannot change its
// output, so its hash is skipped; the counter stays the coordinate's
// index, so no output bit changes. A zero also skips its division (the
// IEEE division takes its slow path on a zero numerator): with y = +0 it
// comes out 0 * scale, which is what the division gives, +0 for a finite
// scale and NaN for an inf or NaN one.
//
// The max is taken over the magnitudes' bits, bits(x) & 0x7fffffff, as
// unsigned integers: for non-negative floats their order is the float
// order, and a NaN's bits lie above +inf's, so an atomicMax of the bits
// propagates NaN where fmaxf would drop it.
//
// What bounds it. Bytes: one read and one write of x, 8 bytes a
// coordinate (0.158 ms at (M, P) = (10, 6,603,712) at 3.35 TB/s). Hashes:
// one threefry a coordinate that needs a draw, ~45 of its ~70 instructions
// on the SM's integer (ALU) pipe, which caps the card at ~3.6e11 hashes a
// second. The compress path feeds two kinds of rows: the internal link
// quantizes top-k rows, 99% exact zeros, which need ~1% of the draws
// (bytes-bound); the external link dense deltas, which need nearly all
// (66 M hashes, 0.18 ms).
// Design: one launch (after a memset of the scratch), a persistent grid
// of one 1024-thread block an SM, every block resident. Row by row, each
// block owns the same contiguous slice of float4s, split into contiguous
// per-warp ranges, and keeps its slice of the row in shared memory (up to
// ~212 KB; a longer slice reads its tail from device memory twice, in the
// kernel's <false> form), so x is read from device memory once:
//   - the slice of row m+1 is copied in by cp.async, element by element
//     into the slot the same thread has just read row m's value from, one
//     commit group a tile, while row m is quantized: the reads of m+1
//     overlap the writes of m, and each tile's max is taken once its group
//     has landed;
//   - each block's max of a row goes to rowmax[m] by one atomicMax, then
//     one release-add on a counter (rowmax[M]); before quantizing row m, a
//     block waits until the counter reaches (m + 1) * blocks (a grid
//     barrier per row; the memset resets it, so a CUDA graph replays the
//     launch, and a wait longer than 10 s traps instead of hanging);
//   - a warp quantizes a tile of 2 float4s a lane (256 coordinates) at a
//     time. Past 128 nonzeros it takes every coordinate as the plain
//     arithmetic has it, its 8 hashes a lane side by side under one key
//     schedule. Below, it counts the coordinates that need a draw and
//     compacts them over the warp, 32 a round (counter and d staged in
//     shared memory, one hash a lane, the bit handed back), so a 1%-dense
//     tile pays one hash a lane and not one for each coordinate any lane
//     needs.
// Measured on an H100 (`python3 scripts/rng_kernels_ab.py --split`,
// PERF.md): at (10, 6,603,712) the reads and writes alone through this
// grid (a plain copy) take ~0.226 ms, ~0.018 of it the row barriers; top-k
// rows take ~0.257, dense rows ~0.309, ~0.058 of it their hashes.
#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kV = 2;                         // float4s a lane per tile
constexpr int kTile = 32 * kV;                // float4s a warp tile
constexpr int kCoords = 4 * kV;               // coordinates a lane per tile
constexpr int kDense = 32 * kCoords / 2;      // past this, hash in place
constexpr int kCompact = 64;                  // words a warp: 32 counters, 32 d
constexpr int kSmemMax = 220 * 1024;          // dynamic bytes a block
constexpr long long kSpinNs = 10000000000ll;  // a wait past 10 s traps

__device__ __forceinline__ unsigned mag_bits(float f) {
  return __float_as_uint(f) & 0x7fffffffu;
}

__device__ __forceinline__ unsigned max4(const float4& f) {
  return max(max(mag_bits(f.x), mag_bits(f.y)),
             max(mag_bits(f.z), mag_bits(f.w)));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// one arrival, ordered after this thread's earlier writes (its atomicMax)
__device__ __forceinline__ void red_release_add(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
               :: "l"(p) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// 16 bytes from device memory into shared memory, asynchronously. `after`
// is a value the caller read from the same slot: naming it makes the copy
// wait for that read.
__device__ __forceinline__ void cp_async16(float4* smem, const float4* gmem,
                                           float after) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(gmem), "f"(after) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// every copy of this thread but those of its newest group has landed
__device__ __forceinline__ void cp_async_wait_older() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

struct Slice {
  const float4* stash;   // the block's slice, its first `cap` float4s
  long long s0;          // the slice's first float4 in the row
  int w0, w1, cap;       // this warp's range [w0, w1) of the slice
};

// element j of the slice: kWhole, the slice lies whole in the stash
template <bool kWhole>
__device__ __forceinline__ float4 load(const Slice& s, const float4* xr,
                                       int j) {
  if (kWhole) return s.stash[j];
  return j < s.cap ? s.stash[j] : __ldg(xr + s.s0 + j);
}

// copy this thread's elements of row xr into the stash
__device__ __forceinline__ void stage(const Slice& s, float4* stash,
                                      const float4* xr, int lane) {
  const int end = min(s.w1, s.cap);
  for (int j = s.w0 + lane; j < end; j += 32)
    cp_async16(stash + j, xr + s.s0 + j, 0.f);
}

// this thread's max over its elements of the tile at `base`
template <bool kWhole>
__device__ __forceinline__ unsigned tile_max(const Slice& s, const float4* xr,
                                             int base, int lane) {
  unsigned v = 0u;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int j = base + i * 32 + lane;
    if (j < s.w1) v = max(v, max4(load<kWhole>(s, xr, j)));
  }
  return v;
}

// this block's max of row m into rowmax[m], then one arrival
__device__ __forceinline__ void arrive(unsigned v, unsigned* red,
                                       unsigned* rowmax, unsigned* arrivals,
                                       int m) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned mx = 0u;
    for (int i = 0; i < kWarps; ++i) mx = max(mx, red[i]);
    if (mx) atomicMax(rowmax + m, mx);
    red_release_add(arrivals);
  }
}

// wait until every block has arrived for row m; the row's max bits
__device__ __forceinline__ unsigned wait_row(const unsigned* rowmax,
                                             const unsigned* arrivals,
                                             int m, unsigned* shared_max) {
  if (threadIdx.x == 0) {
    const unsigned target = (unsigned)(m + 1) * gridDim.x;
    if (ld_acquire(arrivals) < target) {
      const unsigned long long t0 = global_ns();
      while (ld_acquire(arrivals) < target) {
        __nanosleep(20);
        if ((long long)(global_ns() - t0) > kSpinNs) __trap();
      }
    }
    *shared_max = ld_acquire(rowmax + m);
  }
  __syncthreads();
  return *shared_max;
}

__device__ __forceinline__ float finish(float lo, bool up, float scale) {
  float qv = __fadd_rn(lo, up ? 1.f : 0.f);
  qv = qv < -127.f ? -127.f : (qv > 127.f ? 127.f : qv);
  return __fmul_rn(qv, scale);
}

// one coordinate with its draw's bits, as the plain arithmetic has it
__device__ __forceinline__ float quant1(float x, float scale, unsigned bits) {
  const float y = __fdiv_rn(x, scale);
  const float lo = floorf(y);
  return finish(lo, threefry::unit_uniform(bits) < __fsub_rn(y, lo), scale);
}

template <bool kWhole>
__global__ void __launch_bounds__(kThreads, 1)
int8_quant_rows(const float4* __restrict__ X,
                const unsigned* __restrict__ keys, float4* __restrict__ Y,
                unsigned* __restrict__ scratch, int M, long long q,
                int cap) {
  extern __shared__ float4 stash[];
  __shared__ unsigned red[kWarps];
  __shared__ unsigned shared_max;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned* rowmax = scratch;
  unsigned* arrivals = scratch + M;
  unsigned* cbuf = reinterpret_cast<unsigned*>(stash + cap) + w * kCompact;
  float* dbuf = reinterpret_cast<float*>(cbuf + 32);

  const long long len = (q + gridDim.x - 1) / gridDim.x;
  const long long s0 = (long long)blockIdx.x * len;
  const int n = (int)max(0ll, min(len, q - s0));
  const int per = (n + kWarps - 1) / kWarps;
  Slice s;
  s.stash = stash;
  s.s0 = s0;
  s.w0 = min(n, w * per);
  s.w1 = min(n, s.w0 + per);
  s.cap = cap;

  stage(s, stash, X, lane);
  cp_async_wait_all();
  unsigned first = 0u;                         // row 0's, this thread's
  for (int base = s.w0; base < s.w1; base += kTile)
    first = max(first, tile_max<kWhole>(s, X, base, lane));
  arrive(first, red, rowmax, arrivals, 0);

  for (int m = 0; m < M; ++m) {
    // 1/127 rounded to float32, as XLA folds the constant divisor
    const float sm = __fmul_rn(
        __uint_as_float(wait_row(rowmax, arrivals, m, &shared_max)),
        __uint_as_float(0x3c010204u));
    const float scale = sm != sm ? sm : fmaxf(sm, 1e-30f);  // NaN stays NaN
    const threefry::Schedule key = threefry::schedule(keys[2 * m],
                                                      keys[2 * m + 1]);
    const float4* xr = X + (long long)m * q;
    const float4* xn = xr + q;                 // row m + 1
    const bool next = m + 1 < M;
    float4* yr = Y + (long long)m * q;

    unsigned nmax = 0u;                        // row m + 1's, this thread's
    for (int base = s.w0; base < s.w1; base += kTile) {
      float4 f[kV];
      int nonzero = 0;
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int j = base + v * 32 + lane;
        f[v] = j < s.w1 ? load<kWhole>(s, xr, j) : make_float4(0, 0, 0, 0);
        nonzero += (f[v].x != 0.f) + (f[v].y != 0.f) + (f[v].z != 0.f) +
                   (f[v].w != 0.f);
        if (next && j < s.w1 && j < cap)
          cp_async16(stash + j, xn + s0 + j, f[v].x);
      }
      if (next) {              // the previous tile of row m + 1 has landed
        cp_async_commit();
        cp_async_wait_older();
        if (base > s.w0)
          nmax = max(nmax, tile_max<kWhole>(s, xn, base - kTile, lane));
      }
      // the first coordinate's counter of this lane's float4 v is
      // c0 + 128 v
      const unsigned c0 = (unsigned)(4 * (s0 + base + lane));
      if (__reduce_add_sync(0xffffffffu, nonzero) > kDense) {
        // mostly dense: every coordinate hashed in place, as the plain
        // arithmetic has it
        unsigned k0[kCoords], k1[kCoords], c[kCoords], h0[kCoords],
            h1[kCoords];
#pragma unroll
        for (int b = 0; b < kCoords; ++b) {
          k0[b] = key.k0;
          k1[b] = key.k1;
          c[b] = c0 + 128u * (b / 4) + (b % 4);
        }
        threefry::threefry2x32_n<kCoords>(k0, k1, c, h0, h1);
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          const int j = base + v * 32 + lane;
          const float4 o = make_float4(
              quant1(f[v].x, scale, h0[4 * v] ^ h1[4 * v]),
              quant1(f[v].y, scale, h0[4 * v + 1] ^ h1[4 * v + 1]),
              quant1(f[v].z, scale, h0[4 * v + 2] ^ h1[4 * v + 2]),
              quant1(f[v].w, scale, h0[4 * v + 3] ^ h1[4 * v + 3]));
          if (j < s.w1) yr[s0 + j] = o;
        }
        continue;
      }
      float lo[kCoords], d[kCoords];
      unsigned need = 0u;
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const float xs[4] = {f[v].x, f[v].y, f[v].z, f[v].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float y = 0.f;             // a zero: see the header
          if (xs[c] != 0.f) y = __fdiv_rn(xs[c], scale);
          lo[4 * v + c] = floorf(y);
          d[4 * v + c] = __fsub_rn(y, lo[4 * v + c]);
          need |= (d[4 * v + c] > 0.f ? 1u : 0u) << (4 * v + c);
        }
      }
      const int total = __reduce_add_sync(0xffffffffu, __popc(need));
      unsigned up = 0u;
      if (total > 0) {                 // compact the draws over the warp
        const int cnt = __popc(need);
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += t;
        }
        const int off = incl - cnt;
        for (int r = 0; r < total; r += 32) {
          int k = off - r;
#pragma unroll
          for (int b = 0; b < kCoords; ++b)
            if (need >> b & 1u) {
              if (k >= 0 && k < 32) {
                cbuf[k] = c0 + 128u * (b / 4) + (b % 4);
                dbuf[k] = d[b];
              }
              ++k;
            }
          __syncwarp();
          if (r + lane < total) {
            const float u = threefry::unit_uniform(
                threefry::bits(key, cbuf[lane]));
            cbuf[lane] = u < dbuf[lane] ? 1u : 0u;
          }
          __syncwarp();
          k = off - r;
#pragma unroll
          for (int b = 0; b < kCoords; ++b)
            if (need >> b & 1u) {
              if (k >= 0 && k < 32) up |= cbuf[k] << b;
              ++k;
            }
          __syncwarp();
        }
      }
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int j = base + v * 32 + lane;
        if (j < s.w1)
          yr[s0 + j] = make_float4(
              finish(lo[4 * v], up >> (4 * v) & 1u, scale),
              finish(lo[4 * v + 1], up >> (4 * v + 1) & 1u, scale),
              finish(lo[4 * v + 2], up >> (4 * v + 2) & 1u, scale),
              finish(lo[4 * v + 3], up >> (4 * v + 3) & 1u, scale));
      }
    }
    if (next) {
      cp_async_wait_all();
      if (s.w1 > s.w0)              // the last tile of row m + 1
        nmax = max(nmax, tile_max<kWhole>(
                             s, xn, s.w0 + (s.w1 - s.w0 - 1) / kTile * kTile,
                             lane));
      arrive(nmax, red, rowmax, arrivals, m + 1);
    }
  }
}

}  // namespace

// X, Y (M, P) row-major f32, P % 4 == 0, 16-byte aligned, P < 2^32;
// keys (M, 2) uint32 threefry keys; rowmax: M + 1 32-bit words of scratch
// (each row's max, then the blocks' arrivals), zeroed here.
extern "C" int int8_quant_f32(const void* X, const void* keys, void* Y,
                              void* rowmax, int M, long long P, void* stream) {
  if (M < 1 || M > 65535 || P < 4 || P % 4 || P >= (1ll << 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long q = P / 4;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // blocks: as many as stay resident at the largest shared memory, fewer
  // for a short row (a tile a warp at least); every block must be resident
  // at once, since each row's barrier waits on all of them
  using Kernel = void (*)(const float4*, const unsigned*, float4*, unsigned*,
                          int, long long, int);
  const Kernel kernels[2] = {int8_quant_rows<false>, int8_quant_rows<true>};
  int per_sm = 1 << 30;
  for (const Kernel k : kernels) {
    int n = 0;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemMax);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kThreads,
                                                          kSmemMax);
    per_sm = n < per_sm ? n : per_sm;
  }
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (q + kTile - 1) / kTile;
  long long grid = (long long)per_sm * sms;
  const long long wanted = (tiles + kWarps - 1) / kWarps;
  if (grid > wanted) grid = wanted;
  const long long len = (q + grid - 1) / grid;
  const int extra = kWarps * kCompact * (int)sizeof(unsigned);
  const long long room = (kSmemMax - extra) / (long long)sizeof(float4);
  const int cap = (int)(len < room ? len : room);
  const int smem = cap * (int)sizeof(float4) + extra;
  err = cudaMemsetAsync(rowmax, 0, sizeof(unsigned) * (M + 1), s);
  if (err != cudaSuccess) return (int)err;
  const Kernel kernel = kernels[cap == len];   // the whole slice stashed
  kernel<<<(unsigned)grid, kThreads, smem, s>>>(
      (const float4*)X, (const unsigned*)keys, (float4*)Y, (unsigned*)rowmax,
      M, q, cap);
  return (int)cudaGetLastError();
}
