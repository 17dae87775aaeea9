// Fault injection of the robustness layer (DESIGN.md §15.1) on the flat
// member-gradient buffer, in place: the fault trace, drawn by the caller
// as one code per row, applied to every coordinate of the hit rows.
//
// No Pallas kernel to replace: this is the counterpart of the jnp
// src/repro/data/streaming.py:make_corruption_fn and its per-(member,
// leaf) jax.random.normal draw. Per row r of X (R, P4), code[r] is 0
// (untouched) or 1 + the index j of the row's mode in the configured mix,
// and ops[j] names that mode (CORRUPTION_MODES order):
//   nan_burst    x = NaN                (0x7fc00000, jnp.nan's bits)
//   inf_spike    x = +Inf
//   scale        x = x * scale
//   sign_flip    x = -x
//   gauss_noise  x = x + sigma * sqrt2 * erfinv(u)
// For gauss_noise, coordinate i of leaf s (off[s] <= i < off[s+1]) draws
// u from the threefry bits of counter (0, i - off[s]) under the row's
// leaf key keys[r, s], jax.random.normal's uniform on
// (nextafter(-1, 0), 1), and erfinv is XLA's Giles polynomial with each
// Horner step one fmaf; the multiplies and the add are spelled
// __fmul_rn/__fadd_rn so that nothing contracts them into an FMA the
// plain version does not do. Coordinates past P (the P4 pad) are never
// read or written.
//
// What bounds it: two resources, used by two kinds of row. A scale or
// sign row moves 8 bytes a coordinate (read, write) and a NaN/Inf row 4
// (written only): HBM's rate. A gauss row moves 8 bytes too, but its
// threefry draw is 74 32-bit integer operations a coordinate (chip_smoke
// prices them at 16.7 Tops/s, 64 INT32 lanes an SM; the card measures
// 3.6e11 hashes a second, ptxas moving some adds to the FMA pipes), and
// its normal ~40 more instructions: issue-bound. At the robust path's
// (R, P) = (100, 6,603,710) the CLI's typical trace (4 scale, 2 NaN, 4
// gauss rows) is 475 MB, 0.142 ms at 3.35 TB/s, and 2.0e9 integer
// operations, 0.117 ms at 16.7 Tops/s; every row gauss is 2.9 ms of
// integer work. So a launch is as fast as the two kinds overlap: the byte
// rows' traffic has to flow while the gauss rows hash.
// Design: one launch whatever fired, a persistent grid (kMinBlocks blocks
// an SM; the grid depends on R and P, not on the trace, so a CUDA graph
// captures it). Every block compacts the hit rows into two lists in
// shared memory, the gauss rows and the byte rows (row and op packed), and
// cuts each list into work items of 32 float4 vectors, one per lane of a
// warp. Warp w of W takes the w-th of W equal slices of each kind's items
// and walks them interleaved in proportion (Bresenham: after each gauss
// item, the byte items now due): the first due byte item's load is
// issued before the gauss item's hashes, so that it is in flight while
// they run, the rest follow kBatch loads at a time. Every warp carries
// the same mix, so int-bound and byte-bound work share each SM to the
// end, with no tail of gauss items; a warp whose slice holds no gauss item
// streams its byte items kBatch at a time. A lane keeps its leaf segment
// and the leaf key's words across items (its coordinates only move
// forward within a row), so a float4 inside one leaf (all but those that
// straddle a leaf boundary) hashes its four counters ctr = i - off[s] ..
// + 3 in 32 bits, four chains side by side; a straddling float4 or the
// row's last takes the per-coordinate path. Every helper is inlined: a
// call out of line made ptxas save registers around it (spills), and
// cost 9% at the typical trace on the card.
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;     // resident blocks an SM (launch bounds)
constexpr int kMaxSegs = 64;
constexpr int kMaxModes = 8;
constexpr int kAhead = 1;         // byte items in flight during a gauss item
constexpr int kBatch = 6;         // byte items in flight together after it

enum Op { kNan = 0, kInf = 1, kScale = 2, kSign = 3, kGauss = 4 };

struct Layout {
  unsigned off[kMaxSegs + 1];     // leaf segment offsets; off[nseg] = P
  int ops[kMaxModes];             // mode index -> Op
  int nseg, nmodes;
  unsigned P, nvec, per_row;      // P, vectors with a coordinate, items a row
};

// A list's position: the row's index in the list and the item in the row
struct Cursor {
  int row;
  unsigned item;
  __device__ void next(unsigned per_row) {
    if (++item == per_row) {
      item = 0;
      ++row;
    }
  }
};

// A byte row's op on one coordinate (NaN and Inf ignore x)
__device__ __forceinline__ float byte_op(float x, int op, float scale) {
  if (op == kScale) return __fmul_rn(x, scale);
  if (op == kSign) return -x;
  return __int_as_float(op == kNan ? 0x7fc00000 : 0x7f800000);
}

// The row's last vector when P % 4 != 0: its n coordinates one by one
__device__ __forceinline__ void byte_tail(float* p, int n, int op,
                                          float scale) {
  for (int j = 0; j < n; ++j) p[j] = byte_op(p[j], op, scale);
}

// Up to N byte items of one lane: load() issues every load (a NaN or Inf
// row loads nothing), store() writes them
template <int N>
struct ByteBatch {
  float4 v[N];
  float* p[N];
  int opn[N];                     // op << 3 | coordinates, 0 past the end

  __device__ __forceinline__ void load(int m, Cursor& bc, const int* lists,
                                       int R, float* X, long long P4,
                                       unsigned P, unsigned nvec,
                                       unsigned per_row, int lane) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      opn[k] = 0;
      if (k < m) {
        const int entry = lists[R - 1 - bc.row];
        const unsigned vec = bc.item * 32 + lane;
        bc.next(per_row);
        if (vec < nvec) {
          const unsigned i0 = 4 * vec;
          const int n = P - i0 < 4u ? (int)(P - i0) : 4;
          opn[k] = (entry >> 16) << 3 | n;
          p[k] = X + (long long)(entry & 0xffff) * P4 + i0;
          if (n == 4 && entry >> 16 >= kScale)
            v[k] = *reinterpret_cast<const float4*>(p[k]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(float scale) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int op = opn[k] >> 3, n = opn[k] & 7;
      if (n == 4) {
        *reinterpret_cast<float4*>(p[k]) = make_float4(
            byte_op(v[k].x, op, scale), byte_op(v[k].y, op, scale),
            byte_op(v[k].z, op, scale), byte_op(v[k].w, op, scale));
      } else if (n > 0) {
        byte_tail(p[k], n, op, scale);
      }
    }
  }
};

// x plus sigma times the normal of a coordinate's threefry bits
__device__ __forceinline__ float noisy(float x, unsigned bits, float sigma) {
  return __fadd_rn(x, __fmul_rn(sigma, threefry::normal_from_bits(bits)));
}

// A gauss float4 that straddles a leaf boundary, or the row's last: its n
// coordinates one by one, each under its own leaf's key
__device__ __forceinline__ void gauss_boundary(float* xr,
                                               const unsigned* kr,
                                               const unsigned* off, int s,
                                               unsigned i0, int n,
                                               float sigma) {
  for (int j = 0; j < n; ++j) {
    const unsigned i = i0 + j;
    while (off[s + 1] <= i) ++s;
    xr[i] = noisy(xr[i],
                  threefry::threefry_bits(kr[2 * s], kr[2 * s + 1], i - off[s]),
                  sigma);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
corrupt_rows_kernel(float* __restrict__ X, const int* __restrict__ code,
                    const unsigned* __restrict__ keys, int R, long long P4,
                    Layout lay, float scale, float sigma) {
  // gauss rows from the front, byte rows (row | op << 16) from the back
  extern __shared__ int lists[];             // R entries
  __shared__ unsigned off[kMaxSegs + 1];
  __shared__ int ops[kMaxModes];
  __shared__ int counts[2];
  const int lane = threadIdx.x & 31;
  for (int s = threadIdx.x; s <= lay.nseg; s += kThreads) off[s] = lay.off[s];
  if (threadIdx.x < kMaxModes) ops[threadIdx.x] = lay.ops[threadIdx.x];
  __syncthreads();
  if (threadIdx.x < 32) {                    // compact the hit rows in order
    int ng = 0, nb = 0;
    const unsigned below = (1u << lane) - 1u;
    for (int base = 0; base < R; base += 32) {
      const int r = base + lane;
      const int c = r < R ? code[r] : 0;
      const int op = c >= 1 && c <= lay.nmodes ? ops[c - 1] : -1;
      const unsigned g = __ballot_sync(0xffffffffu, op == kGauss);
      const unsigned b = __ballot_sync(0xffffffffu, op >= 0 && op != kGauss);
      if (op == kGauss) lists[ng + __popc(g & below)] = r;
      else if (op >= 0) lists[R - 1 - nb - __popc(b & below)] = r | op << 16;
      ng += __popc(g);
      nb += __popc(b);
    }
    if (lane == 0) {
      counts[0] = ng;
      counts[1] = nb;
    }
  }
  __syncthreads();
  const int nseg = lay.nseg;
  const unsigned P = lay.P, nvec = lay.nvec, per_row = lay.per_row;
  // this warp's slice of each list's items (the host keeps a slice < 2^31)
  const long long warps = (long long)gridDim.x * kWarps;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long gall = (long long)counts[0] * per_row;
  const long long ball = (long long)counts[1] * per_row;
  const long long g0 = gall * w / warps, b0 = ball * w / warps;
  const unsigned ng = (unsigned)(gall * (w + 1) / warps - g0);
  const unsigned nb_all = (unsigned)(ball * (w + 1) / warps - b0);
  Cursor gc = {(int)(g0 / per_row), (unsigned)(g0 % per_row)};
  Cursor bc = {(int)(b0 / per_row), (unsigned)(b0 % per_row)};
  unsigned nb = nb_all;                      // byte items left

  // the lane's gauss state: row, leaf segment, the leaf key's schedule
  int grow = -1, s = 0;
  float* xr = nullptr;
  const unsigned* kr = nullptr;
  threefry::Schedule ks;

  unsigned acc = 0;
  for (unsigned g = 0; g < ng; ++g) {
    acc += nb_all;                           // the byte items due with it
    int due = 0;
    while (acc >= ng) {
      acc -= ng;
      ++due;
    }
    nb -= due;
    ByteBatch<kAhead> ahead;
    const int first = due < kAhead ? due : kAhead;
    ahead.load(first, bc, lists, R, X, P4, P, nvec, per_row, lane);

    const int r = lists[gc.row];
    const unsigned vec = gc.item * 32 + lane;
    gc.next(per_row);
    if (r != grow) {
      grow = r;
      s = 0;
      xr = X + (long long)r * P4;
      kr = keys + 2ll * nseg * r;
      ks = threefry::schedule(kr[0], kr[1]);
    }
    if (vec < nvec) {
      const unsigned i0 = 4 * vec;
      if (off[s + 1] <= i0) {
        do ++s; while (off[s + 1] <= i0);
        ks = threefry::schedule(kr[2 * s], kr[2 * s + 1]);
      }
      if (off[s + 1] - i0 >= 4) {            // inside leaf s: 32-bit counters
        float4 f = *reinterpret_cast<const float4*>(xr + i0);
        const unsigned ctr = i0 - off[s];
        unsigned bits[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) bits[j] = threefry::bits(ks, ctr + j);
        f.x = noisy(f.x, bits[0], sigma);
        f.y = noisy(f.y, bits[1], sigma);
        f.z = noisy(f.z, bits[2], sigma);
        f.w = noisy(f.w, bits[3], sigma);
        *reinterpret_cast<float4*>(xr + i0) = f;
      } else {
        gauss_boundary(xr, kr, off, s, i0, P - i0 < 4u ? (int)(P - i0) : 4,
                       sigma);
      }
    }
    ahead.store(scale);
    for (due -= first; due > 0; due -= kBatch) {
      ByteBatch<kBatch> batch;
      batch.load(due < kBatch ? due : kBatch, bc, lists, R, X, P4, P, nvec,
                 per_row, lane);
      batch.store(scale);
    }
  }
  for (; nb > 0; nb -= nb < kBatch ? nb : kBatch) {  // no gauss item left
    ByteBatch<kBatch> batch;
    batch.load(nb < kBatch ? (int)nb : kBatch, bc, lists, R, X, P4, P, nvec,
               per_row, lane);
    batch.store(scale);
  }
}

}  // namespace

// X (R, P4) row-major f32, P4 % 4 == 0, 16-byte aligned; code (R,) int32;
// keys (R, nseg, 2) uint32 leaf keys (read for gauss_noise rows only, may
// be null when no mode is gauss_noise); offsets (nseg + 1,) host int64,
// offsets[0] = 0, increasing, offsets[nseg] = P <= P4, P < 2^32; ops
// (nmodes,) host int32 Op of each mode of the mix.
extern "C" int corrupt_rows_f32(void* X, const void* code, const void* keys,
                                int R, long long P4, const long long* offsets,
                                int nseg, const int* ops, int nmodes,
                                float scale, float sigma, void* stream) {
  if (R < 1 || R > 12000 || P4 < 4 || P4 % 4 || nseg < 1 ||
      nseg > kMaxSegs || nmodes < 1 || nmodes > kMaxModes ||
      offsets[0] != 0 || offsets[nseg] > P4 || offsets[nseg] >= (1ll << 32))
    return (int)cudaErrorInvalidValue;
  Layout lay = {};
  for (int s = 0; s <= nseg; ++s) {
    if (s && offsets[s] <= offsets[s - 1]) return (int)cudaErrorInvalidValue;
    lay.off[s] = (unsigned)offsets[s];
  }
  for (int j = 0; j < nmodes; ++j) {
    if (ops[j] < kNan || ops[j] > kGauss) return (int)cudaErrorInvalidValue;
    if (ops[j] == kGauss && keys == nullptr) return (int)cudaErrorInvalidValue;
    lay.ops[j] = ops[j];
  }
  lay.nseg = nseg;
  lay.nmodes = nmodes;
  lay.P = (unsigned)offsets[nseg];
  lay.nvec = (unsigned)((offsets[nseg] + 3) / 4);
  lay.per_row = (lay.nvec + 31) / 32;
  const size_t smem = sizeof(int) * R;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, corrupt_rows_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  // every block resident, and no more warps than the items of R hit rows;
  // a warp's slice of a list's items stays under 2^31
  const long long items = (long long)R * lay.per_row;
  const long long useful = (items + kWarps - 1) / kWarps;
  const long long cap = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned grid = (unsigned)(useful < cap ? useful : cap);
  if (items / ((long long)grid * kWarps) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  corrupt_rows_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (float*)X, (const int*)code, (const unsigned*)keys, R, P4, lay, scale,
      sigma);
  return (int)cudaGetLastError();
}
