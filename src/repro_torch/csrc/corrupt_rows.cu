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
// What bounds it: bytes for the scale/sign/NaN/Inf rows, 8 per coordinate
// of a read-modify-write row and 4 of a NaN/Inf row (written only); the
// threefry's integer work for gauss rows, 74 32-bit integer operations
// per coordinate (as in int8_quant.cu) against 8 bytes. At the robust
// path's (R, P) = (100, 6,603,710) with every row gauss that is 4.9e10
// operations, 2.9 ms at the H100's 16.7 Tops/s int32 (5.3 GB moved,
// 1.6 ms); the erfinv's ~30 float operations a coordinate run on the FP32
// pipes beside it. A typical iteration hits a handful of rows: well under
// 0.1 ms.
// Design: one launch whatever fired. Rows with code 0 cost nothing: every
// block compacts the hit rows (one warp, ballots over code[]) into shared
// memory and walks work items of (hit row, 4096-vector chunk) in a
// grid-stride loop, so no block is spent on an untouched row and the grid
// does not depend on the trace (a CUDA graph captures it). One float4 per
// thread per step; a NaN/Inf row skips the load.
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegs = 64;
constexpr int kMaxModes = 8;
constexpr long long kChunk = 4096;   // float4 vectors per work item

enum Op { kNan = 0, kInf = 1, kScale = 2, kSign = 3, kGauss = 4 };

struct Layout {
  long long off[kMaxSegs + 1];   // leaf segment offsets; off[nseg] = P
  int ops[kMaxModes];            // mode index -> Op
  int nseg, nmodes;
};

__global__ void __launch_bounds__(kThreads)
corrupt_rows_kernel(float* __restrict__ X, const int* __restrict__ code,
                    const unsigned* __restrict__ keys, int R, long long P4,
                    Layout lay, float scale, float sigma) {
  extern __shared__ int hit_rows[];          // R entries
  __shared__ long long off[kMaxSegs + 1];
  __shared__ int ops[kMaxModes];
  __shared__ int nhit;
  for (int s = threadIdx.x; s <= lay.nseg; s += kThreads) off[s] = lay.off[s];
  if (threadIdx.x < kMaxModes) ops[threadIdx.x] = lay.ops[threadIdx.x];
  if (threadIdx.x < 32) {                    // compact the hit rows in order
    int n = 0;
    for (int base = 0; base < R; base += 32) {
      const int r = base + threadIdx.x;
      const int c = r < R ? code[r] : 0;
      const bool h = c >= 1 && c <= lay.nmodes;
      const unsigned ball = __ballot_sync(0xffffffffu, h);
      if (h) hit_rows[n + __popc(ball & ((1u << threadIdx.x) - 1u))] = r;
      n += __popc(ball);
    }
    if (threadIdx.x == 0) nhit = n;
  }
  __syncthreads();
  const int nseg = lay.nseg;
  const long long P = off[nseg];
  const long long nvec = (P + 3) / 4;        // vectors holding a coordinate
  const long long chunks = (nvec + kChunk - 1) / kChunk;
  const long long items = (long long)nhit * chunks;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const int r = hit_rows[w / chunks];
    const int op = ops[code[r] - 1];
    float* xr = X + (long long)r * P4;
    const long long v0 = (w % chunks) * kChunk;
    const long long v1 = v0 + kChunk < nvec ? v0 + kChunk : nvec;
    for (long long v = v0 + threadIdx.x; v < v1; v += kThreads) {
      const long long i0 = 4 * v;
      const int n = P - i0 < 4 ? (int)(P - i0) : 4;
      float e[4] = {0.f, 0.f, 0.f, 0.f};
      if (op == kNan || op == kInf) {
        const float f = __int_as_float(op == kNan ? 0x7fc00000 : 0x7f800000);
        e[0] = e[1] = e[2] = e[3] = f;
      } else {
        if (n == 4) {
          const float4 f = reinterpret_cast<const float4*>(xr)[v];
          e[0] = f.x; e[1] = f.y; e[2] = f.z; e[3] = f.w;
        } else {
          for (int j = 0; j < n; ++j) e[j] = xr[i0 + j];
        }
        if (op == kScale) {
#pragma unroll
          for (int j = 0; j < 4; ++j) e[j] = __fmul_rn(e[j], scale);
        } else if (op == kSign) {
#pragma unroll
          for (int j = 0; j < 4; ++j) e[j] = -e[j];
        } else {
          const unsigned* kr = keys + 2ll * nseg * r;
          int s = 0;
          while (off[s + 1] <= i0) ++s;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const long long i = i0 + j;
            if (j < n) {
              while (off[s + 1] <= i) ++s;
              const unsigned bits = threefry::threefry_bits(
                  kr[2 * s], kr[2 * s + 1], (unsigned)(i - off[s]));
              e[j] = __fadd_rn(
                  e[j], __fmul_rn(sigma, threefry::normal_from_bits(bits)));
            }
          }
        }
      }
      if (n == 4) {
        reinterpret_cast<float4*>(xr)[v] = make_float4(e[0], e[1], e[2], e[3]);
      } else {
        for (int j = 0; j < n; ++j) xr[i0 + j] = e[j];
      }
    }
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
    lay.off[s] = offsets[s];
  }
  for (int j = 0; j < nmodes; ++j) {
    if (ops[j] < kNan || ops[j] > kGauss) return (int)cudaErrorInvalidValue;
    if (ops[j] == kGauss && keys == nullptr) return (int)cudaErrorInvalidValue;
    lay.ops[j] = ops[j];
  }
  lay.nseg = nseg;
  lay.nmodes = nmodes;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long nvec = (offsets[nseg] + 3) / 4;
  const long long work = (long long)R * ((nvec + kChunk - 1) / kChunk);
  const long long cap = 8ll * sms;           // one full wave of 256-thread
  const unsigned grid = (unsigned)(work < cap ? work : cap);   // blocks
  corrupt_rows_kernel<<<grid, kThreads, sizeof(int) * R,
                        (cudaStream_t)stream>>>(
      (float*)X, (const int*)code, (const unsigned*)keys, R, P4, lay, scale,
      sigma);
  return (int)cudaGetLastError();
}
