// Fused conv block: per-group im2col GEMM + bias, ReLU and 2x2 max-pool.
//
// Replaces src/repro/kernels/conv_fused/kernel.py:conv_fused_kernel
// (_conv_fused_kernel): for every group g, y = patches[g] (R x Q) · w[g]
// (Q x C) + b[g]; out = maxpool2x2(relu(y)), or out = relu(y) with
// pool = 0. Both y (the backward's ReLU and pool-mask residual) and out are
// written.
//
// What bounds it: operations. conv2 of the paper's CNN over the 3200-image
// superbatch is 2·G·R·Q·C = 64 GFLOP against 2.3 GB of traffic. The f32
// product must stay strict f32 (TF32 would break parity with the reference),
// so it runs on the FP32 pipes, not the tensor cores. An SM issues 128 FP32
// FMAs per clock but reads 32 floats per clock from shared memory, so a
// thread must issue at least 4 FMAs per float it reads there, and the
// patches (2.0 GB at conv2) must stream in while the FMAs run.
//
// Design: a GEMM tile is BM = 32·TM rows x BN = 8·TN columns, 256 threads,
// each accumulating a TM x TN register tile: 14 x 8 when C > 32 (448 rows,
// 16 whole row-pairs of a 14-wide image), 8 x 4 otherwise. Per 4-deep step
// a thread reads its TM rows as one float4 each along k and the 4 k-rows of
// its columns as float4s: 22 vector loads for 448 FMAs at 14 x 8 (5.1 FMAs
// per float). Slices of BK = 32 (16 at C <= 32) along Q pass through a
// 3-stage ring of shared memory filled by cp.async, so the loads of slice
// k + 2 overlap the FMAs of slice k, with one barrier per slice. The patch
// slice is staged row-major: cp.async copies 16 bytes as they are, so a
// transposed stage would need a trip through registers, and reading rows
// along k costs the same floats per FMA. Lanes 2i and 2i + 1 read the same
// weights and a half-warp reads two patch rows, so each of those loads
// takes two shared-memory wavefronts, not four. Rows of 16-byte multiples
// (Q % 4 == 0, conv2) are copied 16 bytes at a time; others (conv1's
// Q = 25, 100-byte rows) 4 bytes at a time. Columns past BN are tiled over
// the grid.
// A block owns BR rows: with the pool, whole image row-pairs (the largest
// multiple of 2W that fits in BM, or 2W itself in passes of BM rows when
// 2W > BM), so no pool window straddles two blocks. The epilogue adds the
// bias and writes y (and relu(y) without the pool); with the pool, after a
// block barrier it max-pools relu of the block's own y rows (re-read from
// L1/L2) into out.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STAGES = 3;    // slices in flight
constexpr int NT = 256;      // threads: 32 row groups x 8 column groups

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes; with valid == false it writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

// TM x TN: the thread tile; BK: the slice depth; VEC: 16-byte patch rows.
template <int TM, int TN, int BK, bool VEC>
__global__ void __launch_bounds__(NT, TM == 8 ? 2 : 1)
conv_fused_kernel(const float* __restrict__ pat, const float* __restrict__ w,
                  const float* __restrict__ bias, float* y,
                  float* __restrict__ out, int R, int Q, int C, int W, int BR,
                  int pool) {
  constexpr int BM = NT / 8 * TM;  // rows of one tile
  constexpr int BN = 8 * TN;       // columns of one tile
  constexpr int NJ = TN / 4;       // float4 column groups per thread
  static_assert((BM * BK) % (4 * NT) == 0,
                "every thread copies as many 16-byte patch chunks");
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                          // STAGES x BM x BK
  float* Ws = smem + STAGES * BM * BK;       // STAGES x BK x BN

  const int g = blockIdx.z;
  const int c0 = blockIdx.y * BN;
  const int row0 = blockIdx.x * BR;
  const int rend = min(row0 + BR, R);
  pat += (size_t)g * R * Q;
  w += (size_t)g * Q * C;
  bias += (size_t)g * C;
  y += (size_t)g * R * C;
  out += (size_t)g * (pool ? R / 4 : R) * C;

  // column group tx (lane bits 1-3): columns tx·4 + 32j; row group ty
  // (lane bits 0 and 4, and the warp): rows ty·TM + i. Lanes 2i and 2i + 1
  // read the same weights and a half-warp reads two patch rows, so every
  // shared load of the inner loop takes two wavefronts.
  const int lane = threadIdx.x & 31;
  const int tx = (lane >> 1) & 7;
  const int ty = 4 * (threadIdx.x >> 5) + (lane & 1) + 2 * (lane >> 4);
  const int nk = (Q + BK - 1) / BK;

  float4 bv[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = c0 + tx * 4 + 32 * j;
    bv[j] = col < C ? *reinterpret_cast<const float4*>(&bias[col])
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int p0 = row0; p0 < rend; p0 += BM) {
    const int pend = min(p0 + BM, rend);

    auto load_stage = [&](int s, int kt) {
      const int k0 = kt * BK;
      float* as = As + s * BM * BK;
      float* ws = Ws + s * BK * BN;
      if (VEC) {
#pragma unroll
        for (int n = 0; n < BM * BK / 4 / NT; ++n) {
          const int e = threadIdx.x + n * NT;
          const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
          const int row = p0 + r, k = k0 + c;
          const bool ok = row < pend && k < Q;
          cp_async16(as + r * BK + c, ok ? pat + (size_t)row * Q + k : pat,
                     ok);
        }
      } else {
#pragma unroll 4
        for (int n = 0; n < BM * BK / NT; ++n) {
          const int e = threadIdx.x + n * NT;
          const int r = e / BK, c = e % BK;
          const int row = p0 + r, k = k0 + c;
          const bool ok = row < pend && k < Q;
          cp_async4(as + r * BK + c, ok ? pat + (size_t)row * Q + k : pat,
                    ok);
        }
      }
      for (int e = threadIdx.x; e < BK * BN / 4; e += NT) {
        const int kk = e / (BN / 4), c = (e % (BN / 4)) * 4;
        const int k = k0 + kk, col = c0 + c;
        const bool ok = k < Q && col < C;
        cp_async16(ws + kk * BN + c, ok ? w + (size_t)k * C + col : w, ok);
      }
    };

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load_stage(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();   // slice kt landed; slice kt - 1's stage is free
      const int nt = kt + STAGES - 1;
      if (nt < nk) load_stage(nt % STAGES, nt);
      cp_async_commit();

      const float* as = As + (kt % STAGES) * BM * BK + ty * TM * BK;
      const float* ws = Ws + (kt % STAGES) * BK * BN + tx * 4;
#pragma unroll
      for (int k4 = 0; k4 < BK; k4 += 4) {
        float4 b[4][NJ];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            b[kk][j] = *reinterpret_cast<const float4*>(
                ws + (k4 + kk) * BN + 32 * j);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 a =
              *reinterpret_cast<const float4*>(as + i * BK + k4);
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              float* o = &acc[i][4 * j];
              o[0] = fmaf(av[kk], b[kk][j].x, o[0]);
              o[1] = fmaf(av[kk], b[kk][j].y, o[1]);
              o[2] = fmaf(av[kk], b[kk][j].z, o[2]);
              o[3] = fmaf(av[kk], b[kk][j].w, o[3]);
            }
        }
      }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = p0 + ty * TM + i;
      if (row >= pend) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = c0 + tx * 4 + 32 * j;
        if (col >= C) continue;
        const float4 v = make_float4(
            acc[i][4 * j] + bv[j].x, acc[i][4 * j + 1] + bv[j].y,
            acc[i][4 * j + 2] + bv[j].z, acc[i][4 * j + 3] + bv[j].w);
        *reinterpret_cast<float4*>(&y[(size_t)row * C + col]) = v;
        if (!pool)
          *reinterpret_cast<float4*>(&out[(size_t)row * C + col]) =
              make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f),
                          fmaxf(v.w, 0.f));
      }
    }
    // the next pass refills the stages; the pool reads every thread's y
    __syncthreads();
  }
  if (!pool) return;

  // 2x2 max-pool of relu(y): rows are (image, h, w) and the block holds
  // whole row-pairs, so window (lp, w2) reads rows
  // row0 + lp·2W + 2·w2 + {0, 1, W, W+1}.
  const int half = W / 2;
  const int nwin = (rend - row0) / 4;
  for (int e = threadIdx.x; e < nwin * (BN / 4); e += NT) {
    const int pr = e / (BN / 4), col = c0 + (e % (BN / 4)) * 4;
    if (col >= C) continue;
    const int lp = pr / half, w2 = pr % half;
    const size_t src = (size_t)row0 + lp * 2 * W + 2 * w2;
    const float4 a = *reinterpret_cast<const float4*>(&y[src * C + col]);
    const float4 b =
        *reinterpret_cast<const float4*>(&y[(src + 1) * C + col]);
    const float4 c =
        *reinterpret_cast<const float4*>(&y[(src + W) * C + col]);
    const float4 d =
        *reinterpret_cast<const float4*>(&y[(src + W + 1) * C + col]);
    const float4 m = max4(max4(a, b), max4(c, d));
    *reinterpret_cast<float4*>(&out[((size_t)row0 / 4 + pr) * C + col]) =
        make_float4(fmaxf(m.x, 0.f), fmaxf(m.y, 0.f), fmaxf(m.z, 0.f),
                    fmaxf(m.w, 0.f));
  }
}

template <int TM, int TN, int BK, bool VEC>
int launch(const float* pat, const float* w, const float* b, float* y,
           float* out, int G, int R, int Q, int C, int W, int pool,
           cudaStream_t stream) {
  constexpr int BM = NT / 8 * TM, BN = 8 * TN;
  const int smem = (int)sizeof(float) * STAGES * (BM * BK + BK * BN);
  cudaError_t err = cudaFuncSetAttribute(
      conv_fused_kernel<TM, TN, BK, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // rows per block: whole image row-pairs with the pool
  int br = BM;
  if (pool) br = 2 * W <= BM ? BM / (2 * W) * (2 * W) : 2 * W;
  const dim3 grid((R + br - 1) / br, (C + BN - 1) / BN, G);
  conv_fused_kernel<TM, TN, BK, VEC><<<grid, NT, smem, stream>>>(
      pat, w, b, y, out, R, Q, C, W, br, pool);
  return (int)cudaGetLastError();
}

}  // namespace

// patches (G, R, Q), w (G, Q, C), b (G, C) -> y (G, R, C) and out
// (G, R/4, C) with pool, (G, R, C) without. C % 4 == 0; w, b, y and out on
// 16-byte boundaries. With pool: W even and R a multiple of 2W.
extern "C" int conv_fused_f32(const void* pat, const void* w, const void* b,
                              void* y, void* out, int G, int R, int Q, int C,
                              int W, int pool, void* stream) {
  if (G < 1 || G > 65535 || R < 1 || Q < 1 || C < 4 || C % 4 ||
      (pool && (W < 2 || W % 2 || R % (2 * W))))
    return (int)cudaErrorInvalidValue;
  const bool vec = Q % 4 == 0 && (uintptr_t)pat % 16 == 0;
  const float *p = (const float*)pat, *wp = (const float*)w,
              *bp = (const float*)b;
  float *yp = (float*)y, *op = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (C <= 32)
    return vec ? launch<8, 4, 16, true>(p, wp, bp, yp, op, G, R, Q, C, W,
                                        pool, s)
               : launch<8, 4, 16, false>(p, wp, bp, yp, op, G, R, Q, C, W,
                                         pool, s);
  return vec ? launch<14, 8, 32, true>(p, wp, bp, yp, op, G, R, Q, C, W, pool,
                                       s)
             : launch<14, 8, 32, false>(p, wp, bp, yp, op, G, R, Q, C, W,
                                        pool, s);
}
