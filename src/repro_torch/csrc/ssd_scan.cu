// Mamba2 chunked SSD scan (arXiv:2405.21060, the state-space dual form),
// zero initial state, output y only.
//
// Replaces src/repro/kernels/ssd_scan/kernel.py:ssd_scan_kernel
// (_ssd_kernel). Same result: for each batch b, head h and chunk c of Q
// steps, with a = dt * A[h] and cum its inclusive cumsum over the chunk,
//   y_i = exp(cum_i) * (C_i . S_{c-1}) + sum_{j<=i} (C_i . B_j)
//         exp(cum_i - cum_j) dt_j x_j                     (inter + intra)
//   S_c = exp(cum_last) S_{c-1} + s_c,
//   s_c = sum_j exp(cum_last - cum_j) B_j (dt_j x_j)^T
// where S_c is the (N, P) state after chunk c (S_{-1} = 0). The causal mask
// is applied before exp: above the diagonal the entry is set to 0 and exp
// is never taken (exp(cum_i - cum_j) would overflow there, and inf * 0 is
// NaN), as the JAX package's G * exp(segsum) gives 0.
//
// What bounds it: operations. At mamba2-780m's prefill shape (Bt, S, H, P,
// N, Q) = (4, 2048, 48, 64, 128, 128) every form of the scan does at least
// C S and the state update, 4NP FLOP per (token, head): ~12.9 GFLOP of f32
// FMAs, 0.19 ms at the 67 TFLOP/s FP32 peak (the chunked form adds the
// causal triangle, ~15.4 GFLOP in all), for ~0.2 GB of input and output.
// f32 on the tensor cores is TF32, which the port's f32 parity rules out,
// so the kernels do f32 FMAs on the CUDA cores.
//
// Design: the chunk axis, which the Pallas grid walks in order only because
// a TPU core must, is parallel here. Mamba2's own chunked algorithm splits
// the scan into three steps; two are products over independent (batch,
// chunk, head) items (3,072 at mamba2's shape, 3,584 at zamba2-7b's), and
// the third, which carries the state across chunks, is an elementwise pass
// bound by bytes. Four launches on the caller's stream:
//  1. ssd_gram, one CTA per (batch, chunk, 64 x 64 tile on or below the
//     diagonal): G = C B^T over the chunk into a (Bt, nc, 128, 128)
//     scratch buffer. G does not depend on the head, so the heads share it
//     (4 MB at mamba2's shape: it stays in L2).
//  2. ssd_chunk_state, one CTA per (batch, chunk < nc - 1, head, 64 or 128
//     rows of N, 32 or 64 columns of P): s_c = (B * u)^T x, an (N, P)
//     product of depth Q with u_j = exp(cum_last - cum_j) dt_j, into a
//     (Bt, nc, H, N, P) states buffer, and exp(cum_last) per (batch,
//     chunk, head). The last chunk's state feeds no output and is skipped.
//  3. ssd_state_pass, one thread per (batch, head, 4 state entries): walks
//     the chunks in order and overwrites slot c with S_{c-1}, so that
//     launch 4 of chunk c reads its own slot. Loads of 8 chunks are issued
//     before their dependent FMAs.
//  4. ssd_chunk_scan, one 128-thread CTA per (batch, chunk, head, 32 or 64
//     columns of P): y = [C | M] [S_{c-1} ; x], a product of depth N + Q,
//     with M = G o exp(segsum) dt (masked) and the rows of the C S_{c-1}
//     part scaled by exp(cum_i) before the M part is added. Chunk 0 skips
//     the C S part. A thread's rows are interleaved (ty + 16 r), so in M
//     slice s (zero on rows below 32 s) every thread skips its rows
//     r < 2 s and every warp does the same share of the causal triangle;
//     the skip is a block-uniform branch, so one copy of the FMA loop
//     serves every slice (five unrolled copies, one per row range, ran
//     1.5x slower on the card: the instruction cache).
// Launches 2 and 4 are the FLOPs. Each thread holds an 8 x 8 (8 x 4 at
// P = 32) register tile: per step of 4 in depth it reads 8 + 8 float4s for
// 256 FMAs, 4 FMAs per float read from shared memory. Lanes 2i and 2i + 1
// share their columns and a half-warp reads two row groups, as in
// conv_fused.cu; the rows of launch 4's first operand are XOR-swizzled by
// 16-byte chunk, so the two rows of a half-warp fall in different banks.
// Launch 4 holds 4 CTAs per SM at 128 registers (a few spilled: 3 CTAs
// without spills and launch 2 at 4 CTAs with spills were both slower on
// the card). Operands pass
// through two stages of shared memory, filled by 16-byte cp.async: the
// copies of slice t + 1 run while slice t is multiplied, with one barrier
// per slice. Where a slice needs a factor (u_j on x in launch 2, the mask,
// exp and dt_j that turn G into M in launch 4), the thread that copied a
// chunk applies it after its own copies land and before the barrier, so no
// second barrier is needed. The cumsum is recomputed in launches 2 and 4
// from dt (a warp scan of 128 values).
// A chunk shorter than 128 rows is padded with zero rows: dt = 0 keeps the
// cumsum flat, and B = C = x = 0 add nothing.
//
// Scratch: the states buffer is written by launch 2, read and written by
// launch 3 and read by launch 4: four passes over (Bt, nc, H, N, P) f32
// (100.7 MB at mamba2's shape, ~0.12 ms at HBM's rate).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QR = 128;           // rows of a chunk, padded
constexpr int BK = 32;            // depth of one staged slice
constexpr int kScanThreads = 128; // launch 4: 16 row groups x 8 column groups
constexpr int kScanBlocks = 4;    // launch 4: CTAs per SM (128 registers)
constexpr int kGT = 64;           // gram tile
constexpr int kGThreads = 256;
constexpr int kGS = 32;           // columns of B and C per gram slice
constexpr int kLG = kGS + 4;      // row stride of the gram's slices
constexpr int kPassThreads = 256;
constexpr int kPassUnroll = 8;    // chunks whose loads are in flight at once
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block can use

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 bytes; with valid == false it writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The thread's column group (lane bits 1-3) and row group (lane bits 0 and
// 4, and the warp): lanes 2i and 2i + 1 share their columns, a half-warp
// reads two row groups.
__device__ __forceinline__ int col_group() { return (threadIdx.x >> 1) & 7; }
__device__ __forceinline__ int row_group() {
  const int lane = threadIdx.x & 31;
  return 4 * (threadIdx.x >> 5) + (lane & 1) + 2 * (lane >> 4);
}

// s_dt[i] = dt_i and s_cum[i] = the inclusive cumsum of dt_i * A over the
// chunk's QR rows (rows past q: dt = 0). Ends with a block barrier.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ db,
                                             long long dss, int q, float Ah,
                                             float* s_dt, float* s_cum) {
  constexpr int E = QR / 32;
  for (int i = threadIdx.x; i < QR; i += blockDim.x) {
    const float d = i < q ? db[i * dss] : 0.f;
    s_dt[i] = d;
    s_cum[i] = d * Ah;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int l = threadIdx.x;
    float v[E], run = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      run += s_cum[l * E + e];
      v[e] = run;
    }
    float tot = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, tot, off);
      if (l >= off) tot += t;
    }
    float excl = __shfl_up_sync(0xffffffffu, tot, 1);
    if (l == 0) excl = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) s_cum[l * E + e] = excl + v[e];
  }
  __syncthreads();
}

// Launch 1. G[b, c] (QR x QR, row-major) = C B^T over chunk c, the 64 x 64
// tile blockIdx.y of (0, 0), (1, 0), (1, 1). A thread owns rows ty + 16 r
// and columns tx + 16 c' of the tile. Rows and columns past Q are 0.
__global__ void __launch_bounds__(kGThreads)
ssd_gram(const float* __restrict__ B, const float* __restrict__ C,
         float* __restrict__ G, int N, int Q, int nc, long long bsb,
         long long bss, long long csb, long long css) {
  constexpr int GR = kGT / 16;
  __shared__ float4 smem4[2 * kGT * kLG / 4];
  float* s_B = reinterpret_cast<float*>(smem4);
  float* s_C = s_B + kGT * kLG;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / nc, c = blockIdx.x % nc;
  const int i0 = blockIdx.y == 0 ? 0 : kGT, j0 = blockIdx.y == 2 ? kGT : 0;
  const int qi = Q - i0, qj = Q - j0;
  const float* Bb = B + b * bsb + ((long long)c * Q + j0) * bss;
  const float* Cb = C + b * csb + ((long long)c * Q + i0) * css;

  float g[GR][GR];
#pragma unroll
  for (int r = 0; r < GR; ++r)
#pragma unroll
    for (int k = 0; k < GR; ++k) g[r][k] = 0.f;
  for (int n0 = 0; n0 < N; n0 += kGS) {
    __syncthreads();
    {
      constexpr int R = kGT * kGS / kGThreads;
      const int k = tid & (kGS - 1);
      const bool kok = n0 + k < N;
      float bv[R], cv[R];
#pragma unroll
      for (int it = 0; it < R; ++it) {
        const int j = (tid + it * kGThreads) / kGS;
        bv[it] = kok && j < qj ? Bb[j * bss + n0 + k] : 0.f;
        cv[it] = kok && j < qi ? Cb[j * css + n0 + k] : 0.f;
      }
#pragma unroll
      for (int it = 0; it < R; ++it) {
        const int j = (tid + it * kGThreads) / kGS;
        s_B[j * kLG + k] = bv[it];
        s_C[j * kLG + k] = cv[it];
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < kGS; k += 4) {
      float4 cv[GR];
#pragma unroll
      for (int r = 0; r < GR; ++r) cv[r] = ld4(s_C + (ty + 16 * r) * kLG + k);
#pragma unroll
      for (int cc = 0; cc < GR; ++cc) {
        const float4 bv = ld4(s_B + (tx + 16 * cc) * kLG + k);
#pragma unroll
        for (int r = 0; r < GR; ++r) g[r][cc] = dot4(cv[r], bv, g[r][cc]);
      }
    }
  }
  float* Gb = G + (long long)blockIdx.x * QR * QR + (long long)i0 * QR + j0;
#pragma unroll
  for (int r = 0; r < GR; ++r)
#pragma unroll
    for (int cc = 0; cc < GR; ++cc)
      Gb[(ty + 16 * r) * QR + tx + 16 * cc] = g[r][cc];
}

constexpr int state_smem_floats(int RG, int NJ) {
  return 2 * BK * 8 * RG + 2 * BK * 32 * NJ + 3 * QR;
}

// Launch 2. s_c[n, p] = sum_j B[j, n] u_j x[j, p] for the CTA's 8 RG rows
// of N and 32 NJ columns of P; a thread owns rows 8 ty .. 8 ty + 7 and
// columns 4 tx + 32 qq. Writes slot (b, c, h) of the states buffer and, from
// one thread per (b, c, h), exp(cum_last) to decay.
template <int RG, int NJ>
__global__ void __launch_bounds__(8 * RG)
ssd_chunk_state(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ st, float* __restrict__ decay, int H,
                int P, int N, int Q, int nc, long long xsb, long long xss,
                long long xsh, long long dsb, long long dss, long long dsh,
                long long bsb, long long bss) {
  constexpr int NT = 8 * RG, NR = 8 * RG, PT = 32 * NJ;
  constexpr int AS = BK * NR, BS = BK * PT;   // floats of one stage
  constexpr int ACH = AS / 4 / NT, BCH = BS / 4 / NT;  // chunks per thread
  extern __shared__ __align__(16) float smem[];
  float* s_a = smem;              // 2 x BK x NR: B rows
  float* s_b = s_a + 2 * AS;      // 2 x BK x PT: x rows, times u once landed
  float* s_dt = s_b + 2 * BS;
  float* s_cum = s_dt + QR;
  float* s_u = s_cum + QR;

  const int tid = threadIdx.x, tx = col_group(), ty = row_group();
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int c = bc % (nc - 1), b = bc / (nc - 1);
  const int n0 = blockIdx.y * NR, p0 = blockIdx.z * PT;
  const long long t0 = (long long)c * Q;
  const float* xb = x + b * xsb + t0 * xss + h * xsh + p0;
  const float* Bb = B + b * bsb + t0 * bss + n0;
  const int nsl = (Q + BK - 1) / BK;

  auto load = [&](int sl) {
    const int j0 = sl * BK;
    float* a = s_a + (sl & 1) * AS;
    float* bx = s_b + (sl & 1) * BS;
#pragma unroll
    for (int it = 0; it < ACH; ++it) {
      const int e = tid + it * NT;
      const int r = e / (NR / 4), ch = e % (NR / 4);
      const bool ok = j0 + r < Q && n0 + 4 * ch < N;
      cp_async16(a + r * NR + 4 * ch, ok ? Bb + (j0 + r) * bss + 4 * ch : B,
                 ok);
    }
#pragma unroll
    for (int it = 0; it < BCH; ++it) {
      const int e = tid + it * NT;
      const int r = e / (PT / 4), ch = e % (PT / 4);
      const bool ok = j0 + r < Q;
      cp_async16(bx + r * PT + 4 * ch, ok ? xb + (j0 + r) * xss + 4 * ch : x,
                 ok);
    }
  };

  float4 acc[8][NJ];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int qq = 0; qq < NJ; ++qq) acc[r][qq] = make_float4(0.f, 0.f, 0.f, 0.f);

  load(0);
  cp_async_commit();
  chunk_cumsum(dt + b * dsb + t0 * dss + h * dsh, dss, Q, A[h], s_dt, s_cum);
  const float cum_last = s_cum[QR - 1];
  for (int i = tid; i < QR; i += NT) s_u[i] = expf(cum_last - s_cum[i]) * s_dt[i];
  __syncthreads();

  for (int sl = 0; sl < nsl; ++sl) {
    cp_async_wait_all();
    {                             // scale the x rows this thread copied
      float* bx = s_b + (sl & 1) * BS;
#pragma unroll
      for (int it = 0; it < BCH; ++it) {
        const int e = tid + it * NT;
        const int r = e / (PT / 4), ch = e % (PT / 4);
        float4* v = reinterpret_cast<float4*>(bx + r * PT + 4 * ch);
        const float u = s_u[sl * BK + r];
        float4 w = *v;
        w.x *= u;
        w.y *= u;
        w.z *= u;
        w.w *= u;
        *v = w;
      }
    }
    __syncthreads();              // slice sl is ready; sl - 1's stage free
    if (sl + 1 < nsl) load(sl + 1);
    cp_async_commit();
    const float* a = s_a + (sl & 1) * AS + 8 * ty;
    const float* bx = s_b + (sl & 1) * BS + 4 * tx;
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 a0 = ld4(a + j * NR), a1 = ld4(a + j * NR + 4);
      float4 bv[NJ];
#pragma unroll
      for (int qq = 0; qq < NJ; ++qq) bv[qq] = ld4(bx + j * PT + 32 * qq);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int qq = 0; qq < NJ; ++qq) {
          fma4(acc[r][qq], at(a0, r), bv[qq]);
          fma4(acc[r + 4][qq], at(a1, r), bv[qq]);
        }
    }
  }

  float* sb = st + (((long long)b * nc + c) * H + h) * N * P + p0 + 4 * tx;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = n0 + 8 * ty + r;
    if (n < N)
#pragma unroll
      for (int qq = 0; qq < NJ; ++qq)
        *reinterpret_cast<float4*>(sb + (long long)n * P + 32 * qq) =
            acc[r][qq];
  }
  if (blockIdx.y == 0 && blockIdx.z == 0 && tid == 0)
    decay[((long long)b * nc + c) * H + h] = expf(cum_last);
}

// Launch 3. For every (batch, head) and float4 e of the (N, P) state: slot
// c <- S_{c-1} for c >= 1, with S_0 = s_0 and S_c = decay_c S_{c-1} + s_c.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass(float* __restrict__ st, const float* __restrict__ decay,
               int H, int nc, long long np4) {
  const long long e = (long long)blockIdx.y * kPassThreads + threadIdx.x;
  if (e >= np4) return;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long step = (long long)H * np4;   // float4s between chunks
  float4* p = reinterpret_cast<float4*>(st) + ((long long)b * nc * H + h) * np4
              + e;
  const float* d = decay + (long long)b * nc * H + h;
  float4 S = p[0];
  for (int c0 = 1; c0 < nc; c0 += kPassUnroll) {
    float4 s[kPassUnroll];
    float dc[kPassUnroll];
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      const int c = c0 + u;
      const bool more = c < nc - 1;   // the last chunk's state is not needed
      s[u] = more ? p[c * step] : make_float4(0.f, 0.f, 0.f, 0.f);
      dc[u] = more ? d[(long long)c * H] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        p[c * step] = S;
        S = make_float4(fmaf(dc[u], S.x, s[u].x), fmaf(dc[u], S.y, s[u].y),
                        fmaf(dc[u], S.z, s[u].z), fmaf(dc[u], S.w, s[u].w));
      }
    }
  }
}

constexpr int scan_smem_floats(int NJ) {
  return 2 * QR * BK + 2 * BK * 32 * NJ + 3 * QR;
}
static_assert(4 * scan_smem_floats(2) * kScanBlocks <= kMaxSmem,
              "the scan's CTAs share an SM");
static_assert(4 * state_smem_floats(16, 2) <= kMaxSmem, "stages fit");

// The FMAs of one staged slice for the thread's rows r0 .. 7 (rows
// ty + 16 r): acc[r] += a[row r] . b, 4 deep at a time. a points at the
// thread's row ty of the stage, b at its columns; sw is the row's swizzle.
// r0 is block-uniform, so the skipped rows cost a branch each, and one
// copy of the loop serves every slice.
template <int NJ>
__device__ __forceinline__ void slice_fma(float4 (&acc)[8][NJ],
                                          const float* a, const float* b,
                                          int sw, int r0) {
  constexpr int PT = 32 * NJ;
#pragma unroll 2
  for (int k4 = 0; k4 < BK / 4; ++k4) {
    float4 bv[4][NJ];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int qq = 0; qq < NJ; ++qq)
        bv[kk][qq] = ld4(b + (4 * k4 + kk) * PT + 32 * qq);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r < r0) continue;
      const float4 av = ld4(a + 16 * r * BK + 4 * (k4 ^ sw));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int qq = 0; qq < NJ; ++qq)
          fma4(acc[r][qq], at(av, kk), bv[kk][qq]);
    }
  }
}

// Launch 4. y rows 0..Q-1 of chunk c, head h, columns p0 .. p0 + 32 NJ: a
// thread owns rows ty + 16 r (r < 8) and columns 4 tx + 32 qq. Slices
// 0 .. nS-1 are (C, S_{c-1}) along N, then up to four (M, x) along the
// chunk. Each thread whose copies land turns its chunks of G into M =
// G o exp(cum_i - cum_j) dt_j (0 where j > i: masked before exp) before
// the slice's barrier. M slice s (columns 32 s ..) is 0 on rows below
// 32 s, so every thread skips its rows r < 2 s there, and every warp does
// the same share of the causal triangle. The first operand's 16-byte chunk ch of row i sits at
// chunk ch ^ (i & 7) of the row (rows ty and ty + 1, read by one half-warp,
// fall in different banks).
template <int NJ>
__global__ void __launch_bounds__(kScanThreads, kScanBlocks)
ssd_chunk_scan(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ C,
               const float* __restrict__ G, const float* __restrict__ st,
               float* __restrict__ y, int H, int S, int P, int N, int Q,
               int nc, long long xsb, long long xss, long long xsh,
               long long dsb, long long dss, long long dsh, long long csb,
               long long css) {
  constexpr int NT = kScanThreads, PT = 32 * NJ;
  constexpr int AS = QR * BK, BS = BK * PT;
  constexpr int ACH = AS / 4 / NT, BCH = BS / 4 / NT;
  extern __shared__ __align__(16) float smem[];
  float* s_a = smem;              // 2 x QR x BK: C, or G then M
  float* s_b = s_a + 2 * AS;      // 2 x BK x PT: S_{c-1} or x
  float* s_dt = s_b + 2 * BS;
  float* s_cum = s_dt + QR;
  float* s_f = s_cum + QR;

  const int tid = threadIdx.x, tx = col_group(), ty = row_group();
  const int sw = ty & 7;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int c = bc % nc, b = bc / nc;
  const int p0 = blockIdx.y * PT;
  const long long t0 = (long long)c * Q;
  const float* xb = x + b * xsb + t0 * xss + h * xsh + p0;
  const float* Cb = C + b * csb + t0 * css;
  const float* Gb = G + (long long)bc * QR * QR;
  const float* Sb = st + ((long long)bc * H + h) * N * P + p0;
  const int nS = c > 0 ? (N + BK - 1) / BK : 0;
  const int nM = (Q + BK - 1) / BK;

  auto load = [&](int sl) {
    float* a = s_a + (sl & 1) * AS;
    float* bb = s_b + (sl & 1) * BS;
    if (sl < nS) {
      const int k0 = sl * BK;
#pragma unroll
      for (int it = 0; it < ACH; ++it) {
        const int e = tid + it * NT, i = e >> 3, ch = e & 7;
        const bool ok = i < Q && k0 + 4 * ch < N;
        cp_async16(a + i * BK + 4 * (ch ^ (i & 7)),
                   ok ? Cb + i * css + k0 + 4 * ch : C, ok);
      }
#pragma unroll
      for (int it = 0; it < BCH; ++it) {
        const int e = tid + it * NT, r = e / (PT / 4), ch = e % (PT / 4);
        const bool ok = k0 + r < N;
        cp_async16(bb + r * PT + 4 * ch,
                   ok ? Sb + (long long)(k0 + r) * P + 4 * ch : st, ok);
      }
    } else {
      const int j0 = (sl - nS) * BK;
#pragma unroll
      for (int it = 0; it < ACH; ++it) {
        const int e = tid + it * NT, i = e >> 3, ch = e & 7;
        // rows above the slice are never read
        const bool ok = i < Q && j0 + 4 * ch < Q;
        if (i >= j0)
          cp_async16(a + i * BK + 4 * (ch ^ (i & 7)),
                     ok ? Gb + i * QR + j0 + 4 * ch : G, ok);
      }
#pragma unroll
      for (int it = 0; it < BCH; ++it) {
        const int e = tid + it * NT, r = e / (PT / 4), ch = e % (PT / 4);
        const bool ok = j0 + r < Q;
        cp_async16(bb + r * PT + 4 * ch, ok ? xb + (j0 + r) * xss + 4 * ch : x,
                   ok);
      }
    }
  };

  float4 acc[8][NJ];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int qq = 0; qq < NJ; ++qq) acc[r][qq] = make_float4(0.f, 0.f, 0.f, 0.f);

  load(0);
  cp_async_commit();
  chunk_cumsum(dt + b * dsb + t0 * dss + h * dsh, dss, Q, A[h], s_dt, s_cum);
  // exp(cum_i - cum_j) = exp(cum_i - cum_l) exp(cum_l - cum_j) for l the
  // last column of j's slice and i >= l: both exponents <= 0, so neither
  // factor overflows; s_f holds the second times dt_j
  for (int j = tid; j < QR; j += NT)
    s_f[j] = expf(s_cum[j | (BK - 1)] - s_cum[j]) * s_dt[j];
  __syncthreads();

  const int nsl = nS + nM;
  for (int sl = 0; sl < nsl; ++sl) {
    float* a = s_a + (sl & 1) * AS;
    const bool is_m = sl >= nS;
    const int j0 = (sl - nS) * BK;
    cp_async_wait_all();
    if (is_m) {                   // G -> M on the chunks this thread copied
      const int jl = j0 + BK - 1;   // the slice's last column
      const float cl = s_cum[jl];
#pragma unroll
      for (int it = 0; it < ACH; ++it) {
        const int e = tid + it * NT, i = e >> 3, ch = e & 7;
        if (i < j0) continue;
        float4* v = reinterpret_cast<float4*>(a + i * BK + 4 * (ch ^ (i & 7)));
        const float4 g = *v;
        const int j = j0 + 4 * ch;
        const float ci = s_cum[i];
        float4 m;
        if (i >= jl) {              // below the diagonal block: no mask
          const float ei = i < Q ? expf(ci - cl) : 0.f;
          const float4 f = ld4(s_f + j);
          m = make_float4(g.x * ei * f.x, g.y * ei * f.y, g.z * ei * f.z,
                          g.w * ei * f.w);
        } else {
          const float4 cj = ld4(s_cum + j), dj = ld4(s_dt + j);
          m.x = j <= i ? g.x * expf(ci - cj.x) * dj.x : 0.f;
          m.y = j + 1 <= i ? g.y * expf(ci - cj.y) * dj.y : 0.f;
          m.z = j + 2 <= i ? g.z * expf(ci - cj.z) * dj.z : 0.f;
          m.w = j + 3 <= i ? g.w * expf(ci - cj.w) * dj.w : 0.f;
        }
        *v = m;
      }
    }
    __syncthreads();              // slice sl is ready; sl - 1's stage free
    if (sl + 1 < nsl) load(sl + 1);
    cp_async_commit();
    if (sl == nS && nS > 0) {     // the C S_{c-1} part is complete
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float e = expf(s_cum[ty + 16 * r]);
#pragma unroll
        for (int qq = 0; qq < NJ; ++qq) {
          acc[r][qq].x *= e;
          acc[r][qq].y *= e;
          acc[r][qq].z *= e;
          acc[r][qq].w *= e;
        }
      }
    }
    // M slice s is 0 on rows below 32 s: the thread's rows r < 2 s
    slice_fma<NJ>(acc, a + ty * BK, s_b + (sl & 1) * BS + 4 * tx, sw,
                  is_m ? 2 * (sl - nS) : 0);
  }

  float* yb = y + ((long long)b * S + t0) * H * P + (long long)h * P + p0 +
              4 * tx;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
    if (i < Q)
#pragma unroll
      for (int qq = 0; qq < NJ; ++qq)
        *reinterpret_cast<float4*>(yb + (long long)i * H * P + 32 * qq) =
            acc[r][qq];
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int RG, int NJ>
cudaError_t launch_state(const float* x, const float* dt, const float* A,
                         const float* B, float* st, float* decay, int Bt,
                         int H, int P, int N, int Q, int nc,
                         const long long* s, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * state_smem_floats(RG, NJ);
  cudaError_t err = allow_smem(ssd_chunk_state<RG, NJ>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(Bt * (nc - 1) * H),
                  (unsigned)((N + 8 * RG - 1) / (8 * RG)),
                  (unsigned)(P / (32 * NJ)));
  ssd_chunk_state<RG, NJ><<<grid, 8 * RG, smem, stream>>>(
      x, dt, A, B, st, decay, H, P, N, Q, nc, s[0], s[1], s[2], s[3], s[4],
      s[5], s[6], s[7]);
  return cudaGetLastError();
}

template <int NJ>
cudaError_t launch_scan(const float* x, const float* dt, const float* A,
                        const float* C, const float* G, const float* st,
                        float* y, int Bt, int S, int H, int P, int N, int Q,
                        int nc, const long long* s, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * scan_smem_floats(NJ);
  cudaError_t err = allow_smem(ssd_chunk_scan<NJ>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(Bt * nc * H), (unsigned)(P / (32 * NJ)));
  ssd_chunk_scan<NJ><<<grid, kScanThreads, smem, stream>>>(
      x, dt, A, C, G, st, y, H, S, P, N, Q, nc, s[0], s[1], s[2], s[3], s[4],
      s[5], s[8], s[9]);
  return cudaGetLastError();
}

}  // namespace

// x (Bt, S, H, P) and B, C (Bt, S, N): unit stride in the last axis, other
// strides multiples of 4 elements, 16-byte aligned; dt (Bt, S, H) any
// strides; A (H,) contiguous. Strides in elements: (xsb, xss, xsh), (dsb,
// dss, dsh), (bsb, bss), (csb, css). Q in [1, 128] divides S; P a multiple
// of 32; N a multiple of 4, at most 256. Scratch, 16-byte aligned: G of
// Bt * (S / Q) * 128 * 128 floats, st of Bt * (S / Q) * H * N * P, decay of
// Bt * (S / Q) * H. y a contiguous (Bt, S, H, P). parts: bit i runs launch
// i + 1 (15: the scan; one bit alone times that launch on its own).
extern "C" int ssd_scan_f32(const float* x, const float* dt, const float* A,
                            const float* B, const float* C, float* G,
                            float* st, float* decay, float* y, int Bt, int S,
                            int H, int P, int N, int Q, int parts,
                            long long xsb, long long xss, long long xsh,
                            long long dsb, long long dss, long long dsh,
                            long long bsb, long long bss, long long csb,
                            long long css, void* stream) {
  if (Bt < 1 || S < 1 || H < 1 || N < 4 || N > 256 || N % 4 || Q < 1 ||
      Q > QR || S % Q || P < 32 || P % 32 ||
      (long long)Bt * S / Q * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream_ = (cudaStream_t)stream;
  const long long s[10] = {xsb, xss, xsh, dsb, dss, dsh, bsb, bss, csb, css};
  const int nc = S / Q;
  const bool wide = P % 64 == 0;  // 8 x 8 thread tiles, else 8 x 4
  cudaError_t err = cudaSuccess;
  if (parts & 1) {
    ssd_gram<<<dim3((unsigned)(Bt * nc), Q > kGT ? 3 : 1), kGThreads, 0,
               stream_>>>(B, C, G, N, Q, nc, bsb, bss, csb, css);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if ((parts & 2) && nc > 1) {
    if (N > 64)
      err = wide ? launch_state<16, 2>(x, dt, A, B, st, decay, Bt, H, P, N,
                                       Q, nc, s, stream_)
                 : launch_state<16, 1>(x, dt, A, B, st, decay, Bt, H, P, N,
                                       Q, nc, s, stream_);
    else
      err = wide ? launch_state<8, 2>(x, dt, A, B, st, decay, Bt, H, P, N, Q,
                                      nc, s, stream_)
                 : launch_state<8, 1>(x, dt, A, B, st, decay, Bt, H, P, N, Q,
                                      nc, s, stream_);
    if (err != cudaSuccess) return (int)err;
  }
  if ((parts & 4) && nc > 1) {
    const long long np4 = (long long)N * P / 4;
    ssd_state_pass<<<dim3((unsigned)(Bt * H),
                          (unsigned)((np4 + kPassThreads - 1) / kPassThreads)),
                     kPassThreads, 0, stream_>>>(st, decay, H, nc, np4);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 8) {
    err = wide ? launch_scan<2>(x, dt, A, C, G, st, y, Bt, S, H, P, N, Q, nc,
                                s, stream_)
               : launch_scan<1>(x, dt, A, C, G, st, y, Bt, S, H, P, N, Q, nc,
                                s, stream_);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
