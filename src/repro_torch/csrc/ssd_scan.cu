// Mamba2 chunked SSD scan (arXiv:2405.21060, the state-space dual form),
// zero initial state, output y only.
//
// Replaces src/repro/kernels/ssd_scan/kernel.py:ssd_scan_kernel
// (_ssd_kernel). Same result: for each batch b, head h and chunk of Q steps,
// with a = dt * A[h] and cum its inclusive cumsum over the chunk,
//   y_i   = exp(cum_i) * (C_i . S) + sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j)
//           * dt_j x_j                                    (inter + intra)
//   S'    = exp(cum_last) S + sum_j exp(cum_last - cum_j) B_j (dt_j x_j)^T
// where S is the (N, P) state carried from a zero start across the chunks.
// The causal mask is applied before exp: above the diagonal the segment
// sum is set to -inf (exp(cum_i - cum_j) would overflow there, and inf * 0
// is NaN), so the masked entries are G * 0, as the JAX package's
// G * exp(segsum) gives them.
//
// What bounds it: operations. At mamba2-780m's prefill shape (Bt, S, H, P,
// N, Q) = (4, 2048, 48, 64, 128, 128) every form of the scan does at least
// C S and the state update, 4NP FLOP per (token, head): ~12.9 GFLOP of f32
// FMAs (0.19 ms at the 67 TFLOP/s FP32 peak; the 64-row blocks below add
// the causal triangles, ~14.6 GFLOP in all) for ~0.2 GB of input and
// output (0.06 ms at HBM's rate). f32 on the tensor cores is TF32, which the
// port's f32 parity rules out, so the kernels do f32 FMAs on the CUDA
// cores. The kernels walk each chunk of Q steps as blocks of at most 64
// (the first 64 rows, then the rest): the state carried from block to
// block makes that the same function up to rounding, and a 64-row block
// halves C B^T and the masked product per step and keeps a CTA's shared
// memory near 77 KB (N = 128), so two CTAs share an SM and hide each
// other's load latency. Two launches on the caller's stream:
//  1. ssd_gram, one CTA per (batch, block): G = C B^T over the block, on
//     the causal triangle, into a (Bt, blocks, 64, 64) scratch buffer. G
//     does not depend on the head (one B and C for all heads), so the
//     heads share it instead of recomputing it; the buffer (4 MB at
//     mamba2's shape) stays in L2 for the scan.
//  2. ssd_scan_fwd, one CTA of 256 threads per (batch, head, 32 columns of
//     P): the sequential chunk axis of the Pallas grid becomes a loop
//     inside the CTA, which keeps its (N, 32) slice of the state in shared
//     memory for the whole sequence (the columns of y and S are
//     independent, so splitting P gives 384 CTAs at mamba2's shape). Per
//     block it stages x * dt (64 x 32) and the warp-scanned cumsum, builds
//     G o L in shared memory, then streams C and B * exp(cum_last - cum)
//     through shared memory in slices of 64 state rows: each slice adds
//     C_s S_s to the thread's register tile of y (rows ty + 32 r, 4
//     columns) and then updates the slice's state rows (2 rows x 4 columns
//     per thread), which no later slice of the block reads. Last it adds
//     (G o L)(x * dt). Each thread issues all its global loads of a stage
//     before its first shared store, so the loads are in flight together.
// A block shorter than 64 rows is padded with zero rows: dt = 0 keeps the
// cumsum flat, and B = C = x = 0 add nothing.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int QT = 64;            // rows per block of a chunk
constexpr int kPB = 32;           // columns of P per scan CTA
constexpr int kNS = 64;           // state rows per staged slice (scan)
constexpr int kLS = kNS + 4;      // row stride of the scan's B and C slices
constexpr int kGS = 32;           // columns of B and C per slice (gram)
constexpr int kLG = kGS + 4;      // row stride of the gram's slices
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block can use

__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
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

// Block k of a sequence cut into chunks of Q: its first step and length.
__device__ __forceinline__ void block_span(int k, int Q, int& t0, int& q) {
  const int per = (Q + QT - 1) / QT, sub = k % per * QT;
  t0 = k / per * Q + sub;
  q = min(QT, Q - sub);
}

// G[b, k] = C_k B_k^T for j <= i, 0 above the diagonal. A thread owns rows
// ty + 16 r and columns tx + 16 c of the 64 x 64 tile.
__global__ void __launch_bounds__(kThreads)
ssd_gram(const float* __restrict__ B, const float* __restrict__ C,
         float* __restrict__ G, int N, int Q, int nblk, long long bsb,
         long long bss, long long csb, long long css) {
  constexpr int GR = QT / 16;
  __shared__ float4 smem4[2 * QT * kLG / 4];
  float* s_B = reinterpret_cast<float*>(smem4);
  float* s_C = s_B + QT * kLG;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / nblk;
  int t0, q;
  block_span(blockIdx.x % nblk, Q, t0, q);
  const float* Bb = B + b * bsb + t0 * bss;
  const float* Cb = C + b * csb + t0 * css;

  float g[GR][GR];
#pragma unroll
  for (int r = 0; r < GR; ++r)
#pragma unroll
    for (int c = 0; c < GR; ++c) g[r][c] = 0.f;
  for (int n0 = 0; n0 < N; n0 += kGS) {
    __syncthreads();
    {
      constexpr int R = QT * kGS / kThreads;
      const int k = tid & (kGS - 1);
      const bool kok = n0 + k < N;
      float bv[R], cv[R];
#pragma unroll
      for (int it = 0; it < R; ++it) {
        const int j = (tid + it * kThreads) / kGS;
        bv[it] = kok && j < q ? Bb[j * bss + n0 + k] : 0.f;
        cv[it] = kok && j < q ? Cb[j * css + n0 + k] : 0.f;
      }
#pragma unroll
      for (int it = 0; it < R; ++it) {
        const int j = (tid + it * kThreads) / kGS;
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
      for (int c = 0; c < GR; ++c) {
        const float4 bv = ld4(s_B + (tx + 16 * c) * kLG + k);
#pragma unroll
        for (int r = 0; r < GR; ++r) g[r][c] = dot4(cv[r], bv, g[r][c]);
      }
    }
  }
  float* Gb = G + (long long)blockIdx.x * QT * QT;
#pragma unroll
  for (int r = 0; r < GR; ++r)
#pragma unroll
    for (int c = 0; c < GR; ++c) {
      const int i = ty + 16 * r, j = tx + 16 * c;
      Gb[i * QT + j] = j <= i ? g[r][c] : 0.f;
    }
}

constexpr int scan_smem_floats(int npad) {
  return QT * kPB + QT * (QT + 4) + 2 * QT * kLS + 3 * QT + npad * kPB;
}

// The scan of one (batch, head, 32 columns of P). A thread owns rows
// ty + 32 r (r < 2) and columns 4 tx .. 4 tx + 3 of y.
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_fwd(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const float* __restrict__ B,
             const float* __restrict__ C, const float* __restrict__ G,
             float* __restrict__ y, int H, int S, int P, int N, int Q,
             int nblk, long long xsb, long long xss, long long xsh, long long dsb,
             long long dss, long long dsh, long long bsb, long long bss,
             long long csb, long long css) {
  constexpr int RR = QT / 32;     // y rows per thread
  constexpr int LM = QT + 4;      // row stride of G o L
  constexpr int E = QT / 32;      // cumsum elements per lane of warp 0
  const int npad = (N + kNS - 1) / kNS * kNS;
  extern __shared__ float4 smem4[];
  float* s_xd = reinterpret_cast<float*>(smem4);   // QT x kPB: x * dt
  float* s_M = s_xd + QT * kPB;                    // QT x LM: G o L
  float* s_B = s_M + QT * LM;                      // QT x kLS: B * w
  float* s_C = s_B + QT * kLS;                     // QT x kLS: C
  float* s_cum = s_C + QT * kLS;                   // QT: cumsum of dt * A
  float* s_w = s_cum + QT;                         // QT: exp(cum_last - cum)
  float* s_dt = s_w + QT;                          // QT
  float* s_st = s_dt + QT;                         // npad x kPB: the state

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int nb = P / kPB;
  const int b = blockIdx.x / (H * nb), h = blockIdx.x / nb % H;
  const int p0 = blockIdx.x % nb * kPB;
  const float Ah = A[h];
  const float* xb = x + b * xsb + h * xsh + p0;
  const float* db = dt + b * dsb + h * dsh;
  const float* Bb = B + b * bsb;
  const float* Cb = C + b * csb;
  const float* Gb = G + (long long)b * nblk * QT * QT;
  float* yb = y + (long long)b * S * H * P + (long long)h * P + p0;

  for (int i = tid; i < npad * kPB; i += kThreads) s_st[i] = 0.f;

  for (int blk = 0; blk < nblk; ++blk) {
    int t0, q;
    block_span(blk, Q, t0, q);
    __syncthreads();              // the last block's readers are done
    if (tid < QT) {
      const float d = tid < q ? db[(t0 + tid) * dss] : 0.f;
      s_dt[tid] = d;
      s_cum[tid] = d * Ah;
    }
    __syncthreads();
    if (tid < 32) {               // inclusive cumsum of a over the block
      float v[E], run = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        run += s_cum[tid * E + e];
        v[e] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, tot, off);
        if (tid >= off) tot += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, tot, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) s_cum[tid * E + e] = excl + v[e];
    }
    {
      constexpr int R = QT * kPB / kThreads;
      float v[R];
#pragma unroll
      for (int it = 0; it < R; ++it) {
        const int i = (tid + it * kThreads) / kPB;
        v[it] = i < q ? xb[(t0 + i) * xss + (tid & (kPB - 1))] : 0.f;
      }
#pragma unroll
      for (int it = 0; it < R; ++it) {
        const int idx = tid + it * kThreads;
        s_xd[idx] = v[it] * s_dt[idx / kPB];
      }
    }
    __syncthreads();
    const float cum_last = s_cum[QT - 1];
    if (tid < QT) s_w[tid] = expf(cum_last - s_cum[tid]);

    // G o L, masked before exp
    {
      constexpr int R = QT * QT / 4 / kThreads;
      const float* Gc = Gb + (long long)blk * QT * QT;
      float4 gv[R];
#pragma unroll
      for (int it = 0; it < R; ++it)
        gv[it] = ld4(Gc + 4 * (tid + it * kThreads));
#pragma unroll
      for (int it = 0; it < R; ++it) {
        const int idx = tid + it * kThreads;
        const int i = idx / (QT / 4), j = idx % (QT / 4) * 4;
        const float ci = s_cum[i];
        const float4 g = gv[it];
        float4 m;
        m.x = g.x * expf(j <= i ? ci - s_cum[j] : -INFINITY);
        m.y = g.y * expf(j + 1 <= i ? ci - s_cum[j + 1] : -INFINITY);
        m.z = g.z * expf(j + 2 <= i ? ci - s_cum[j + 2] : -INFINITY);
        m.w = g.w * expf(j + 3 <= i ? ci - s_cum[j + 3] : -INFINITY);
        *reinterpret_cast<float4*>(s_M + i * LM + j) = m;
      }
    }

    float4 acc[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int n0 = 0; n0 < N; n0 += kNS) {
      __syncthreads();            // s_w and s_M are written; the last
                                  // slice is read
      {
        constexpr int R = QT * kNS / kThreads;
        const int k = tid & (kNS - 1);
        const bool kok = n0 + k < N;
        float bv[R], cv[R];
#pragma unroll
        for (int it = 0; it < R; ++it) {
          const int j = (tid + it * kThreads) / kNS;
          const bool ok = kok && j < q;
          bv[it] = ok ? Bb[(t0 + j) * bss + n0 + k] : 0.f;
          cv[it] = ok ? Cb[(t0 + j) * css + n0 + k] : 0.f;
        }
#pragma unroll
        for (int it = 0; it < R; ++it) {
          const int j = (tid + it * kThreads) / kNS;
          s_B[j * kLS + k] = bv[it] * s_w[j];
          s_C[j * kLS + k] = cv[it];
        }
      }
      __syncthreads();

      // acc += C_s S[n0 : n0 + kNS]
#pragma unroll 4
      for (int k = 0; k < kNS; k += 4) {
        float4 cv[RR];
#pragma unroll
        for (int r = 0; r < RR; ++r)
          cv[r] = ld4(s_C + (ty + 32 * r) * kLS + k);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 sv = ld4(s_st + (n0 + k + e) * kPB + 4 * tx);
#pragma unroll
          for (int r = 0; r < RR; ++r) fma4(acc[r], at(cv[r], e), sv);
        }
      }
      __syncthreads();            // the slice's old state rows are read

      // S[n0 + k] = exp(cum_last) S[n0 + k] + sum_j (B_jk w_j) xd_j, for
      // the thread's rows k = 2 ty, 2 ty + 1
      float4 st0 = make_float4(0.f, 0.f, 0.f, 0.f), st1 = st0;
#pragma unroll 8
      for (int j = 0; j < QT; ++j) {
        const float2 bw = *reinterpret_cast<const float2*>(
            s_B + j * kLS + 2 * ty);
        const float4 xv = ld4(s_xd + j * kPB + 4 * tx);
        fma4(st0, bw.x, xv);
        fma4(st1, bw.y, xv);
      }
      const float decay = expf(cum_last);
      float4* sp = reinterpret_cast<float4*>(s_st + (n0 + 2 * ty) * kPB
                                             + 4 * tx);
      float4 s0 = sp[0], s1 = sp[kPB / 4];
      sp[0] = make_float4(fmaf(s0.x, decay, st0.x), fmaf(s0.y, decay, st0.y),
                          fmaf(s0.z, decay, st0.z), fmaf(s0.w, decay, st0.w));
      sp[kPB / 4] = make_float4(
          fmaf(s1.x, decay, st1.x), fmaf(s1.y, decay, st1.y),
          fmaf(s1.z, decay, st1.z), fmaf(s1.w, decay, st1.w));
    }

    // y = exp(cum_i) (C S) + (G o L)(x * dt)
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      const float e = expf(s_cum[ty + 32 * r]);
      acc[r].x *= e;
      acc[r].y *= e;
      acc[r].z *= e;
      acc[r].w *= e;
    }
#pragma unroll 2
    for (int j = 0; j < QT; j += 4) {
      float4 mv[RR];
#pragma unroll
      for (int r = 0; r < RR; ++r) mv[r] = ld4(s_M + (ty + 32 * r) * LM + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 xv = ld4(s_xd + (j + e) * kPB + 4 * tx);
#pragma unroll
        for (int r = 0; r < RR; ++r) fma4(acc[r], at(mv[r], e), xv);
      }
    }
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      const int i = ty + 32 * r;
      if (i < q)
        *reinterpret_cast<float4*>(yb + (long long)(t0 + i) * H * P
                                   + 4 * tx) = acc[r];
    }
  }
}

int launch(const float* x, const float* dt, const float* A, const float* B,
           const float* C, float* G, float* y, int Bt, int S, int H, int P,
           int N, int Q, const long long* st, cudaStream_t stream) {
  const int nblk = S / Q * ((Q + QT - 1) / QT);
  const int npad = (N + kNS - 1) / kNS * kNS;
  const int smem = (int)sizeof(float) * scan_smem_floats(npad);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  ssd_gram<<<Bt * nblk, kThreads, 0, stream>>>(B, C, G, N, Q, nblk, st[6],
                                               st[7], st[8], st[9]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      ssd_scan_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_fwd<<<Bt * H * (P / kPB), kThreads, smem, stream>>>(
      x, dt, A, B, C, G, y, H, S, P, N, Q, nblk, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9]);
  return (int)cudaGetLastError();
}

}  // namespace

// x (Bt, S, H, P) with unit stride in P and strides (xsb, xss, xsh); dt
// (Bt, S, H) with strides (dsb, dss, dsh); A (H,) contiguous; B and C
// (Bt, S, N) with unit stride in N and strides (bsb, bss), (csb, css); G a
// 16-byte aligned scratch buffer of Bt * (S / Q) * ceil(Q / 64) * 64 * 64
// floats; y a contiguous (Bt, S, H, P), 16-byte aligned. Strides in
// elements. Q in [1, 128] divides S; P a multiple of 32; N <= 256.
extern "C" int ssd_scan_f32(const float* x, const float* dt, const float* A,
                            const float* B, const float* C, float* G,
                            float* y, int Bt, int S, int H, int P, int N,
                            int Q, long long xsb, long long xss,
                            long long xsh, long long dsb, long long dss,
                            long long dsh, long long bsb, long long bss,
                            long long csb, long long css, void* stream) {
  if (Bt < 1 || S < 1 || H < 1 || N < 1 || N > 256 || Q < 1 || Q > 128 ||
      S % Q || P < kPB || P % kPB ||
      (long long)Bt * H * (P / kPB) > 2147483647LL ||
      (long long)Bt * (S / Q) * 2 > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long st[10] = {xsb, xss, xsh, dsb, dss, dsh, bsb, bss, csb, css};
  return launch(x, dt, A, B, C, G, y, Bt, S, H, P, N, Q, st,
                (cudaStream_t)stream);
}
