// Backward of the Mamba2 chunked SSD scan of csrc/ssd_scan.cu (zero
// initial state, y only): dx, ddt, dA, dB and dC from dy.
//
// Replaces no TPU kernel. The JAX package trains Mamba2 through the jnp
// ssd_chunked (src/repro/models/ssm.py:57) and lets XLA derive its VJP; the
// port runs the forward as the ssd_scan kernel, and this file is that
// kernel's gradient (port-only, like int8_quant.cu and corrupt_rows.cu).
//
// The math. For batch b, head h, chunk c of Q rows (i, j index rows), with
// cum the inclusive cumsum of a = dt * A[h] over the chunk, xd_j = dt_j x_j
// and S_c the (N, P) state after chunk c (S_{-1} = 0), the forward is
//   y_i = e^{cum_i} C_i S_{c-1} + sum_{j<=i} (C_i . B_j) e^{cum_i - cum_j} xd_j
//   S_c = e^{cum_last} S_{c-1} + sum_j e^{cum_last - cum_j} B_j xd_j^T.
// Let G_c = dL/dS_c. The last chunk's state feeds nothing (G_{nc-1} = 0) and
//   G_{c-1} = e^{cum_last(c)} G_c + R_c,  R_c = sum_{i in c} e^{cum_i} C_i dy_i^T,
// the forward's state pass run in reverse. Then per chunk
//   dxd_j = sum_{i>=j} (C_i . B_j) e^{cum_i - cum_j} dy_i + e^{cum_last - cum_j} G_c^T B_j
//   dx_j  = dt_j dxd_j
//   dC_i  = sum_h [e^{cum_i} S_{c-1} dy_i + sum_{j<=i} E_ij B_j]
//   dB_j  = sum_h [e^{cum_last - cum_j} G_c xd_j] + sum_{i>=j} E_ij C_i
// with E_ij = sum_h e^{cum_i - cum_j} (dy_i . xd_j) (B and C are shared by
// the heads, so the head sums are taken before the products with them).
// Every exponent's gradient collects into one per-row scalar. With T_ij =
// (C_i . B_j) e^{cum_i - cum_j} (dy_i . xd_j) for j < i (the causal term;
// the diagonal j = i cancels out of dcum exactly and is left out),
// V_i = dy_i . e^{cum_i} C_i S_{c-1} (y_i's inter part) and W_j = xd_j .
// dxd'_j (dxd' is dxd's state part),
//   dcum_i = sum_{j<i} T_ij - sum_{k>i} T_ki + V_i - W_i
//            + [i = Q - 1] (e^{cum_last} tr(G_c^T S_{c-1}) + sum_j W_j);
// da = the reverse cumsum of dcum over the chunk, ddt_i = x_i . dxd_i +
// A[h] da_i and dA[h] = sum dt da. The terms cancel in da's suffix sums
// (a T_ij with i, j >= t is in both sums), and f32 loses what cancels:
// the f32 plain version's gradient is off its float64 value by up to
// ~1e-4 of the largest at mamba2's and zamba2's shapes. So: every
// exponent is the f32 difference of an f64 cumsum (cum_i - cum_j, a small
// difference of large sums, keeps its digits); each T_ij is formed once
// in f32, and both its row's and its column's sums are taken from it in
// f64 (launch 1), so that the pairs that cancel cancel exactly; the W
// rows enter da as an exclusive prefix sum, not as a total minus a
// suffix; dcum, da and dA's shares are f64 (launch 6).
// The causal mask is applied before exp, as in the forward: an entry above
// the diagonal is 0 and its exponent is never taken.
//
// What bounds it: operations. Per (token, head) at N = 128, P = 64, Q =
// 128: R (2NP), the state part of dxd (2NP), y's inter part (2NP), the
// inter parts of dC and dB (2NP each), the causal part of dxd and E
// (about QP each): ~100 kFLOP of f32 FMAs, against ~66 kFLOP for the
// forward (the floor every form needs, 8NP, is 12.9 GFLOP at mamba2's
// training microbatch, 0.19 ms at the 67 TFLOP/s FP32 peak); f32 on the
// tensor cores is TF32, which the port's f32 parity rules out.
//
// Design: simple and right first. Seven launches on the caller's stream,
// each a grid of 64 x 64 output tiles (256 threads, a 4 x 4 register tile
// each: rows ty + 16 r, columns tx + 16 c) over a depth staged 16 at a
// time through shared memory by plain loads, one barrier on each side of
// a slice; the operands are read through small lambdas that apply the
// decays and the causal mask while they stage. The chunk cumsum of a head
// is recomputed in each launch that needs it (a block scan of 128 values,
// in f64).
//  1. ssd_bwd_gram, one CTA per (batch, chunk, 64 x 64 tile on or below the
//     diagonal): G = C B^T (depth N) and E (depth P, over the heads in
//     order), each into a (Bt, nc, 128, 128) scratch, and per head the
//     tile's share of each row's and each column's sum of T.
//  2. ssd_bwd_dstate, one CTA per (batch, chunk >= 1, head, N tile, P
//     tile): R_c, into slot c - 1 of a (Bt, nc, H, N, P) buffer, and
//     e^{cum_last(c)} per (batch, chunk, head).
//  3. ssd_bwd_dpass, one thread per (batch, head, 4 state entries): walks
//     the chunks in reverse and overwrites slot c with G_c; per chunk, each
//     CTA's share of tr(G_c^T S_{c-1}) (slot c of the forward's states
//     buffer) reduced in a fixed order into a partials buffer.
//  4. ssd_bwd_dxd, one CTA per (batch, chunk, head, 64 rows, 64 columns of
//     P): dxd (depth Q - j0, then N for its state part), dx = dt dxd, and
//     y's inter part (depth N); each row's x . dxd, x . dxd' and dy .
//     y_inter (V) over the CTA's columns into partials buffers.
//  5. ssd_bwd_dbc, one CTA per (batch, chunk, 64 rows, 64 columns of N,
//     dC or dB): the inter part (depth H P, the heads in order) and the
//     intra part (depth Q).
//  6. ssd_bwd_dt, one 128-thread CTA per (batch, chunk, head): dcum, the
//     reverse and the prefix scans, ddt and the chunk's share of dA.
//  7. ssd_bwd_da, one thread per head: dA, the shares summed over batch and
//     chunk in order.
// Every sum is taken in a fixed order (no atomics): two runs give the same
// bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QR = 128;           // rows of a chunk, padded
constexpr int T = 64;             // output tile
constexpr int KS = 16;            // depth of one staged slice
constexpr int NTH = 256;          // threads of a tile CTA (16 x 16)
constexpr int LDS = T + 4;        // row stride of a staged slice
constexpr int kDtThreads = QR;    // launch 6
constexpr int kPassThreads = 256; // launch 3

struct Stage {
  float a[KS][LDS];               // a[k][r]: first operand, row r
  float b[KS][LDS];               // b[k][c]: second operand, column c
};

// acc[r][c] += sum_{k0 <= k < k1} fa(ty + 16 r, k) fb(k, tx + 16 c) for the
// thread's 4 x 4 entries of a 64 x 64 tile. fa(r, k) and fb(k, c) return 0
// where the operand has no entry. Starts with a barrier, so the caller may
// reuse shared memory read by the previous call's loads.
template <class FA, class FB>
__device__ __forceinline__ void tile_mma(float (&acc)[4][4], Stage& s,
                                         int k0, int k1, FA fa, FB fb) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int kb = k0; kb < k1; kb += KS) {
    __syncthreads();
    for (int e = tid; e < KS * T; e += NTH) {
      const int ka = e % KS, r = e / KS;      // first operand: depth fastest
      s.a[ka][r] = kb + ka < k1 ? fa(r, kb + ka) : 0.f;
      const int kk = e / T, c = e % T;        // second: columns fastest
      s.b[kk][c] = kb + kk < k1 ? fb(kb + kk, c) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KS; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = s.a[k][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = s.b[k][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// s_dt[i] = dt_i and s_cum[i] = the inclusive cumsum of the f32 products
// dt_i * Ah over the chunk's QR rows (rows past q: dt = 0), by a block scan
// in f64; every thread of the block calls it. Starts and ends with a
// barrier. The sums are f64 so that an exponent cum_i - cum_j, a small
// difference of two large sums (|cum| reaches 10^4 at A = -112), keeps its
// f32 digits: the derivative of the forward's function, not of its
// rounding.
__device__ __forceinline__ void chunk_cum(const float* __restrict__ db,
                                          long long dss, int q, float Ah,
                                          float* s_dt, double* s_cum) {
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid < QR) {
    const float d = tid < q ? db[tid * dss] : 0.f;
    s_dt[tid] = d;
    s_cum[tid] = (double)(d * Ah);
  }
  __syncthreads();
  for (int off = 1; off < QR; off <<= 1) {
    const double v = tid < QR && tid >= off ? s_cum[tid - off] : 0.;
    __syncthreads();
    if (tid < QR) s_cum[tid] += v;
    __syncthreads();
  }
}

// e^{u - v} of two cumsum entries, the difference taken in f64.
__device__ __forceinline__ float exp_diff(double u, double v) {
  return expf((float)(u - v));
}

// The (row tile, column tile) of tile pair t: (0, 0), (1, 0), (1, 1).
__device__ __forceinline__ int pair_row(int t) { return t == 0 ? 0 : T; }
__device__ __forceinline__ int pair_col(int t) { return t == 2 ? T : 0; }

struct Strides {
  long long xsb, xss, xsh, dsb, dss, dsh, bsb, bss, csb, css;
};

// Launch 1. Tile pair blockIdx.y of chunk (b, c): gm = C B^T and
// eb = E (0 above the diagonal and past Q); per head, with T_ij = G_ij
// E^h_ij below the diagonal, trow[b, t, h, j0 / 64] = sum_j T_tj over the
// tile's columns and tcol[b, t, h, i0 / 64] = sum_i T_it over its rows.
__global__ void __launch_bounds__(NTH)
ssd_bwd_gram(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const float* __restrict__ B,
             const float* __restrict__ C, const float* __restrict__ dy,
             float* __restrict__ gm, float* __restrict__ eb,
             double* __restrict__ trow, double* __restrict__ tcol, int H,
             int S, int P, int N, int Q, int nc, Strides st) {
  __shared__ Stage s;
  __shared__ float s_dt[QR];
  __shared__ double s_cum[QR];
  __shared__ double part[2][T][17];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / nc, c = blockIdx.x % nc;
  const int i0 = pair_row(blockIdx.y), j0 = pair_col(blockIdx.y);
  const long long t0 = (long long)c * Q;
  const float* Cb = C + b * st.csb + t0 * st.css;
  const float* Bb = B + b * st.bsb + t0 * st.bss;
  float acc[4][4];
  zero(acc);
  tile_mma(acc, s, 0, N,
           [&](int r, int k) {
             return i0 + r < Q ? Cb[(i0 + r) * st.css + k] : 0.f;
           },
           [&](int k, int cc) {
             return j0 + cc < Q ? Bb[(j0 + cc) * st.bss + k] : 0.f;
           });
  float* out = gm + (long long)blockIdx.x * QR * QR;
  float g[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      g[r][cc] = acc[r][cc];
      out[(i0 + ty + 16 * r) * QR + j0 + tx + 16 * cc] = acc[r][cc];
    }

  // the partial slots: a row's by column tile, a column's by row tile;
  // tile pair (0, 0) zeroes its rows' second slot (no tile (0, 1)) and
  // pair (1, 1) its columns' first
  const int nt = Q > T ? 2 : 1;
  float e[4][4];
  zero(e);
  for (int h = 0; h < H; ++h) {
    chunk_cum(dt + b * st.dsb + t0 * st.dss + h * st.dsh, st.dss, Q, A[h],
              s_dt, s_cum);
    const float* dyb = dy + ((long long)b * S + t0) * H * P + (long long)h * P;
    const float* xb = x + b * st.xsb + t0 * st.xss + h * st.xsh;
    zero(acc);
    tile_mma(acc, s, 0, P,
             [&](int r, int k) {
               return i0 + r < Q ? dyb[(long long)(i0 + r) * H * P + k] : 0.f;
             },
             [&](int k, int cc) {
               const int j = j0 + cc;
               return j < Q ? s_dt[j] * xb[j * st.xss + k] : 0.f;
             });
    // E += the head's term; T_ij = G_ij E^h_ij (j < i) into its row's and
    // its column's sums, in f64
    double col[4] = {0., 0., 0., 0.};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      double row = 0.;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = j0 + tx + 16 * cc;
        if (j <= i && i < Q) {
          const float m = acc[r][cc] * exp_diff(s_cum[i], s_cum[j]);
          e[r][cc] += m;
          if (j < i) {
            const double t = (double)(g[r][cc] * m);
            row += t;
            col[cc] += t;
          }
        }
      }
      part[0][ty + 16 * r][tx] = row;
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) part[1][tx + 16 * cc][ty] = col[cc];
    __syncthreads();
    if (tid < 2 * T) {
      const int w = tid / T, k0 = tid % T;
      const int rc = (w == 0 ? i0 : j0) + k0;
      if (rc < Q) {
        double sum = 0.;
        for (int k = 0; k < 16; ++k) sum += part[w][k0][k];
        double* dst = (w == 0 ? trow : tcol) +
                      (((long long)b * S + t0 + rc) * H + h) * nt;
        dst[w == 0 ? j0 / T : i0 / T] = sum;
        if (nt == 2 && w == 0 && i0 == 0) dst[1] = 0.;
        if (nt == 2 && w == 1 && j0 == T) dst[0] = 0.;
      }
    }
  }
  out = eb + (long long)blockIdx.x * QR * QR;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      out[(i0 + ty + 16 * r) * QR + j0 + tx + 16 * cc] = e[r][cc];
}

// Launch 2. R_c for chunk c = 1 + (blockIdx.x / H) % (nc - 1), rows
// 64 blockIdx.y.. of N, columns 64 blockIdx.z.. of P, into slot c - 1 of
// gs; dec[b, c - 1, h] = e^{cum_last(c)}.
__global__ void __launch_bounds__(NTH)
ssd_bwd_dstate(const float* __restrict__ dt, const float* __restrict__ A,
               const float* __restrict__ C, const float* __restrict__ dy,
               float* __restrict__ gs, float* __restrict__ dec, int H, int S,
               int P, int N, int Q, int nc, Strides st) {
  __shared__ Stage s;
  __shared__ float s_dt[QR];
  __shared__ double s_cum[QR];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int c = 1 + bc % (nc - 1), b = bc / (nc - 1);
  const int n0 = blockIdx.y * T, p0 = blockIdx.z * T;
  const long long t0 = (long long)c * Q;
  chunk_cum(dt + b * st.dsb + t0 * st.dss + h * st.dsh, st.dss, Q, A[h], s_dt,
            s_cum);
  const float* Cb = C + b * st.csb + t0 * st.css;
  const float* dyb = dy + ((long long)b * S + t0) * H * P + (long long)h * P;
  float acc[4][4];
  zero(acc);
  tile_mma(acc, s, 0, Q,
           [&](int r, int k) {
             return n0 + r < N ? exp_diff(s_cum[k], 0.) * Cb[k * st.css + n0 + r]
                               : 0.f;
           },
           [&](int k, int cc) {
             return p0 + cc < P ? dyb[(long long)k * H * P + p0 + cc] : 0.f;
           });
  const long long slot = (((long long)b * nc + c - 1) * H + h) * N * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = n0 + ty + 16 * r;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int p = p0 + tx + 16 * cc;
      if (n < N && p < P) gs[slot + (long long)n * P + p] = acc[r][cc];
    }
  }
  if (blockIdx.y == 0 && blockIdx.z == 0 && tid == 0)
    dec[((long long)b * nc + c - 1) * H + h] = exp_diff(s_cum[Q - 1], 0.);
}

// Launch 3. For every (batch, head) and float4 e of the (N, P) state:
// G = 0, then for c = nc - 2 .. 0: G = dec[c] G + R_{c+1} (slot c), slot c
// <- G_c; trp[b, c, h, blockIdx.y] = this CTA's sum of G_c . S_{c-1} over
// its entries (slot c of the forward's states; 0 for c = 0).
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_dpass(float* __restrict__ gs, const float* __restrict__ states,
              const float* __restrict__ dec, float* __restrict__ trp, int H,
              int nc, long long np4) {
  __shared__ float red[kPassThreads];
  const int tid = threadIdx.x;
  const long long e = (long long)blockIdx.y * kPassThreads + tid;
  const bool own = e < np4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long step = (long long)H * np4;   // float4s between chunks
  const long long base = ((long long)b * nc * H + h) * np4 + e;
  float4* g = reinterpret_cast<float4*>(gs) + base;
  const float4* sv = reinterpret_cast<const float4*>(states) + base;
  const float* d = dec + (long long)b * nc * H + h;
  float4 G = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = nc - 2; c >= 0; --c) {
    float v = 0.f;
    if (own) {
      const float dc = d[(long long)c * H];
      const float4 r = g[c * step];
      G = make_float4(fmaf(dc, G.x, r.x), fmaf(dc, G.y, r.y),
                      fmaf(dc, G.z, r.z), fmaf(dc, G.w, r.w));
      g[c * step] = G;
      if (c > 0) {
        const float4 sc = sv[c * step];
        v = G.x * sc.x + G.y * sc.y + G.z * sc.z + G.w * sc.w;
      }
    }
    red[tid] = v;
    __syncthreads();
    for (int k = kPassThreads / 2; k > 0; k >>= 1) {
      if (tid < k) red[tid] += red[tid + k];
      __syncthreads();
    }
    if (tid == 0)
      trp[(((long long)b * nc + c) * H + h) * gridDim.y + blockIdx.y] = red[0];
    __syncthreads();
  }
}

// Launch 4. dxd rows 64 blockIdx.y.. of chunk c, head h, columns 64
// blockIdx.z.. of P: dx = dt dxd, and over the CTA's columns, for each row
// t: xdd = x_t . dxd_t, xin = x_t . dxd'_t (the state part) and yo = dy_t .
// y_inter_t, at [b, t, h, blockIdx.z].
__global__ void __launch_bounds__(NTH)
ssd_bwd_dxd(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const float* __restrict__ B,
            const float* __restrict__ C, const float* __restrict__ dy,
            const float* __restrict__ states, const float* __restrict__ gm,
            const float* __restrict__ gs, float* __restrict__ dx,
            float* __restrict__ xdd, float* __restrict__ xin,
            float* __restrict__ yo, int H, int S, int P, int N, int Q,
            int nc, Strides st) {
  __shared__ Stage s;
  __shared__ float s_dt[QR];
  __shared__ double s_cum[QR];
  __shared__ float part[3][T][17];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int c = bc % nc, b = bc / nc;
  const int j0 = blockIdx.y * T, p0 = blockIdx.z * T;
  const long long t0 = (long long)c * Q;
  chunk_cum(dt + b * st.dsb + t0 * st.dss + h * st.dsh, st.dss, Q, A[h], s_dt,
            s_cum);
  const double cl = s_cum[Q - 1];
  const float* g = gm + (long long)bc * QR * QR;
  const float* dyb = dy + ((long long)b * S + t0) * H * P + (long long)h * P;
  float acc[4][4];
  zero(acc);
  // the causal part: sum over i >= j of M_ij dy_i, M masked before exp
  tile_mma(acc, s, j0, Q,
           [&](int r, int i) {
             const int j = j0 + r;
             return i >= j && j < Q
                        ? g[i * QR + j] * exp_diff(s_cum[i], s_cum[j]) : 0.f;
           },
           [&](int i, int cc) {
             return p0 + cc < P ? dyb[(long long)i * H * P + p0 + cc] : 0.f;
           });
  float sa[4][4], yi[4][4];
  zero(sa);
  zero(yi);
  if (c < nc - 1) {               // the state part: e^{cl - cum_j} B_j G_c
    const float* Bb = B + b * st.bsb + t0 * st.bss;
    const float* gc = gs + ((long long)bc * H + h) * N * P;
    tile_mma(sa, s, 0, N,
             [&](int r, int n) {
               const int j = j0 + r;
               return j < Q ? exp_diff(cl, s_cum[j]) * Bb[j * st.bss + n] : 0.f;
             },
             [&](int n, int cc) {
               return p0 + cc < P ? gc[(long long)n * P + p0 + cc] : 0.f;
             });
  }
  if (c > 0) {                    // y's inter part: e^{cum_i} C_i S_{c-1}
    const float* Cb = C + b * st.csb + t0 * st.css;
    const float* sp = states + ((long long)bc * H + h) * N * P;
    tile_mma(yi, s, 0, N,
             [&](int r, int n) {
               const int i = j0 + r;
               return i < Q ? exp_diff(s_cum[i], 0.) * Cb[i * st.css + n] : 0.f;
             },
             [&](int n, int cc) {
               return p0 + cc < P ? sp[(long long)n * P + p0 + cc] : 0.f;
             });
  }
  const float* xb = x + b * st.xsb + t0 * st.xss + h * st.xsh;
  float* dxb = dx + ((long long)b * S + t0) * H * P + (long long)h * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty + 16 * r;
    float sx = 0.f, si = 0.f, sy = 0.f;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int p = p0 + tx + 16 * cc;
      if (j < Q && p < P) {
        const float d = acc[r][cc] + sa[r][cc];
        const float xv = xb[j * st.xss + p];
        dxb[(long long)j * H * P + p] = s_dt[j] * d;
        sx = fmaf(xv, d, sx);
        si = fmaf(xv, sa[r][cc], si);
        sy = fmaf(dyb[(long long)j * H * P + p], yi[r][cc], sy);
      }
    }
    part[0][ty + 16 * r][tx] = sx;
    part[1][ty + 16 * r][tx] = si;
    part[2][ty + 16 * r][tx] = sy;
  }
  __syncthreads();
  if (tid < 3 * T && j0 + tid % T < Q) {
    const int w = tid / T, row = tid % T;
    float sum = 0.f;
    for (int k = 0; k < 16; ++k) sum += part[w][row][k];
    float* dst = w == 0 ? xdd : w == 1 ? xin : yo;
    dst[(((long long)b * S + t0 + j0 + row) * H + h) * gridDim.z +
        blockIdx.z] = sum;
  }
}

// Launch 5. Rows 64 blockIdx.y.. of chunk (b, c), columns 64 (blockIdx.z /
// 2).. of N: dC (blockIdx.z even) or dB (odd).
__global__ void __launch_bounds__(NTH)
ssd_bwd_dbc(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const float* __restrict__ B,
            const float* __restrict__ C, const float* __restrict__ dy,
            const float* __restrict__ states, const float* __restrict__ eb,
            const float* __restrict__ gs, float* __restrict__ dB,
            float* __restrict__ dC, int H, int S, int P, int N, int Q, int nc,
            Strides st) {
  __shared__ Stage s;
  __shared__ float s_dt[QR];
  __shared__ double s_cum[QR];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / nc, c = blockIdx.x % nc;
  const int r0 = blockIdx.y * T, n0 = (blockIdx.z >> 1) * T;
  const bool is_b = blockIdx.z & 1;
  const long long t0 = (long long)c * Q;
  const float* e = eb + (long long)blockIdx.x * QR * QR;
  float acc[4][4];
  zero(acc);
  if (!is_b) {
    if (c > 0)                    // sum_h e^{cum_i} S_{c-1} dy_i
      for (int h = 0; h < H; ++h) {
        chunk_cum(dt + b * st.dsb + t0 * st.dss + h * st.dsh, st.dss, Q, A[h],
                  s_dt, s_cum);
        const float* dyb =
            dy + ((long long)b * S + t0) * H * P + (long long)h * P;
        const float* sp = states + ((long long)blockIdx.x * H + h) * N * P;
        tile_mma(acc, s, 0, P,
                 [&](int r, int p) {
                   const int i = r0 + r;
                   return i < Q ? exp_diff(s_cum[i], 0.) * dyb[(long long)i * H * P + p]
                                : 0.f;
                 },
                 [&](int p, int cc) {
                   return n0 + cc < N ? sp[(long long)(n0 + cc) * P + p] : 0.f;
                 });
      }
    const float* Bb = B + b * st.bsb + t0 * st.bss;
    tile_mma(acc, s, 0, min(Q, r0 + T),     // sum_{j<=i} E_ij B_j
             [&](int r, int j) {
               const int i = r0 + r;
               return j <= i && i < Q ? e[i * QR + j] : 0.f;
             },
             [&](int j, int cc) {
               return n0 + cc < N ? Bb[j * st.bss + n0 + cc] : 0.f;
             });
  } else {
    if (c < nc - 1)               // sum_h e^{cl - cum_j} G_c xd_j
      for (int h = 0; h < H; ++h) {
        chunk_cum(dt + b * st.dsb + t0 * st.dss + h * st.dsh, st.dss, Q, A[h],
                  s_dt, s_cum);
        const double cl = s_cum[Q - 1];
        const float* xb = x + b * st.xsb + t0 * st.xss + h * st.xsh;
        const float* gc = gs + ((long long)blockIdx.x * H + h) * N * P;
        tile_mma(acc, s, 0, P,
                 [&](int r, int p) {
                   const int j = r0 + r;
                   return j < Q ? exp_diff(cl, s_cum[j]) * s_dt[j] *
                                      xb[j * st.xss + p]
                                : 0.f;
                 },
                 [&](int p, int cc) {
                   return n0 + cc < N ? gc[(long long)(n0 + cc) * P + p] : 0.f;
                 });
      }
    const float* Cb = C + b * st.csb + t0 * st.css;
    tile_mma(acc, s, r0, Q,                 // sum_{i>=j} E_ij C_i
             [&](int r, int i) {
               const int j = r0 + r;
               return i >= j && j < Q ? e[i * QR + j] : 0.f;
             },
             [&](int i, int cc) {
               return n0 + cc < N ? Cb[i * st.css + n0 + cc] : 0.f;
             });
  }
  float* out = (is_b ? dB : dC) + ((long long)b * S + t0) * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = r0 + ty + 16 * r;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int n = n0 + tx + 16 * cc;
      if (i < Q && n < N) out[(long long)i * N + n] = acc[r][cc];
    }
  }
}

// Launch 6. Row i = threadIdx.x of chunk c, head h: dcum_i, da = its
// reverse cumsum, ddt_i = x_i . dxd_i + A[h] da_i, and dap[b, c, h] =
// sum_i dt_i da_i.
__global__ void __launch_bounds__(kDtThreads)
ssd_bwd_dt(const float* __restrict__ dt, const float* __restrict__ A,
           const double* __restrict__ trow, const double* __restrict__ tcol,
           const float* __restrict__ yo, const float* __restrict__ xdd,
           const float* __restrict__ xin, const float* __restrict__ trp,
           const float* __restrict__ dec, float* __restrict__ ddt,
           float* __restrict__ dap, int H, int S, int Q, int nc, int qtiles,
           int ptiles, int nblk, Strides st) {
  __shared__ double s[QR], sw[QR];
  const int i = threadIdx.x;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int c = bc % nc, b = bc / nc;
  const long long t = (long long)c * Q + i;
  const long long bth = ((long long)b * S + t) * H + h;
  const bool row = i < Q;
  float d = 0.f, xs = 0.f;
  double dcum = 0., w = 0.;
  if (row) {
    d = dt[b * st.dsb + t * st.dss + h * st.dsh];
    float xi = 0.f;
    for (int k = 0; k < qtiles; ++k)
      dcum += trow[bth * qtiles + k] - tcol[bth * qtiles + k];
    for (int k = 0; k < ptiles; ++k) {
      dcum += yo[bth * ptiles + k];
      xs += xdd[bth * ptiles + k];
      xi += xin[bth * ptiles + k];
    }
    w = (double)d * xi;
  }
  // The state terms: dcum_i has -xd_i . dxd'_i, and the last row the whole
  // state's decay e^{cum_last} tr(G_c^T S_{c-1}) + sum_j xd_j . dxd'_j. In
  // da_t = sum_{i>=t} dcum_i the state-part rows at or after t cancel, so
  // da_t = sum_{i>=t} (dcum_i without them) + e^{cum_last} tr + sum_{j<t}
  // xd_j . dxd'_j: a reverse and an exclusive prefix scan, no cancellation.
  if (i == Q - 1 && c > 0 && c < nc - 1) {
    const float* tp = trp + ((long long)bc * H + h) * nblk;
    double tr = 0.;
    for (int k = 0; k < nblk; ++k) tr += tp[k];
    dcum += (double)dec[((long long)bc - 1) * H + h] * tr;
  }
  s[i] = dcum;
  sw[i] = 0.;
  __syncthreads();
  if (i + 1 < QR) sw[i + 1] = w;
  __syncthreads();
  for (int off = 1; off < QR; off <<= 1) {
    const double v = i + off < QR ? s[i + off] : 0.;
    const double u = i >= off ? sw[i - off] : 0.;
    __syncthreads();
    s[i] += v;                    // sum_{t >= i} dcum_t
    sw[i] += u;                   // sum_{j < i} xd_j . dxd'_j
    __syncthreads();
  }
  const double da = s[i] + sw[i];
  if (row) ddt[((long long)b * S + t) * H + h] = (float)(xs + (double)A[h] * da);
  __syncthreads();
  s[i] = row ? (double)d * da : 0.;
  __syncthreads();
  for (int k = QR / 2; k > 0; k >>= 1) {
    if (i < k) s[i] += s[i + k];
    __syncthreads();
  }
  if (i == 0) dap[(long long)bc * H + h] = (float)s[0];
}

// Launch 7. dA[h] = sum over b, then c, of dap[b, c, h].
__global__ void ssd_bwd_da(const float* __restrict__ dap,
                           float* __restrict__ dA, int H, int n) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float sum = 0.f;
  for (int k = 0; k < n; ++k) sum += dap[(long long)k * H + h];
  dA[h] = sum;
}

}  // namespace

// The gradient of ssd_scan_f32 (csrc/ssd_scan.cu). x (Bt, S, H, P), B, C
// (Bt, S, N) with unit stride in the last axis, dt (Bt, S, H) any strides,
// as the forward took them (strides in elements: (xsb, xss, xsh), (dsb,
// dss, dsh), (bsb, bss), (csb, css)); A (H,); states the forward's states
// buffer after its run (slot c = S_{c-1}); dy contiguous (Bt, S, H, P). Q
// in [1, 128] divides S; P a multiple of 32; N a multiple of 4, at most
// 256. Outputs, contiguous: dx (Bt, S, H, P), ddt (Bt, S, H), dA (H), dB
// and dC (Bt, S, N). Scratch: gm and eb of Bt * nc * 128 * 128 floats, gs
// of Bt * nc * H * N * P (16-byte aligned), dec and dap of Bt * nc * H, trp
// of Bt * nc * H * ceil(N * P / 1024), trow and tcol of Bt * S * H *
// ceil(Q / 64) doubles, and xdd, xin, yo of Bt * S * H * ceil(P / 64)
// floats each.
extern "C" int ssd_scan_bwd_f32(
    const float* x, const float* dt, const float* A, const float* B,
    const float* C, const float* states, const float* dy, float* dx,
    float* ddt, float* dA, float* dB, float* dC, float* gm, float* eb,
    float* gs, float* dec, float* trp, double* trow, double* tcol,
    float* xdd, float* xin, float* yo, float* dap,
    int Bt, int S, int H, int P, int N, int Q, long long xsb, long long xss,
    long long xsh, long long dsb, long long dss, long long dsh, long long bsb,
    long long bss, long long csb, long long css, void* stream) {
  if (Bt < 1 || S < 1 || H < 1 || N < 4 || N > 256 || N % 4 || Q < 1 ||
      Q > QR || S % Q || P < 32 || P % 32 ||
      (long long)Bt * S / Q * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s_ = (cudaStream_t)stream;
  const Strides st = {xsb, xss, xsh, dsb, dss, dsh, bsb, bss, csb, css};
  const int nc = S / Q, ptiles = (P + T - 1) / T, qtiles = (Q + T - 1) / T;
  const long long np4 = (long long)N * P / 4;
  const int nblk = (int)((np4 + kPassThreads - 1) / kPassThreads);
  cudaError_t err;
  ssd_bwd_gram<<<dim3((unsigned)(Bt * nc), Q > T ? 3 : 1), NTH, 0, s_>>>(
      x, dt, A, B, C, dy, gm, eb, trow, tcol, H, S, P, N, Q, nc, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (nc > 1) {
    ssd_bwd_dstate<<<dim3((unsigned)(Bt * (nc - 1) * H), (N + T - 1) / T,
                          ptiles), NTH, 0, s_>>>(dt, A, C, dy, gs, dec, H, S,
                                                 P, N, Q, nc, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_dpass<<<dim3((unsigned)(Bt * H), (unsigned)nblk), kPassThreads, 0,
                    s_>>>(gs, states, dec, trp, H, nc, np4);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  ssd_bwd_dxd<<<dim3((unsigned)(Bt * nc * H), qtiles, ptiles), NTH, 0, s_>>>(
      x, dt, A, B, C, dy, states, gm, gs, dx, xdd, xin, yo, H, S, P, N, Q,
      nc, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_dbc<<<dim3((unsigned)(Bt * nc), qtiles, 2 * ((N + T - 1) / T)), NTH,
                0, s_>>>(x, dt, A, B, C, dy, states, eb, gs, dB, dC, H, S, P,
                         N, Q, nc, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_dt<<<(unsigned)(Bt * nc * H), kDtThreads, 0, s_>>>(
      dt, A, trow, tcol, yo, xdd, xin, trp, dec, ddt, dap, H, S, Q, nc,
      qtiles, ptiles, nblk, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_da<<<(H + 127) / 128, 128, 0, s_>>>(dap, dA, H, Bt * nc);
  return (int)cudaGetLastError();
}
