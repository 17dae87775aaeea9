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
// f64 (launch 2), so that the pairs that cancel cancel exactly; the W
// rows enter da as an exclusive prefix sum, not as a total minus a
// suffix; dcum, da and dA's shares are f64 (launch 8).
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
// Design. Every product runs on one machine: a 64-thread CTA owns a 64 x
// 64 output tile (64 x 32 in launch 2), each thread an 8 x 8 (8 x 4)
// register tile, rows ty + 8 r and columns 4 tx + 32 q + e, so that a
// quarter-warp reads 2 row groups and 4 column groups. The depth passes
// through two stages of shared memory in slices of 32, filled by 16-byte
// cp.async while the previous slice is multiplied, one barrier a slice
// (the forward's ssd_chunk_scan scheme): per step of 4 in depth a thread
// reads 8 + 8 float4s for 256 FMAs (32 + 8 loads where the first operand
// is staged depth-major). An operand is staged row-major in depth, rows
// XOR-swizzled by 16-byte chunk so that a quarter-warp's two row groups
// fall in different banks, or depth-major (float4s of 4 rows or columns),
// as its global layout gives it, so that every copy is 16 bytes. A factor
// that is constant along a product's depth scales the accumulator's rows
// or columns once (e^{cl - cum_j} on B G_c, e^{cum_i} on C S_{c-1}, dt_j
// on dy x^T); one that varies along it (e^{cum_i} on dy per row of R,
// e^{cum_i} or e^{cl - cum_j} dt_j per head in dB and dC, the masked
// e^{cum_i - cum_j} that turns C B^T into M) is applied by the thread that
// copied a chunk, after its own copies land and before the slice's
// barrier. Launch 1 writes the factor tables once: no launch runs a block
// scan, and only the causal entries read two f64 cumsums and subtract.
// Nine launches, ordered on the caller's stream (two of them on a side
// stream, below); what bounds each, and what the design does about it:
//  1. ssd_bwd_prep, one warp per (batch, chunk, head): the f64 inclusive
//     cumsum (a warp scan), e^{cum_i}, e^{cl - cum_j}, dt padded to 128
//     rows, and e^{cl}. Latency: one pass, every later launch reads it.
//  2. ssd_bwd_gram, one CTA per (batch, chunk, 64 x 32 tile on or below the
//     diagonal, group of heads): G = C B^T (depth N; the first group also
//     writes it transposed for launch 6), then per head D = dy x^T (depth
//     P) and, from each entry m = D dt_j e^{cum_i - cum_j} (masked), the
//     tile's share of E (the group's heads summed in order, into that
//     group's scratch) and T = G m's row and column sums in f64 (shuffle
//     trees; the two warps' column sums through shared memory). Bound by
//     the per-entry epilogue (an exp and two f64 conversions for 64 FMAs
//     of depth): the 64 x 32 tile keeps E, D and G (in shared memory) at
//     168 registers without spills, and the head groups make the grid
//     (576 CTAs at mamba2's microbatch, 192 with every head in one CTA).
//  3. ssd_bwd_dstate, one CTA per (batch, chunk >= 1, head, 64 rows of N, 64
//     columns of P): R_c = (e^{cum} C)^T dy, depth Q, into slot c - 1 of a
//     (Bt, nc, H, N, P) buffer. Operations; e^{cum_i} from shared memory.
//  4. ssd_bwd_yinter, one CTA per (batch, chunk >= 1, head, 64 rows, 64
//     columns of P): y's inter part e^{cum} C S_{c-1} (depth N) and each
//     row's dy . y_inter (V) over the CTA's columns. Operations.
//  5. ssd_bwd_pass, one thread per (batch, head, 4 state entries): walks the
//     chunks in reverse and overwrites slot c with G_c, the next chunk's
//     loads issued before the dependent FMAs; each warp's share of
//     tr(G_c^T S_{c-1}) (slot c of the forward's states) by a shuffle tree
//     into a partials buffer. Bytes: R read, G written, the states read,
//     ~150 MB at mamba2's microbatch.
//  6. ssd_bwd_dxd, one CTA per (batch, chunk, head, 64 rows, 64 columns of
//     P): dxd = e^{cl - cum_j} B G_c (depth N) + M^T dy (depth Q - j0, from
//     the transposed G), dx = dt dxd, and each row's x . dxd' and x . dxd
//     over the CTA's columns. Operations, and the causal entries' exps.
//  7. ssd_bwd_dbc, one CTA per (batch, chunk, 64 rows, 64 columns of N, dC or
//     dB, group of heads): the inter part as one product of depth (the
//     group's heads) x P, (e^{cum} dy) S_{c-1}^T for dC and (e^{cl - cum}
//     dt x) G_c^T for dB, the group's per-row factors staged in shared
//     memory, into a partials buffer. Operations; the head groups make the
//     grid (768 CTAs at mamba2's microbatch, 256 with every head in one).
//  8. ssd_bwd_dt, one 128-thread CTA per (batch, chunk, head): dcum, the
//     reverse and the prefix scans, ddt and the chunk's share of dA.
//     Latency.
//  9. ssd_bwd_intra, one CTA per dB / dC tile as in launch 7: the intra part
//     (depth Q: E B, E^T C), staging E as the sum of launch 2's groups in
//     order, plus launch 7's groups in order: dB and dC. Its grid's last
//     row sums dA over batch and chunk in order. Latency and bytes.
// Registers, not shared memory, set how many CTAs an SM holds; launches 6
// and 7 are held to 168 (six CTAs), where a few spilled registers cost less
// than the occupancy they buy. A full call runs launch 2 on a side stream
// beside launches 3-5 and launch 7 beside launch 6 (events fork from and
// join back to the caller's stream), so that the Gram launch's
// latency-bound epilogue overlaps work that keeps the FMA pipes busy.
// Every sum is taken in a fixed order (no atomics): two runs give the
// same bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int QR = 128;            // rows of a chunk, padded
constexpr int TL = 64;             // output tile of the product launches
constexpr int BK = 32;             // depth of one staged slice
constexpr int NT = 64;             // threads of a product CTA
constexpr int SL = TL * BK;        // floats of one operand's slice
constexpr int STAGES = 4 * SL;     // floats of both operands' two stages
constexpr int GW = 32;             // columns of a Gram launch tile
constexpr int kPrepThreads = 128;  // launch 1: a warp per (b, c, h)
constexpr int kPassThreads = 256;  // launch 5
constexpr int kPassWarps = kPassThreads / 32;
constexpr int kDtThreads = QR;     // launch 8
constexpr int kAllParts = 511;     // every launch: the backward

__device__ __align__(16) float kZero[4];  // source of zero-filled copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 bytes from src; zeros where src is null.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src ? src : kZero), "r"(src ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 splat(float f) {
  return make_float4(f, f, f, f);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The thread's row group (lane bits 0 and 4, and the warp) and column
// group (lane bits 1-3) of a 64 x 64 tile: rows ty + 8 r, columns
// col_of(tx, c) for r, c < 8.
__device__ __forceinline__ int row_group() {
  const int lane = threadIdx.x & 31;
  return 4 * (threadIdx.x >> 5) + (lane & 1) + 2 * (lane >> 4);
}
__device__ __forceinline__ int col_group() { return (threadIdx.x >> 1) & 7; }
__device__ __forceinline__ int col_of(int tx, int c) {
  return 4 * tx + 32 * (c >> 2) + (c & 3);
}

// Sum of v over the 8 threads of a row group (their column groups), in a
// fixed tree.
template <class V>
__device__ __forceinline__ V row_reduce(V v) {
#pragma unroll
  for (int m = 2; m <= 8; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// One operand's slice of W rows or columns (64, or GW for the Gram
// launch's second operand) in shared memory. Outer-major (OM): the 16-byte
// chunk ch of depth of row or column o at o * BK + 4 (ch ^ swizzle(o)); the
// first operand's rows are swizzled by o & 7 (rows ty and ty + 1 of a
// quarter-warp), the second's columns by (o >> 2) & 7 (columns 4 tx + e).
// Depth-major: 4 rows or columns of depth k at k * W + 4 ch. Chunk e of
// W * BK / 4 is thread e % NT's: (outer, depth) = (e >> 3, 4 (e & 7))
// outer-major, (4 (e % (W / 4)), e / (W / 4)) depth-major.
template <bool OM, bool SECOND, int W>
__device__ __forceinline__ int chunk_at(int e, int& outer, int& depth) {
  if (OM) {
    outer = e >> 3;
    depth = 4 * (e & 7);
    const int sw = SECOND ? (outer >> 2) & 7 : outer & 7;
    return outer * BK + 4 * ((e & 7) ^ sw);
  }
  outer = 4 * (e % (W / 4));
  depth = e / (W / 4);
  return depth * W + outer;
}

// Issue the thread's copies of a slice: src(outer, depth) is the global
// address of the 4 floats at (outer, depth .. depth + 3) outer-major or
// (outer .. outer + 3, depth) depth-major, null for zeros.
template <bool OM, bool SECOND, int W = TL, class Src>
__device__ __forceinline__ void stage(float* dst, Src src) {
#pragma unroll
  for (int it = 0; it < W * BK / 4 / NT; ++it) {
    int o, d;
    const int at = chunk_at<OM, SECOND, W>(threadIdx.x + it * NT, o, d);
    cp_async16(dst + at, src(o, d));
  }
}

// Multiply the thread's own chunks of a landed slice by fac(outer, depth),
// a float4 over the chunk's 4 values.
template <bool OM, bool SECOND, int W = TL, class Fac>
__device__ __forceinline__ void scale(float* dst, Fac fac) {
#pragma unroll
  for (int it = 0; it < W * BK / 4 / NT; ++it) {
    int o, d;
    const int at = chunk_at<OM, SECOND, W>(threadIdx.x + it * NT, o, d);
    float4* v = reinterpret_cast<float4*>(dst + at);
    const float4 f = fac(o, d);
    const float4 w = *v;
    *v = make_float4(w.x * f.x, w.y * f.y, w.z * f.z, w.w * f.w);
  }
}

// Write the thread's chunks of a first-operand slice from sum(outer,
// depth), a float4 computed with plain loads (launch 9 stages E as the sum
// of launch 2's groups).
template <bool OM, class Sum>
__device__ __forceinline__ void stage_sum(float* dst, Sum sum) {
#pragma unroll
  for (int it = 0; it < SL / 4 / NT; ++it) {
    int o, d;
    const int at = chunk_at<OM, false, TL>(threadIdx.x + it * NT, o, d);
    *reinterpret_cast<float4*>(dst + at) = sum(o, d);
  }
}

// acc[r][c] += sum over the slice's depth of a(row ty + 8 r, k) b(k,
// column col_of(tx, c)) for the thread's 8 rows and 4 NJ columns (b has 32
// NJ columns). a is outer-major (AOM) or depth-major; b depth-major
// (columns contiguous) or outer-major (BOM).
template <bool AOM, bool BOM, int NJ = 2>
__device__ __forceinline__ void mma_slice(float (&acc)[8][4 * NJ],
                                          const float* a, const float* b,
                                          int ty, int tx) {
  constexpr int NC = 4 * NJ, W = 32 * NJ;
#pragma unroll 2
  for (int k4 = 0; k4 < BK / 4; ++k4) {
    float bv[4][NC];
    if (BOM) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 v = ld4(b + col_of(tx, c) * BK + 4 * (k4 ^ tx));
        bv[0][c] = v.x;
        bv[1][c] = v.y;
        bv[2][c] = v.z;
        bv[3][c] = v.w;
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < NJ; ++q) {
          const float4 v = ld4(b + (4 * k4 + kk) * W + 32 * q + 4 * tx);
          bv[kk][4 * q] = v.x;
          bv[kk][4 * q + 1] = v.y;
          bv[kk][4 * q + 2] = v.z;
          bv[kk][4 * q + 3] = v.w;
        }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = ty + 8 * r;
      float av[4];
      if (AOM) {
        const float4 v = ld4(a + row * BK + 4 * (k4 ^ (row & 7)));
        av[0] = v.x;
        av[1] = v.y;
        av[2] = v.z;
        av[3] = v.w;
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) av[kk] = a[(4 * k4 + kk) * TL + row];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[r][c] = fmaf(av[kk], bv[kk][c], acc[r][c]);
    }
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[8][NC]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
}

// Hand the thread's 8 x 4 NJ tile to out(row, col, v): the float4 of
// columns col .. col + 3 (col = 4 tx + 32 q) of row ty + 8 r.
template <int NC, class Out>
__device__ __forceinline__ void store_tile(const float (&acc)[8][NC], int ty,
                                           int tx, Out out) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < NC / 4; ++q)
      out(ty + 8 * r, 4 * tx + 32 * q,
          make_float4(acc[r][4 * q], acc[r][4 * q + 1], acc[r][4 * q + 2],
                      acc[r][4 * q + 3]));
}

// The slices 0 .. nsl - 1 of a product through two stages: load(sl, a, b)
// issues slice sl's copies into stage (a, b), fix(sl, a, b) applies the
// factors to the thread's own chunks once they land, mma(sl, a, b)
// multiplies (and may close a part of the product after its last slice).
// Starts with a barrier: the caller may have filled tables that fix reads,
// and the stages may still be read by its previous product. The second
// operand's slices are W wide.
template <int W = TL, class Load, class Fix, class Mma>
__device__ __forceinline__ void pipeline(float* smem, int nsl, Load load,
                                         Fix fix, Mma mma) {
  constexpr int SB = W * BK;
  float* sa = smem;
  float* sb = smem + 2 * SL;
  __syncthreads();
  if (nsl <= 0) return;
  load(0, sa, sb);
  cp_async_commit();
  for (int sl = 0; sl < nsl; ++sl) {
    float* a = sa + (sl & 1) * SL;
    float* b = sb + (sl & 1) * SB;
    cp_async_wait_all();
    fix(sl, a, b);
    __syncthreads();              // slice sl is ready; sl - 1's stage free
    if (sl + 1 < nsl)
      load(sl + 1, sa + ((sl + 1) & 1) * SL, sb + ((sl + 1) & 1) * SB);
    cp_async_commit();
    mma(sl, a, b);
  }
}

struct Strides {
  long long xsb, xss, xsh, dsb, dss, dsh, bsb, bss, csb, css;
};

// Launch 1. Warp w = (b, c, h): row block w of the (Bt, nc, H, 128)
// tables: cum (f64 inclusive cumsum of the f32 products dt_i * A[h]; rows
// past Q: dt = 0), ein = e^{cum_i}, eo = e^{cl - cum_i}, dtp = dt_i (0
// past Q); dec[w] = e^{cl}, cl = cum_{Q-1}.
__global__ void __launch_bounds__(kPrepThreads)
ssd_bwd_prep(const float* __restrict__ dt, const float* __restrict__ A,
         double* __restrict__ cum, float* __restrict__ ein,
         float* __restrict__ eo, float* __restrict__ dtp,
         float* __restrict__ dec, long long nw, int H, int Q, int nc,
         Strides st) {
  const int lane = threadIdx.x & 31;
  const long long w =
      (long long)blockIdx.x * (kPrepThreads / 32) + (threadIdx.x >> 5);
  if (w >= nw) return;
  const int h = (int)(w % H);
  const long long bc = w / H;
  const int c = (int)(bc % nc), b = (int)(bc / nc);
  const float Ah = A[h];
  const float* db = dt + b * st.dsb + (long long)c * Q * st.dss + h * st.dsh;
  float d[4];
  double v[4], run = 0.;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = 4 * lane + e;
    d[e] = i < Q ? db[i * st.dss] : 0.f;
    run += (double)(d[e] * Ah);
    v[e] = run;
  }
  double tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += t;
  }
  double excl = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) excl = 0.;
  const double cl = __shfl_sync(0xffffffffu, excl + v[3], 31);
  const long long base = w * QR;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = 4 * lane + e;
    const double cm = excl + v[e];
    cum[base + i] = cm;
    ein[base + i] = expf((float)cm);
    eo[base + i] = expf((float)(cl - cm));
    dtp[base + i] = d[e];
  }
  if (lane == 0) dec[w] = expf((float)cl);
}

constexpr int gram_smem_floats() {
  return 2 * SL + 2 * GW * BK + 4 * 8 * NT + 4 * GW;
}

// Launch 2. Tile blockIdx.y of chunk (b, c) = blockIdx.x, 64 rows by GW
// columns on or below the diagonal ((0, 0), (0, 1), then (1, 0) .. (1, 3)
// at Q > 64), heads hg blockIdx.z ..: G into gmT (transposed; group 0),
// the group's E into eg[b, c, group], and per head the tile's share of
// each row's sum of T into trow[b, t, h, j0 / GW] and of each column's
// into tcol[b, t, h, i0 / 64].
__global__ void __launch_bounds__(NT, 6)
ssd_bwd_gram(const float* __restrict__ x, const float* __restrict__ B,
             const float* __restrict__ C, const float* __restrict__ dy,
             const double* __restrict__ cum, const float* __restrict__ dtp,
             float* __restrict__ gmT, float* __restrict__ eg,
             double* __restrict__ trow, double* __restrict__ tcol, int H,
             int S, int P, int N, int Q, int nc, int hg, Strides st) {
  extern __shared__ __align__(16) float smem[];
  float* sg = smem + 2 * SL + 2 * GW * BK;    // G, thread-private
  double* scol = reinterpret_cast<double*>(sg + 4 * 8 * NT);  // 2 x GW
  const int tid = threadIdx.x, ty = row_group(), tx = col_group();
  const int bc = blockIdx.x, b = bc / nc, c = bc % nc;
  const int ib = blockIdx.y < 2 ? 0 : 1;
  const int jb = blockIdx.y < 2 ? blockIdx.y : blockIdx.y - 2;
  const int i0 = ib * TL, j0 = jb * GW;
  const int g = blockIdx.z, ng = gridDim.z, h0 = g * hg;
  const int nh = min(H, h0 + hg) - h0;
  const long long t0 = (long long)c * Q;
  const float* Cb = C + b * st.csb + t0 * st.css;
  const float* Bb = B + b * st.bsb + t0 * st.bss;
  const int qt = Q > TL ? 2 : 1;       // row slots 2 qt, column slots qt
  float acc[8][4];
  zero(acc);
  pipeline<GW>(
      smem, (N + BK - 1) / BK,
      [&](int sl, float* a, float* bb) {
        const int k0 = sl * BK;
        stage<true, false>(a, [&](int o, int d) -> const float* {
          return i0 + o < Q && k0 + d < N ? Cb + (i0 + o) * st.css + k0 + d
                                          : nullptr;
        });
        stage<true, true, GW>(bb, [&](int o, int d) -> const float* {
          return j0 + o < Q && k0 + d < N ? Bb + (j0 + o) * st.bss + k0 + d
                                          : nullptr;
        });
      },
      [](int, float*, float*) {},
      [&](int, float* a, float* bb) {
        mma_slice<true, true, 1>(acc, a, bb, ty, tx);
      });
  float* gout = gmT + (long long)bc * QR * QR;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      sg[(4 * r + cc) * NT + tid] = acc[r][cc];
      if (g == 0)
        gout[(j0 + col_of(tx, cc)) * QR + i0 + ty + 8 * r] = acc[r][cc];
    }

  // per head: D = dy x^T over the tile, m = D dt_j e^{cum_i - cum_j} (j <= i
  // < Q), E += m, and T = G m (j < i) into its row's and column's sums in
  // f64
  float e[8][4];
  zero(e);
  zero(acc);
  const int spp = P / BK;
  const float* dyb = dy + ((long long)b * S + t0) * H * P;
  const float* xb = x + b * st.xsb + t0 * st.xss;
  pipeline<GW>(
      smem, nh * spp,
      [&](int sl, float* a, float* bb) {
        const int h = h0 + sl / spp, p = (sl % spp) * BK;
        stage<true, false>(a, [&](int o, int d) -> const float* {
          return i0 + o < Q ? dyb + ((long long)(i0 + o) * H + h) * P + p + d
                            : nullptr;
        });
        stage<true, true, GW>(bb, [&](int o, int d) -> const float* {
          return j0 + o < Q ? xb + (j0 + o) * st.xss + h * st.xsh + p + d
                            : nullptr;
        });
      },
      [](int, float*, float*) {},
      [&](int sl, float* a, float* bb) {
        mma_slice<true, true, 1>(acc, a, bb, ty, tx);
        if (sl % spp != spp - 1) return;
        const int h = h0 + sl / spp;
        const double* ch = cum + ((long long)bc * H + h) * QR;
        const float* dh = dtp + ((long long)bc * H + h) * QR;
        double col[4] = {0., 0., 0., 0.};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = i0 + ty + 8 * r;
          const double ci = ch[i];
          double row = 0.;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int j = j0 + col_of(tx, cc);
            if (j <= i && i < Q) {
              // dy_i . xd_j = (dy_i . x_j) dt_j
              const float m = acc[r][cc] * dh[j] * expf((float)(ci - ch[j]));
              e[r][cc] += m;
              if (j < i) {
                const double t = (double)(sg[(4 * r + cc) * NT + tid] * m);
                row += t;
                col[cc] += t;
              }
            }
            acc[r][cc] = 0.f;
          }
          row = row_reduce(row);
          if (tx == 0 && i < Q) {
            double* dst = trow + (((long long)b * S + t0 + i) * H + h) * 2 * qt;
            dst[jb] = row;
            if (qt == 2 && ib == 0) dst[jb + 2] = 0.;   // no tile (0, 2 + jb)
          }
        }
        // a column's sum: over the warp's row groups (lane bits 0 and 4),
        // then the two warps in order
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          col[cc] += __shfl_xor_sync(0xffffffffu, col[cc], 1);
          col[cc] += __shfl_xor_sync(0xffffffffu, col[cc], 16);
          if ((tid & 17) == 0) scol[(tid >> 5) * GW + col_of(tx, cc)] = col[cc];
        }
        __syncthreads();
        const int j = j0 + tid;
        if (tid < GW && j < Q) {
          double* dst = tcol + (((long long)b * S + t0 + j) * H + h) * qt;
          dst[ib] = scol[tid] + scol[GW + tid];
          if (qt == 2 && j0 >= TL) dst[0] = 0.;       // no tile (0, jb)
        }
      });
  float* eout = eg + (((long long)bc * ng + g) * QR + i0) * QR + j0;
  store_tile(e, ty, tx, [&](int r, int cc, float4 v) {
    *reinterpret_cast<float4*>(eout + r * QR + cc) = v;
  });
}

// Launch 3. R_c for chunk c = 1 + (blockIdx.x / H) % (nc - 1), rows 64
// blockIdx.y.. of N, columns 64 blockIdx.z.. of P, into slot c - 1 of gs.
__global__ void __launch_bounds__(NT)
ssd_bwd_dstate(const float* __restrict__ C, const float* __restrict__ dy,
           const float* __restrict__ ein, float* __restrict__ gs, int H,
           int S, int P, int N, int Q, int nc, Strides st) {
  extern __shared__ __align__(16) float smem[];
  const int ty = row_group(), tx = col_group();
  const int h = blockIdx.x % H, bc1 = blockIdx.x / H;
  const int c = 1 + bc1 % (nc - 1), b = bc1 / (nc - 1);
  const int n0 = blockIdx.y * TL, p0 = blockIdx.z * TL;
  const long long t0 = (long long)c * Q;
  const long long bch = ((long long)b * nc + c) * H + h;
  const float* Cb = C + b * st.csb + t0 * st.css + n0;
  const float* dyb = dy + (((long long)b * S + t0) * H + h) * P + p0;
  float* s_e = smem + STAGES;      // e^{cum_i} of the chunk's rows
  for (int i = threadIdx.x; i < QR; i += NT) s_e[i] = ein[bch * QR + i];
  float acc[8][8];
  zero(acc);
  pipeline(
      smem, (Q + BK - 1) / BK,
      [&](int sl, float* a, float* bb) {
        const int k0 = sl * BK;
        stage<false, false>(a, [&](int o, int d) -> const float* {
          return k0 + d < Q && n0 + o < N ? Cb + (k0 + d) * st.css + o
                                          : nullptr;
        });
        stage<false, true>(bb, [&](int o, int d) -> const float* {
          return k0 + d < Q && p0 + o < P
                     ? dyb + (long long)(k0 + d) * H * P + o : nullptr;
        });
      },
      [&](int sl, float*, float* bb) {   // dy_i -> e^{cum_i} dy_i
        scale<false, true>(bb,
                           [&](int, int d) { return splat(s_e[sl * BK + d]); });
      },
      [&](int, float* a, float* bb) {
        mma_slice<false, false>(acc, a, bb, ty, tx);
      });
  float* out = gs + ((((long long)b * nc + c - 1) * H + h) * N + n0) * P + p0;
  store_tile(acc, ty, tx, [&](int r, int cc, float4 v) {
    if (n0 + r < N && p0 + cc < P)
      *reinterpret_cast<float4*>(out + (long long)r * P + cc) = v;
  });
}

// Each row's sum over the tile's columns of v(row, col) . acc, written by
// the first thread of its row group to out[row * rstride]; rows from q and
// columns from pn are left out (the tile's share of a row's dot product).
template <class V>
__device__ __forceinline__ void row_dots(const float (&acc)[8][8], int ty,
                                         int tx, int q, int pn, float* out,
                                         long long rstride, V v) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = ty + 8 * r;
    float s = 0.f;
#pragma unroll
    for (int cq = 0; cq < 2; ++cq) {
      const int p = 4 * tx + 32 * cq;
      if (j < q && p < pn) {
        const float4 w = v(j, p);
        s = fmaf(w.x, acc[r][4 * cq], s);
        s = fmaf(w.y, acc[r][4 * cq + 1], s);
        s = fmaf(w.z, acc[r][4 * cq + 2], s);
        s = fmaf(w.w, acc[r][4 * cq + 3], s);
      }
    }
    s = row_reduce(s);
    if (tx == 0 && j < q) out[j * rstride] = s;
  }
}

// acc's rows times f[row]: a factor constant along a product's depth.
__device__ __forceinline__ void scale_rows(float (&acc)[8][8], int ty,
                                           const float* f) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float v = f[ty + 8 * r];
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) acc[r][cc] *= v;
  }
}

// Launch 4. y's inter part for rows 64 blockIdx.y.. of chunk c = 1 +
// (blockIdx.x / H) % (nc - 1), head h, columns 64 blockIdx.z.. of P:
// e^{cum_i} C_i S_{c-1} (depth N), and over the CTA's columns each row's
// yo = dy_t . y_inter_t at [b, t, h, blockIdx.z].
__global__ void __launch_bounds__(NT)
ssd_bwd_yinter(const float* __restrict__ C, const float* __restrict__ dy,
               const float* __restrict__ states,
               const float* __restrict__ ein, float* __restrict__ yo, int H,
               int S, int P, int N, int Q, int nc, Strides st) {
  extern __shared__ __align__(16) float smem[];
  const int ty = row_group(), tx = col_group();
  const int h = blockIdx.x % H, bc1 = blockIdx.x / H;
  const int c = 1 + bc1 % (nc - 1), b = bc1 / (nc - 1);
  const int i0 = blockIdx.y * TL, p0 = blockIdx.z * TL;
  const long long t0 = (long long)c * Q;
  const long long bch = ((long long)b * nc + c) * H + h;
  const float* Cb = C + b * st.csb + (t0 + i0) * st.css;
  const float* sp = states + bch * N * P + p0;   // S_{c-1}
  const float* dyb = dy + (((long long)b * S + t0 + i0) * H + h) * P + p0;
  float acc[8][8];
  zero(acc);
  pipeline(
      smem, (N + BK - 1) / BK,
      [&](int sl, float* a, float* bb) {
        const int k0 = sl * BK;
        stage<true, false>(a, [&](int o, int d) -> const float* {
          return i0 + o < Q && k0 + d < N ? Cb + o * st.css + k0 + d
                                          : nullptr;
        });
        stage<false, true>(bb, [&](int o, int d) -> const float* {
          return k0 + d < N && p0 + o < P
                     ? sp + (long long)(k0 + d) * P + o : nullptr;
        });
      },
      [](int, float*, float*) {},
      [&](int, float* a, float* bb) {
        mma_slice<true, false>(acc, a, bb, ty, tx);
      });
  scale_rows(acc, ty, ein + bch * QR + i0);
  const long long rs = (long long)H * gridDim.z;
  row_dots(acc, ty, tx, Q - i0, P - p0,
           yo + (((long long)b * S + t0 + i0) * H + h) * gridDim.z + blockIdx.z,
           rs, [&](int i, int p) { return ld4(dyb + (long long)i * H * P + p); });
}

// Launch 5. For every (batch, head) and float4 e of the (N, P) state:
// G = 0, then for c = nc - 2 .. 0: G = e^{cl(c + 1)} G + R_{c+1} (slot c),
// slot c <- G_c; trp[b, c, h, warp] = the warp's sum of G_c . S_{c-1} over
// its entries (slot c of the forward's states; 0 for c = 0).
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_pass(float* __restrict__ gs, const float* __restrict__ states,
         const float* __restrict__ dec, float* __restrict__ trp, int H,
         int nc, long long np4) {
  const int lane = threadIdx.x & 31;
  const long long e = (long long)blockIdx.y * kPassThreads + threadIdx.x;
  const bool own = e < np4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int nw = gridDim.y * kPassWarps;
  const int wi = blockIdx.y * kPassWarps + (threadIdx.x >> 5);
  const long long step = (long long)H * np4;   // float4s between chunks
  const long long base = ((long long)b * nc * H + h) * np4 + (own ? e : 0);
  float4* g = reinterpret_cast<float4*>(gs) + base;
  const float4* sv = reinterpret_cast<const float4*>(states) + base;
  const float* d = dec + (long long)b * nc * H + h;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 G = z;
  float4 r = own ? g[(nc - 2) * step] : z;
  float4 sc = own && nc > 2 ? sv[(nc - 2) * step] : z;
  for (int c = nc - 2; c >= 0; --c) {
    // the next chunk's loads, issued before this one's dependent FMAs
    const float4 rn = own && c > 0 ? g[(c - 1) * step] : z;
    const float4 sn = own && c > 1 ? sv[(c - 1) * step] : z;
    const float dc = d[(long long)(c + 1) * H];
    G = make_float4(fmaf(dc, G.x, r.x), fmaf(dc, G.y, r.y),
                    fmaf(dc, G.z, r.z), fmaf(dc, G.w, r.w));
    if (own) g[c * step] = G;
    float v = 0.f;
    if (c > 0) v = G.x * sc.x + G.y * sc.y + G.z * sc.z + G.w * sc.w;
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    if (lane == 0) trp[(((long long)b * nc + c) * H + h) * nw + wi] = v;
    r = rn;
    sc = sn;
  }
}

// Launch 6. dxd rows 64 blockIdx.y.. of chunk c, head h, columns 64
// blockIdx.z.. of P: dx = dt dxd, and over the CTA's columns, for each row
// t: xin = x_t . dxd'_t (the state part) and xdd = x_t . dxd_t, at [b, t, h,
// blockIdx.z].
__global__ void __launch_bounds__(NT, 6)
ssd_bwd_dxd(const float* __restrict__ x, const float* __restrict__ B,
            const float* __restrict__ dy, const float* __restrict__ gmT,
            const float* __restrict__ gs, const double* __restrict__ cum,
            const float* __restrict__ eo, const float* __restrict__ dtp,
            float* __restrict__ dx, float* __restrict__ xdd,
            float* __restrict__ xin, int H, int S, int P, int N, int Q,
            int nc, Strides st) {
  extern __shared__ __align__(16) float smem[];
  double* s_cum = reinterpret_cast<double*>(smem + STAGES);
  const int tid = threadIdx.x, ty = row_group(), tx = col_group();
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int c = bc % nc, b = bc / nc;
  const int j0 = blockIdx.y * TL, p0 = blockIdx.z * TL;
  const long long t0 = (long long)c * Q, bch = (long long)bc * H + h;
  for (int i = tid; i < QR; i += NT) s_cum[i] = cum[bch * QR + i];
  const float* Bb = B + b * st.bsb + (t0 + j0) * st.bss;
  const float* gm = gmT + (long long)bc * QR * QR + (long long)j0 * QR;
  const float* dyb = dy + (((long long)b * S + t0) * H + h) * P + p0;
  const float* xb = x + b * st.xsb + (t0 + j0) * st.xss + h * st.xsh + p0;
  const float* gc = gs + bch * N * P + p0;       // G_c
  const int nS = c < nc - 1 ? (N + BK - 1) / BK : 0;
  const int nM = (Q - j0 + BK - 1) / BK;
  // row j of the CTA's partials
  const long long prow =
      (((long long)b * S + t0 + j0) * H + h) * gridDim.z + blockIdx.z;
  const long long rs = (long long)H * gridDim.z;
  auto xval = [&](int j, int p) { return ld4(xb + j * st.xss + p); };

  float acc[8][8];
  zero(acc);
  pipeline(
      smem, nS + nM,
      [&](int sl, float* a, float* bb) {
        if (sl < nS) {                   // B G_c, depth N
          const int k0 = sl * BK;
          stage<true, false>(a, [&](int o, int d) -> const float* {
            return j0 + o < Q && k0 + d < N ? Bb + o * st.bss + k0 + d
                                            : nullptr;
          });
          stage<false, true>(bb, [&](int o, int d) -> const float* {
            return k0 + d < N && p0 + o < P
                       ? gc + (long long)(k0 + d) * P + o : nullptr;
          });
        } else {                         // M^T dy, depth i >= j0
          const int i0 = j0 + (sl - nS) * BK;
          stage<true, false>(a, [&](int o, int d) -> const float* {
            const int i = i0 + d;
            return j0 + o < Q && i < Q && i + 3 >= j0 + o
                       ? gm + o * QR + i : nullptr;
          });
          stage<false, true>(bb, [&](int o, int d) -> const float* {
            return i0 + d < Q && p0 + o < P
                       ? dyb + (long long)(i0 + d) * H * P + o : nullptr;
          });
        }
      },
      [&](int sl, float* a, float*) {
        if (sl < nS) return;             // G_ij -> M_ij, masked before exp
        const int i0 = j0 + (sl - nS) * BK;
        scale<true, false>(a, [&](int o, int d) {
          const int j = j0 + o, i = i0 + d;
          const double cj = s_cum[j];
          float f[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            f[u] = i + u >= j && i + u < Q
                       ? expf((float)(s_cum[i + u] - cj)) : 0.f;
          return make_float4(f[0], f[1], f[2], f[3]);
        });
      },
      [&](int sl, float* a, float* bb) {
        mma_slice<true, false>(acc, a, bb, ty, tx);
        if (sl == nS - 1) {      // dxd' = e^{cl - cum_j} (B_j G_c): x . dxd'
          scale_rows(acc, ty, eo + bch * QR + j0);
          row_dots(acc, ty, tx, Q - j0, P - p0, xin + prow, rs, xval);
        }
      });
  if (nS == 0)                   // no state after the last chunk: x . 0
    row_dots(acc, ty, tx, Q - j0, P - p0, xin + prow, rs,
             [](int, int) { return make_float4(0.f, 0.f, 0.f, 0.f); });
  row_dots(acc, ty, tx, Q - j0, P - p0, xdd + prow, rs, xval);
  float* dxb = dx + (((long long)b * S + t0 + j0) * H + h) * P + p0;
  store_tile(acc, ty, tx, [&](int r, int cc, float4 v) {
    if (j0 + r < Q && p0 + cc < P) {
      const float d = dtp[bch * QR + j0 + r];
      *reinterpret_cast<float4*>(dxb + (long long)r * H * P + cc) =
          make_float4(d * v.x, d * v.y, d * v.z, d * v.w);
    }
  });
}

// The dB / dC tile of blockIdx.y: rows 64 r0.. of the chunk, columns 64
// n0.. of N, dB where is_b (blockIdx.y odd).
struct DbcTile {
  int r0, n0;
  bool is_b;
  __device__ DbcTile(int Q) {
    const int qt = (Q + TL - 1) / TL;
    is_b = blockIdx.y & 1;
    r0 = ((blockIdx.y >> 1) % qt) * TL;
    n0 = ((blockIdx.y >> 1) / qt) * TL;
  }
};

// Launch 7. The inter part of a dB / dC tile (DbcTile) of chunk (b, c) =
// blockIdx.x over heads hk blockIdx.z ..: (e^{cum} dy) S_{c-1}^T for dC,
// (e^{cl - cum} dt x) G_c^T for dB, into part[blockIdx.z, dC / dB] (0
// where the chunk has no such state).
__global__ void __launch_bounds__(NT, 6)
ssd_bwd_dbc(const float* __restrict__ x, const float* __restrict__ dy,
            const float* __restrict__ states, const float* __restrict__ gs,
            const float* __restrict__ ein, const float* __restrict__ eo,
            const float* __restrict__ dtp, float* __restrict__ part, int H,
            int S, int P, int N, int Q, int nc, int hk, Strides st) {
  extern __shared__ __align__(16) float smem[];
  const int ty = row_group(), tx = col_group();
  const int bc = blockIdx.x, b = bc / nc, c = bc % nc;
  const DbcTile t(Q);
  const int g = blockIdx.z, h0 = g * hk;
  const int nh = min(H, h0 + hk) - h0;
  const long long t0 = (long long)c * Q;
  const int spp = P / BK;
  const bool inter = t.is_b ? c < nc - 1 : c > 0;
  const float* dyb = dy + ((long long)b * S + t0 + t.r0) * H * P;
  const float* xb = x + b * st.xsb + (t0 + t.r0) * st.xss;
  // the state operand of head h, rows n0..: S_{c-1} for dC, G_c for dB
  const float* sbase =
      (t.is_b ? gs : states) + ((long long)bc * H * N + t.n0) * P;
  // the rows' factors, head by head: e^{cum_i} (dC), e^{cl - cum_j} dt_j (dB)
  float* s_f = smem + STAGES;
  for (int k = threadIdx.x; k < nh * TL; k += NT) {
    const long long f = ((long long)bc * H + h0 + k / TL) * QR + t.r0 + k % TL;
    s_f[k] = t.is_b ? eo[f] * dtp[f] : ein[f];
  }
  float acc[8][8];
  zero(acc);
  pipeline(
      smem, inter ? nh * spp : 0,
      [&](int sl, float* a, float* bb) {
        const int h = h0 + sl / spp, p = (sl % spp) * BK;
        const float* so = sbase + (long long)h * N * P + p;
        if (t.is_b)
          stage<true, false>(a, [&](int o, int d) -> const float* {
            return t.r0 + o < Q ? xb + o * st.xss + h * st.xsh + p + d
                                : nullptr;
          });
        else
          stage<true, false>(a, [&](int o, int d) -> const float* {
            return t.r0 + o < Q ? dyb + ((long long)o * H + h) * P + p + d
                                : nullptr;
          });
        stage<true, true>(bb, [&](int o, int d) -> const float* {
          return t.n0 + o < N ? so + (long long)o * P + d : nullptr;
        });
      },
      [&](int sl, float* a, float*) {    // dy_i or x_j times its factor
        const float* f = s_f + (sl / spp) * TL;
        scale<true, false>(a, [&](int o, int) { return splat(f[o]); });
      },
      [&](int, float* a, float* bb) {
        mma_slice<true, true>(acc, a, bb, ty, tx);
      });
  float* out = part + ((long long)g * 2 + t.is_b) * gridDim.x * Q * N +
               ((long long)b * S + t0 + t.r0) * N + t.n0;
  store_tile(acc, ty, tx, [&](int r, int cc, float4 v) {
    if (t.r0 + r < Q && t.n0 + cc < N)
      *reinterpret_cast<float4*>(out + (long long)r * N + cc) = v;
  });
}

// Launch 8. Row i = threadIdx.x of chunk c, head h: dcum_i, da = its
// reverse cumsum, ddt_i = x_i . dxd_i + A[h] da_i, and dap[b, c, h] =
// sum_i dt_i da_i.
__global__ void __launch_bounds__(kDtThreads)
ssd_bwd_dt(const float* __restrict__ dtp, const float* __restrict__ A,
       const double* __restrict__ trow, const double* __restrict__ tcol,
       const float* __restrict__ yo, const float* __restrict__ xdd,
       const float* __restrict__ xin, const float* __restrict__ trp,
       const float* __restrict__ dec, float* __restrict__ ddt,
       float* __restrict__ dap, int H, int S, int Q, int nc, int qtiles,
       int ptiles, int nw) {
  const int rslots = 2 * qtiles;   // trow: per GW columns; tcol: per 64 rows
  __shared__ double s[QR], sw[QR];
  const int i = threadIdx.x;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int c = bc % nc, b = bc / nc;
  const long long t = (long long)c * Q + i;
  const long long bth = ((long long)b * S + t) * H + h;
  const bool row = i < Q;
  const float d = dtp[(long long)blockIdx.x * QR + i];   // 0 past Q
  float xs = 0.f;
  double dcum = 0., w = 0.;
  if (row) {
    float xi = 0.f;
    for (int k = 0; k < rslots; ++k) dcum += trow[bth * rslots + k];
    for (int k = 0; k < qtiles; ++k) dcum -= tcol[bth * qtiles + k];
    for (int k = 0; k < ptiles; ++k) {
      if (c > 0) dcum += yo[bth * ptiles + k];   // no state before chunk 0
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
    const float* tp = trp + ((long long)bc * H + h) * nw;
    double tr = 0.;
    for (int k = 0; k < nw; ++k) tr += tp[k];
    dcum += (double)dec[(long long)bc * H + h] * tr;
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
  if (row) ddt[bth] = (float)(xs + (double)A[h] * da);
  __syncthreads();
  s[i] = row ? (double)d * da : 0.;
  __syncthreads();
  for (int k = QR / 2; k > 0; k >>= 1) {
    if (i < k) s[i] += s[i + k];
    __syncthreads();
  }
  if (i == 0) dap[(long long)bc * H + h] = (float)s[0];
}

// Launch 9. The intra part of a dB / dC tile (DbcTile) of chunk (b, c) =
// blockIdx.x: E B (depth j <= i) for dC, E^T C (depth i >= j) for dB, E
// staged as the sum of launch 2's groups in order; dC / dB = launch 7's
// parts summed in order, plus it. The grid's last row: dA[h] = the sum over
// b, then c, of dap[b, c, h].
__global__ void __launch_bounds__(NT)
ssd_bwd_intra(const float* __restrict__ B, const float* __restrict__ C,
              const float* __restrict__ eg, const float* __restrict__ part,
              const float* __restrict__ dap, float* __restrict__ dB,
              float* __restrict__ dC, float* __restrict__ dA, int H, int S,
              int N, int Q, int nc, int ng, int ks, Strides st) {
  extern __shared__ __align__(16) float smem[];
  if (blockIdx.x == gridDim.x - 1) {
    if (blockIdx.y != 0) return;
    const int nbc = gridDim.x - 1;
    for (int h = threadIdx.x; h < H; h += NT) {
      float sum = 0.f;
      int k = 0;
      for (; k + 8 <= nbc; k += 8) {    // 8 loads in flight, summed in order
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = dap[(long long)(k + u) * H + h];
#pragma unroll
        for (int u = 0; u < 8; ++u) sum += v[u];
      }
      for (; k < nbc; ++k) sum += dap[(long long)k * H + h];
      dA[h] = sum;
    }
    return;
  }
  const int ty = row_group(), tx = col_group();
  const int bc = blockIdx.x, b = bc / nc, c = bc % nc;
  const DbcTile t(Q);
  const long long t0 = (long long)c * Q;
  const float* egb = eg + (long long)bc * ng * QR * QR;
  const float* Bb = B + b * st.bsb + t0 * st.bss + t.n0;
  const float* Cb = C + b * st.csb + t0 * st.css + t.n0;
  // E as the sum of launch 2's groups in order; 0 past Q (above the
  // diagonal the groups wrote 0)
  auto esum = [&](int i, int j) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < Q && j < Q)
      for (int gg = 0; gg < ng; ++gg)
        s = add4(s, ld4(egb + ((long long)gg * QR + i) * QR + j));
    return s;
  };
  float acc[8][8];
  zero(acc);
  pipeline(
      smem, t.is_b ? (Q - t.r0 + BK - 1) / BK
                   : (min(Q, t.r0 + TL) + BK - 1) / BK,
      [&](int sl, float* a, float* bb) {
        const int k0 = (t.is_b ? t.r0 : 0) + sl * BK;
        if (t.is_b) {                    // E^T C: rows j, depth i >= r0
          stage_sum<false>(a, [&](int o, int d) {
            return esum(k0 + d, t.r0 + o);
          });
          stage<false, true>(bb, [&](int o, int d) -> const float* {
            return k0 + d < Q && t.n0 + o < N ? Cb + (k0 + d) * st.css + o
                                              : nullptr;
          });
        } else {                         // E B: rows i, depth j <= i
          stage_sum<true>(a, [&](int o, int d) {
            return esum(t.r0 + o, k0 + d);
          });
          stage<false, true>(bb, [&](int o, int d) -> const float* {
            return k0 + d < Q && t.n0 + o < N ? Bb + (k0 + d) * st.bss + o
                                              : nullptr;
          });
        }
      },
      [](int, float*, float*) {},
      [&](int, float* a, float* bb) {
        if (t.is_b)
          mma_slice<false, false>(acc, a, bb, ty, tx);
        else
          mma_slice<true, false>(acc, a, bb, ty, tx);
      });
  const long long at = ((long long)b * S + t0 + t.r0) * N + t.n0;
  const long long slot = (long long)(gridDim.x - 1) * Q * N;   // Bt S N
  const float* in = part + t.is_b * slot + at;
  float* out = (t.is_b ? dB : dC) + at;
  store_tile(acc, ty, tx, [&](int r, int cc, float4 v) {
    if (t.r0 + r < Q && t.n0 + cc < N) {
      const long long e = (long long)r * N + cc;
      float4 s = ld4(in + e);
      for (int g = 1; g < ks; ++g) s = add4(s, ld4(in + g * 2 * slot + e));
      *reinterpret_cast<float4*>(out + e) = add4(s, v);
    }
  });
}

// A second stream per device and three events, made on first use: a full
// call runs the Gram launch beside launches 3-5 and dB/dC's inter part
// beside dxd, joined back to the caller's stream before launch 8.
struct Side {
  cudaStream_t s = nullptr;
  cudaEvent_t ev[3] = {nullptr, nullptr, nullptr};
};

cudaError_t side_stream(Side*& out) {
  static std::mutex mu;
  static Side sides[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  Side& sd = sides[dev];
  if (sd.s == nullptr) {
    if ((err = cudaStreamCreateWithFlags(&sd.s, cudaStreamNonBlocking)) !=
        cudaSuccess)
      return err;
    for (cudaEvent_t& e : sd.ev)
      if ((err = cudaEventCreateWithFlags(&e, cudaEventDisableTiming)) !=
          cudaSuccess)
        return err;
  }
  out = &sd;
  return cudaSuccess;
}

}  // namespace

// The gradient of ssd_scan_f32 (csrc/ssd_scan.cu). x (Bt, S, H, P), B, C
// (Bt, S, N) with unit stride in the last axis, dt (Bt, S, H) any strides,
// as the forward took them (strides in elements: (xsb, xss, xsh), (dsb,
// dss, dsh), (bsb, bss), (csb, css)); A (H,); states the forward's states
// buffer after its run (slot c = S_{c-1}); dy contiguous (Bt, S, H, P). Q
// in [1, 128] divides S; P a multiple of 32; N a multiple of 4, at most
// 256. hg heads per CTA of launch 2 (ng = ceil(H / hg) groups), hk per CTA
// of launch 7 (ks = ceil(H / hk) groups). Outputs, contiguous: dx (Bt, S,
// H, P), ddt (Bt, S, H), dA (H), dB and dC (Bt, S, N). Scratch, 16-byte
// aligned, with R = Bt * (S / Q) * H rows of 128: cum (R * 128 doubles),
// ein, eo, dtp (R * 128 floats each), dec and dap (R), gm (Bt * (S / Q) *
// 128 * 128), eg (ng times that), gs (R * N * P), trp (R * 8 * ceil(N * P
// / 1024)), trow and tcol (Bt * S * H * 2 ceil(Q / 64) and ceil(Q / 64)
// doubles), xdd, xin and yo (Bt * S * H * ceil(P / 64) each), part (ks * 2
// * Bt * S * N). parts: bit i runs launch i + 1 (511: the backward; one
// bit alone times that launch on the buffers of an earlier full run).
extern "C" int ssd_scan_bwd_f32(
    const float* x, const float* dt, const float* A, const float* B,
    const float* C, const float* states, const float* dy, float* dx,
    float* ddt, float* dA, float* dB, float* dC, double* cum, float* ein,
    float* eo, float* dtp, float* dec, float* gm, float* eg, float* gs,
    float* trp, double* trow, double* tcol, float* xdd, float* xin,
    float* yo, float* dap, float* part, int Bt, int S, int H, int P, int N,
    int Q, int hg, int hk, int parts, long long xsb, long long xss,
    long long xsh, long long dsb, long long dss, long long dsh, long long bsb,
    long long bss, long long csb, long long css, void* stream) {
  if (Bt < 1 || S < 1 || H < 1 || N < 4 || N > 256 || N % 4 || Q < 1 ||
      Q > QR || S % Q || P < 32 || P % 32 || hg < 1 || hk < 1 ||
      (long long)Bt * S / Q * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s_ = (cudaStream_t)stream;
  const Strides st = {xsb, xss, xsh, dsb, dss, dsh, bsb, bss, csb, css};
  const int nc = S / Q, ptiles = (P + TL - 1) / TL, qtiles = (Q + TL - 1) / TL;
  const int ntiles = (N + TL - 1) / TL;
  const int ng = (H + hg - 1) / hg, ks = (H + hk - 1) / hk;
  const long long rows = (long long)Bt * nc * H;
  const long long np4 = (long long)N * P / 4;
  const int nblk = (int)((np4 + kPassThreads - 1) / kPassThreads);
  const int prod = (int)sizeof(float) * STAGES;
  const int gram = (int)sizeof(float) * gram_smem_floats();
  const int dxds = prod + (int)sizeof(double) * QR;
  const int dsts = prod + (int)sizeof(float) * QR;
  const int dbcs = prod + (int)sizeof(float) * TL * hk;
  cudaError_t err = cudaSuccess;
  if (dbcs > 48 * 1024 &&
      (err = cudaFuncSetAttribute(ssd_bwd_dbc,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  dbcs)) != cudaSuccess)
    return (int)err;
  // a full call forks the Gram and dB/dC launches onto a side stream
  const bool fork = parts == kAllParts;
  Side* side = nullptr;
  if (fork && (err = side_stream(side)) != cudaSuccess) return (int)err;
  cudaStream_t s2 = fork ? side->s : s_;
  if (parts & 1) {
    ssd_bwd_prep<<<(unsigned)((rows + 3) / 4), kPrepThreads, 0, s_>>>(
        dt, A, cum, ein, eo, dtp, dec, rows, H, Q, nc, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (fork && ((err = cudaEventRecord(side->ev[0], s_)) != cudaSuccess ||
               (err = cudaStreamWaitEvent(s2, side->ev[0], 0)) !=
                   cudaSuccess))
    return (int)err;
  if (parts & 2) {
    ssd_bwd_gram<<<dim3((unsigned)(Bt * nc), Q > TL ? 6 : 2, ng), NT, gram,
                   s2>>>(
        x, B, C, dy, cum, dtp, gm, eg, trow, tcol, H, S, P, N, Q, nc, hg, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (nc > 1 && (parts & 4)) {
    ssd_bwd_dstate<<<dim3((unsigned)(Bt * (nc - 1) * H), ntiles, ptiles), NT,
                 dsts, s_>>>(C, dy, ein, gs, H, S, P, N, Q, nc, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (nc > 1 && (parts & 8)) {
    ssd_bwd_yinter<<<dim3((unsigned)(Bt * (nc - 1) * H), qtiles, ptiles), NT,
                     prod, s_>>>(C, dy, states, ein, yo, H, S, P, N, Q, nc,
                                 st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (nc > 1 && (parts & 16)) {
    ssd_bwd_pass<<<dim3((unsigned)(Bt * H), (unsigned)nblk), kPassThreads, 0,
               s_>>>(gs, states, dec, trp, H, nc, np4);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (fork && ((err = cudaEventRecord(side->ev[1], s2)) != cudaSuccess ||
               (err = cudaEventRecord(side->ev[0], s_)) != cudaSuccess ||
               (err = cudaStreamWaitEvent(s2, side->ev[0], 0)) !=
                   cudaSuccess ||
               (err = cudaStreamWaitEvent(s_, side->ev[1], 0)) !=
                   cudaSuccess))
    return (int)err;
  if (parts & 32) {
    ssd_bwd_dxd<<<dim3((unsigned)rows, qtiles, ptiles), NT, dxds, s_>>>(
        x, B, dy, gm, gs, cum, eo, dtp, dx, xdd, xin, H, S, P, N, Q, nc, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const dim3 dbc_grid((unsigned)(Bt * nc), 2 * qtiles * ntiles);
  if (parts & 64) {
    ssd_bwd_dbc<<<dim3(dbc_grid.x, dbc_grid.y, ks), NT, dbcs, s2>>>(
        x, dy, states, gs, ein, eo, dtp, part, H, S, P, N, Q, nc, hk, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (fork && ((err = cudaEventRecord(side->ev[2], s2)) != cudaSuccess ||
               (err = cudaStreamWaitEvent(s_, side->ev[2], 0)) !=
                   cudaSuccess))
    return (int)err;
  if (parts & 128) {
    ssd_bwd_dt<<<(unsigned)rows, kDtThreads, 0, s_>>>(
        dtp, A, trow, tcol, yo, xdd, xin, trp, dec, ddt, dap, H, S, Q, nc,
        qtiles, ptiles, nblk * kPassWarps);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (parts & 256) {
    ssd_bwd_intra<<<dim3(dbc_grid.x + 1, dbc_grid.y), NT, prod, s_>>>(
        B, C, eg, part, dap, dB, dC, dA, H, S, N, Q, nc, ng, ks, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
