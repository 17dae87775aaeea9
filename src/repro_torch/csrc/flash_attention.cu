// Forward flash attention (online softmax) with causal and sliding-window
// masks and grouped-query heads, in the model layout (B, S, H, D).
//
// Replaces src/repro/kernels/flash_attention/kernel.py:flash_attention_kernel
// (_flash_kernel). Same result: scores (q . k) * sm_scale, masked to -1e30
// (not -inf) where kpos > qpos (causal) or kpos <= qpos - window; running
// max m, sum l and accumulator acc per row, updated per kv tile as
//   m' = max(m, max_j s_j),  p_j = exp(s_j - m'),  c = exp(m - m'),
//   l' = l c + sum_j p_j,    acc' = acc c + p . V;
// out = acc / max(l, 1e-30) in q's type. A row whose keys are all masked in
// a tile the CTA computes (because other rows of its q tile need that tile)
// takes p = exp(0) = 1 there; the first unmasked key gives c = exp(-1e30 -
// m) = 0 and wipes those terms out, as in the Pallas kernel. The kv tiles
// run in ascending order from the first one inside the window to the last
// one at or before the causal diagonal, so the tiles that are masked for
// every row of the q tile cost nothing, and the output does not depend on
// the tile size beyond the order of f32 sums.
//
// What bounds it: operations. At the prefill shape (B, S, H, KV, D) =
// (2, 4096, 32, 8, 64) the causal half needs ~1.4e11 f32 FLOP (2.05 ms at
// the 67 TFLOP/s FP32 peak) for ~168 MB of q/k/v/o traffic (0.05 ms at
// HBM's rate). The FMAs run on the CUDA cores in strict f32 (f32 on the
// tensor cores is TF32, which the port's f32 parity rules out). An SM issues
// 128 FP32 FMAs per clock but reads 32 floats per clock from shared memory,
// so every thread must issue at least 4 FMAs per float it reads there.
//
// Design: one CTA of 2·BQ threads per (BQ-row q tile, q head, batch), BQ =
// 128 at D = 112 (one CTA of 8 warps per SM in 214 KB of shared memory) and
// 64 otherwise (two CTAs of 4 warps per SM at D = 64); the sequential kv
// grid axis of the Pallas kernel becomes the loop inside the CTA, over
// 64-key tiles. Q stays in shared memory; K and V tiles are double-buffered
// there and filled by cp.async (bf16 staged raw and widened on the shared
// read), so the next tile's loads overlap this tile's FMAs, with one barrier
// per tile. A warp owns 16 rows (two row groups rg, rows rg + BQ/8·i) in
// both phases, so P passes between its phases inside the warp.
//  - S = Q K^T: a pair of lanes owns an 8 x 8 block of raw scores q·k (rows
//    rg + BQ/8·i, keys kg + 8j); each computes it over one half of D, 8 q
//    float4s and 8 k float4s per 256 FMAs (4 per float), and one shuffle
//    exchange sums the halves so that each keeps 4 whole rows. Masks are
//    applied only on the tiles that cross the diagonal or the window edge.
//    The rows' max and sum are reduced over the 8 key lanes by shuffles; m
//    (unscaled: the scale is positive) and l stay in registers; p = 2^((s -
//    m)·scale·log2 e) goes to a shared P tile and the rescale c to a shared
//    row vector.
//  - acc += P V: each thread owns 8 rows and D/8 (D <= 64, the lanes of the
//    two halves of the warp taking the two halves of the tile's keys and
//    adding by a shuffle at the end) or D/16 columns (D = 112, 128): 8 x 8
//    tiles at D = 32, 64 and 128; at D = 112 every lane owns one float4, one
//    float2 and one float of the 112 columns (4·16 + 2·16 + 16), 8 x 7.
// Lanes 2i and 2i + 1 read the same K (S) and V (P·V) vectors and a
// half-warp reads two Q or P rows, so each shared load takes two wavefronts
// rather than four. Shared row strides D + 16 bytes (Q, K, V) and 68 floats
// (P) keep those reads free of bank conflicts for every D taken. CTAs take
// the q tiles in reverse order so that the longest causal rows start first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;           // keys per kv tile
constexpr int kLP = kBK + 4;      // row stride of the P tile in shared memory
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 4 elements (16 bytes of f32, 8 of bf16); zeros if !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// shared-memory reads of 4, 2 and 1 elements, widened to f32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);   // one 8-byte load
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float ld1(const float* p) { return *p; }

__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// global stores of 4, 2 and 1 elements in the output's type
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void st4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(v[0], v[1]);
  p2[1] = __floats2bfloat162_rn(v[2], v[3]);
}

__device__ __forceinline__ void st2(float* p, const float* v) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

__device__ __forceinline__ void st2(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}

__device__ __forceinline__ void st1(float* p, float v) { *p = v; }

__device__ __forceinline__ void st1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

// reductions over the 8 key lanes of a row (lane bits 1-3)
__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x + __shfl_xor_sync(0xffffffffu, x, 8);
}

// The P·V column layout of one thread: NF4 float4s at 4·cg + 4·NCG·u, then
// NF2 float2s and NF1 floats over what is left of D.
template <int D>
struct Cols {
  static constexpr int KS = D <= 64 ? 2 : 1;   // key halves of a tile
  static constexpr int NCG = 16 / KS;          // column groups
  static constexpr int NF4 = D / (4 * NCG);
  static constexpr int B2 = 4 * NCG * NF4;     // first float2 column
  static constexpr int NF2 = (D - B2) / (2 * NCG);
  static constexpr int B1 = B2 + 2 * NCG * NF2;  // first scalar column
  static constexpr int NF1 = (D - B1) / NCG;
  static constexpr int N = 4 * NF4 + 2 * NF2 + NF1;  // columns per thread
  static_assert(B1 + NCG * NF1 == D, "columns must cover D");
};

template <int D, int BQ, typename T>
__global__ void __launch_bounds__(2 * BQ, BQ == 64 ? 2 : 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int H, int group,
          int Sq, int Sk, long long qsb, long long qss, long long qsh,
          long long ksb, long long kss, long long ksh, long long vsb,
          long long vss, long long vsh, int causal, int window,
          float sm_scale) {
  using L = Cols<D>;
  constexpr int NT = 2 * BQ;
  constexpr int TR = 8;                        // rows per thread
  constexpr int RS = BQ / TR;                  // stride of a thread's rows
  constexpr int TH = TR / 2;                   // rows a thread keeps of S
  constexpr int LD = D + 16 / (int)sizeof(T);  // Q/K/V row stride
  constexpr int DH = D / 2;                    // S-phase depth per thread
  constexpr int KPV = kBK / L::KS;             // P·V keys per thread

  extern __shared__ float4 smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BQ * LD;                        // two buffers
  T* Vs = Ks + 2 * kBK * LD;                   // two buffers
  float* Ps = reinterpret_cast<float*>(Vs + 2 * kBK * LD);
  float* Cs = Ps + BQ * kLP;                   // per-row rescale c
  float* Ls = Cs + BQ;                         // per-row l at the end

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // S = Q K^T roles: row group srg (lane bit 0), key group kg (bits 1-3),
  // D half hf (bit 4). Lanes 2i and 2i + 1 read the same K float4, and a
  // half-warp reads two Q rows, so each shared load takes two wavefronts.
  const int kg = (lane >> 1) & 7, hf = lane >> 4;
  const int srg = 2 * warp + (lane & 1);
  // P·V roles: row group prg (bit 0, the rows the warp's S lanes own, so a
  // warp reads only the rows of P that it wrote), column group cg, key
  // half ks (bit 4 when D <= 64); lanes 2i and 2i + 1 read the same V
  const int prg = 2 * warp + (lane & 1);
  const int cg = (lane >> 1) % L::NCG;
  const int ks = L::KS == 2 ? lane >> 4 : 0;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int qrows = min(BQ, Sq - q0);
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const T* kp = k + b * ksb + kvh * ksh;
  const T* vp = v + b * vsb + kvh * vsh;

  const float c2 = sm_scale * 1.4426950408889634f;  // exp(x·s) = 2^(x·c2)
  int t_lo = 0, t_hi = Sk / kBK - 1;
  if (window > 0 && q0 - window + 1 > 0) t_lo = (q0 - window + 1) / kBK;
  if (causal) t_hi = min(t_hi, (q0 + qrows - 1) / kBK);

  // rows [0, rows) of a (rows, D) slice with row stride ss; rows at or past
  // nvalid are zero
  auto stage = [&](T* dst, const T* src, long long ss, int rows,
                   int nvalid) {
    constexpr int V4 = D / 4;
    for (int idx = tid; idx < rows * V4; idx += NT) {
      const int r = idx / V4, c = (idx % V4) * 4;
      const bool ok = r < nvalid;
      cp_async4(dst + r * LD + c, ok ? src + r * ss + c : src, ok);
    }
  };
  if (t_lo <= t_hi) {
    stage(Qs, q + b * qsb + (long long)q0 * qss + h * qsh, qss, BQ, qrows);
    stage(Ks, kp + (long long)t_lo * kBK * kss, kss, kBK, kBK);
    stage(Vs, vp + (long long)t_lo * kBK * vss, vss, kBK, kBK);
    cp_async_commit();
  }

  float m[TH], l[TH];
#pragma unroll
  for (int i = 0; i < TH; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float acc[TR][L::N];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < L::N; ++c) acc[i][c] = 0.f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    cp_async_wait_all();
    __syncthreads();      // tile t landed; tile t - 1's P, c and V are read
    if (t < t_hi) {
      const long long k1 = (long long)(t + 1) * kBK;
      stage(Ks + (buf ^ 1) * kBK * LD, kp + k1 * kss, kss, kBK, kBK);
      stage(Vs + (buf ^ 1) * kBK * LD, vp + k1 * vss, vss, kBK, kBK);
      cp_async_commit();
    }
    const int k0 = t * kBK;
    // does any (row, key) of this tile fall outside the masks?
    const bool edge = (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + qrows - 1 - window);
    const T* Kt = Ks + buf * kBK * LD;
    const T* Vt = Vs + buf * kBK * LD;

    // raw scores q·k over this thread's half of D
    float s[TR][8];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    const T* qa = Qs + srg * LD + hf * DH;
    const T* kb = Kt + kg * LD + hf * DH;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      float4 qv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) qv[i] = ld4(qa + i * RS * LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = ld4(kb + j * 8 * LD + d);
#pragma unroll
        for (int i = 0; i < TR; ++i) s[i][j] = dot4(qv[i], kv, s[i][j]);
      }
    }

    // the pair sums its halves: hf keeps rows TH·hf + i4 of its TR
#pragma unroll
    for (int i4 = 0; i4 < TH; ++i4) {
      const int row = srg + RS * (TH * hf + i4);
      const int qpos = q0 + row;
      float sf[8];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float send = hf ? s[i4][j] : s[i4 + TH][j];
        const float keep = hf ? s[i4 + TH][j] : s[i4][j];
        sf[j] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
        if (edge) {
          const int kpos = k0 + kg + 8 * j;
          const bool ok = (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          sf[j] = ok ? sf[j] : kNegInf;
        }
        mx = fmaxf(mx, sf[j]);
      }
      // m is kept unscaled (the scale is positive): p = exp((s - m)·scale)
      const float m_new = fmaxf(m[i4], group_max(mx));
      const float corr = exp2f((m[i4] - m_new) * c2);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = exp2f((sf[j] - m_new) * c2);
        rs += p;
        Ps[row * kLP + kg + 8 * j] = p;
      }
      l[i4] = l[i4] * corr + group_sum(rs);
      m[i4] = m_new;
      if (kg == 0) Cs[row] = corr;
    }
    __syncwarp();         // the warp's rows of P and c are written

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float c = Cs[prg + RS * i];
#pragma unroll
      for (int n = 0; n < L::N; ++n) acc[i][n] *= c;
    }
    const float* pr = Ps + prg * kLP + ks * KPV;
    const T* vr = Vt + ks * KPV * LD;
#pragma unroll 2
    for (int kk = 0; kk < KPV; kk += 4) {
      float4 pa[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) pa[i] = ld4(pr + i * RS * kLP + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const T* row = vr + (kk + e) * LD;
        float vv[L::N];
#pragma unroll
        for (int u = 0; u < L::NF4; ++u) {
          const float4 x = ld4(row + 4 * cg + 4 * L::NCG * u);
          vv[4 * u] = x.x;
          vv[4 * u + 1] = x.y;
          vv[4 * u + 2] = x.z;
          vv[4 * u + 3] = x.w;
        }
#pragma unroll
        for (int u = 0; u < L::NF2; ++u) {
          const float2 x = ld2(row + L::B2 + 2 * cg + 2 * L::NCG * u);
          vv[4 * L::NF4 + 2 * u] = x.x;
          vv[4 * L::NF4 + 2 * u + 1] = x.y;
        }
#pragma unroll
        for (int u = 0; u < L::NF1; ++u)
          vv[4 * L::NF4 + 2 * L::NF2 + u] =
              ld1(row + L::B1 + cg + L::NCG * u);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float pe = at(pa[i], e);
#pragma unroll
          for (int n = 0; n < L::N; ++n)
            acc[i][n] = fmaf(pe, vv[n], acc[i][n]);
        }
      }
    }
  }

  if (kg == 0) {
#pragma unroll
    for (int i4 = 0; i4 < TH; ++i4) Ls[srg + RS * (TH * hf + i4)] = l[i4];
  }
  __syncwarp();           // the warp's l is written
  // D <= 64: the two key halves (lane ^ 16) add their partial sums; each
  // then writes half of the rows
  if (L::KS == 2) {
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int n = 0; n < L::N; ++n)
        acc[i][n] += __shfl_xor_sync(0xffffffffu, acc[i][n], 16);
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = prg + RS * i;
    if (row >= qrows || (L::KS == 2 && (i < TH) != (ks == 0))) continue;
    const float li = fmaxf(Ls[row], 1e-30f);
    float r[L::N];
#pragma unroll
    for (int n = 0; n < L::N; ++n) r[n] = acc[i][n] / li;
    T* op = o + ((long long)b * Sq + q0 + row) * H * D + (long long)h * D;
#pragma unroll
    for (int u = 0; u < L::NF4; ++u)
      st4(op + 4 * cg + 4 * L::NCG * u, r + 4 * u);
#pragma unroll
    for (int u = 0; u < L::NF2; ++u)
      st2(op + L::B2 + 2 * cg + 2 * L::NCG * u, r + 4 * L::NF4 + 2 * u);
#pragma unroll
    for (int u = 0; u < L::NF1; ++u)
      st1(op + L::B1 + cg + L::NCG * u, r[4 * L::NF4 + 2 * L::NF2 + u]);
  }
}

template <int D, int BQ, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int Sq, int Sk, const long long* st, int causal,
           int window, float sm_scale, cudaStream_t stream) {
  constexpr int LD = D + 16 / (int)sizeof(T);
  const int smem = (int)sizeof(T) * (BQ * LD + 4 * kBK * LD) +
                   (int)sizeof(float) * (BQ * kLP + 2 * BQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D, BQ, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<D, BQ, T><<<grid, 2 * BQ, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, H / KV, Sq, Sk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, window,
      sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int H, int KV, int Sq, int Sk, const long long* st,
               int causal, int window, float sm_scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<32, 64, T>(q, k, v, o, B, H, KV, Sq, Sk, st, causal,
                               window, sm_scale, s);
    case 64:
      return launch<64, 64, T>(q, k, v, o, B, H, KV, Sq, Sk, st, causal,
                               window, sm_scale, s);
    case 112:
      return launch<112, 128, T>(q, k, v, o, B, H, KV, Sq, Sk, st, causal,
                                 window, sm_scale, s);
    case 128:
      return launch<128, 64, T>(q, k, v, o, B, H, KV, Sq, Sk, st, causal,
                                window, sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v in the layout (B, S, heads, D) with unit stride in D and the
// given (batch, seq, head) strides in elements (multiples of 4, data on
// 4-element boundaries); o is a contiguous (B, Sq, H, D). dtype 0 = f32,
// 1 = bf16. window 0 = no sliding window. Sq and Sk are multiples of 64.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int KV, int Sq, int Sk, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window,
    float sm_scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < kBK || Sk < kBK ||
      Sq % kBK || Sk % kBK || B > 65535 || H > 65535 || window < 0)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, H, KV, Sq, Sk, st, causal,
                             window, sm_scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, H, KV, Sq, Sk, st,
                                     causal, window, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
