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
// HBM's rate). This first kernel does f32 FMAs on the CUDA cores and no
// tensor-core MMA (f32 on tensor cores is TF32, which the port's f32 parity
// rules out). Design: one CTA of 128 threads per (64-row q tile, q head,
// batch); the sequential kv grid axis of the Pallas kernel becomes the loop
// inside the CTA. The q tile stays in shared memory; each kv tile (64 keys)
// of K and V is staged there in f32 (bf16 inputs are widened on load). A
// thread owns 4 rows (rg + 16 i) and, for S = Q K^T, 8 key columns
// (cg + 8 j), so each 16-byte shared load feeds 8 or 16 FMAs and the rows'
// max and sum are reduced over the 8 lanes of a row group by shuffles;
// m, l and the thread's D/8 output columns of acc stay in registers. The
// row strides D + 4 (Q, K, V) and 72 (P) keep the shared loads and the P
// stores free of bank conflicts (for D in {32, 64, 112, 128}: the eight
// rows an 8-lane phase reads start on distinct 4-bank groups). CTAs take
// the q tiles in reverse order so that the longest causal rows start
// first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;           // q rows per CTA
constexpr int kBK = 64;           // keys per kv tile
constexpr int kThreads = 128;     // 16 row groups x 8 column groups
constexpr int kLP = kBK + 8;      // row stride of the P tile in shared memory
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(v.x, v.y);
  p2[1] = __floats2bfloat162_rn(v.z, v.w);
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

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// Rows [0, 64) of a (rows, D) slice with row stride ss -> f32 shared memory
// with row stride D + 4.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss) {
  constexpr int V = D / 4;
  for (int idx = threadIdx.x; idx < kBK * V; idx += kThreads) {
    const int r = idx / V, c = (idx % V) * 4;
    store4(dst + r * (D + 4) + c, load4(src + r * ss + c));
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int H, int group,
          int Sq, int Sk, long long qsb, long long qss, long long qsh,
          long long ksb, long long kss, long long ksh, long long vsb,
          long long vss, long long vsh, int causal, int window,
          float sm_scale) {
  constexpr int LD = D + 4;
  constexpr int NC = (D + 31) / 32; // float4 output columns per thread
  // a thread owns the float4 columns cg * 4 + 32 c of the output; when 32
  // does not divide D (D = 112) the last c is live only for cg * 4 < D % 32
  auto live = [](int c, int cg) {
    return D % 32 == 0 || cg * 4 + 32 * c < D;
  };
  extern __shared__ float4 smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const T* kp = k + b * ksb + kvh * ksh;
  const T* vp = v + b * vsb + kvh * vsh;
  load_tile<D>(Qs, q + b * qsb + q0 * qss + h * qsh, qss);

  float m[4], l[4];
  float4 acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  int t_lo = 0, t_hi = Sk / kBK - 1;
  if (window > 0 && q0 - window + 1 > 0) t_lo = (q0 - window + 1) / kBK;
  if (causal) t_hi = min(t_hi, (q0 + kBQ - 1) / kBK);

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                // the last tile's K, V and P are read
    load_tile<D>(Ks, kp + k0 * kss, kss);
    load_tile<D>(Vs, vp + k0 * vss, vss);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = load4(Qs + (rg + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) kb[j] = load4(Ks + (cg + 8 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = dot4(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + cg + 8 * j;
        const bool ok = (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        s[i][j] = ok ? s[i][j] * sm_scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(rg + 16 * i) * kLP + cg + 8 * j] = p;
      }
      l[i] = l[i] * corr + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[i][c].x *= corr;
        acc[i][c].y *= corr;
        acc[i][c].z *= corr;
        acc[i][c].w *= corr;
      }
    }
    __syncwarp();                   // a row's P is written by its own warp

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = load4(Ps + (rg + 16 * i) * kLP + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (!live(c, cg)) continue;
          const float4 vv = load4(Vs + (j + e) * LD + cg * 4 + 32 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) fma4(acc[i][c], at(pa[i], e), vv);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = fmaxf(l[i], 1e-30f);
    T* op = o + ((long long)b * Sq + q0 + rg + 16 * i) * H * D +
            (long long)h * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (live(c, cg))
        store4(op + cg * 4 + 32 * c,
               make_float4(acc[i][c].x / li, acc[i][c].y / li,
                           acc[i][c].z / li, acc[i][c].w / li));
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int Sq, int Sk, const long long* st, int causal,
           int window, float sm_scale, cudaStream_t stream) {
  const int smem = (int)sizeof(float) *
                   (kBQ * (D + 4) + 2 * kBK * (D + 4) + kBQ * kLP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Sq / kBQ, H, B);
  flash_fwd<D, T><<<grid, kThreads, smem, stream>>>(
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
      return launch<32, T>(q, k, v, o, B, H, KV, Sq, Sk, st, causal, window,
                           sm_scale, s);
    case 64:
      return launch<64, T>(q, k, v, o, B, H, KV, Sq, Sk, st, causal, window,
                           sm_scale, s);
    case 112:
      return launch<112, T>(q, k, v, o, B, H, KV, Sq, Sk, st, causal, window,
                            sm_scale, s);
    case 128:
      return launch<128, T>(q, k, v, o, B, H, KV, Sq, Sk, st, causal, window,
                            sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v in the layout (B, S, heads, D) with unit stride in D and the
// given (batch, seq, head) strides in elements; o is a contiguous
// (B, Sq, H, D). dtype 0 = f32, 1 = bf16. window 0 = no sliding window.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int KV, int Sq, int Sk, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window,
    float sm_scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < kBQ || Sk < kBK ||
      Sq % kBQ || Sk % kBK || B > 65535 || H > 65535 || window < 0)
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
