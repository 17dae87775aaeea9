// Fused conv block: per-group im2col GEMM + bias, ReLU and 2x2 max-pool.
//
// Replaces src/repro/kernels/conv_fused/kernel.py:conv_fused_kernel
// (_conv_fused_kernel): for every group g, y = patches[g] (R x Q) · w[g]
// (Q x C) + b[g]; out = maxpool2x2(relu(y)). Both y (the backward's ReLU and
// pool-mask residual) and the pooled out are written.
//
// What bounds it: operations. conv2 of the paper's CNN over the 3200-image
// superbatch is 2·G·R·Q·C = 64 GFLOP against 2.3 GB of traffic. The f32
// product must stay strict f32 (TF32 would break parity with the reference),
// so it runs on the FP32 pipes, not the tensor cores. Design: a block owns
// TR = 32·7 = 224 rows (whole image row-pairs of the 28- and 14-wide layers,
// so the pool never straddles a block) and all C columns; patches and
// weights are staged in shared memory in KC-deep slices and every thread
// accumulates a 7 x 4 register tile.
// The epilogue adds the bias, writes y, and after a block barrier pools the
// ReLU of the block's own y rows (re-read from L1/L2) into out.
#include <cuda_runtime.h>

namespace {

constexpr int kKC = 32;        // depth of one shared-memory slice of Q
constexpr int kRowGroups = 32; // thread rows
constexpr int RM = 7;          // rows per thread
constexpr int TR = RM * kRowGroups;  // rows per block

__global__ void conv_fused_kernel(const float* __restrict__ pat,
                                  const float* __restrict__ w,
                                  const float* __restrict__ bias,
                                  float* y, float* __restrict__ out,
                                  int R, int Q, int C, int W) {
  extern __shared__ float smem[];
  float* As = smem;                    // TR x (kKC + 1), padded rows
  float* Ws = smem + TR * (kKC + 1);   // kKC x C

  const int g = blockIdx.y;
  const int row0 = blockIdx.x * TR;
  pat += (size_t)g * R * Q;
  w += (size_t)g * Q * C;
  bias += (size_t)g * C;
  y += (size_t)g * R * C;
  out += (size_t)g * (R / 4) * C;

  const int cq = C / 4;               // threads per row group
  const int tx = threadIdx.x % cq;    // column quad
  const int ty = threadIdx.x / cq;    // row group

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < Q; k0 += kKC) {
    for (int e = threadIdx.x; e < TR * kKC; e += blockDim.x) {
      int rr = e / kKC, kk = e % kKC;
      int row = row0 + rr, k = k0 + kk;
      As[rr * (kKC + 1) + kk] = (row < R && k < Q) ? pat[(size_t)row * Q + k] : 0.f;
    }
    for (int e = threadIdx.x; e < kKC * C; e += blockDim.x) {
      int kk = e / C, c = e % C;
      int k = k0 + kk;
      Ws[kk * C + c] = k < Q ? w[(size_t)k * C + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      float4 wv = *reinterpret_cast<const float4*>(&Ws[kk * C + tx * 4]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        float a = As[(ty + i * kRowGroups) * (kKC + 1) + kk];
        acc[i][0] = fmaf(a, wv.x, acc[i][0]);
        acc[i][1] = fmaf(a, wv.y, acc[i][1]);
        acc[i][2] = fmaf(a, wv.z, acc[i][2]);
        acc[i][3] = fmaf(a, wv.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

  const float4 bv = *reinterpret_cast<const float4*>(&bias[tx * 4]);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    int row = row0 + ty + i * kRowGroups;
    if (row < R) {
      float4 v = make_float4(acc[i][0] + bv.x, acc[i][1] + bv.y,
                             acc[i][2] + bv.z, acc[i][3] + bv.w);
      *reinterpret_cast<float4*>(&y[(size_t)row * C + tx * 4]) = v;
    }
  }
  __syncthreads();   // the block's y rows are now visible to all its threads

  // 2x2 max-pool of relu(y): rows are (image, h, w), a block holds whole
  // row-pairs, so window (lp, w2) reads rows lp·2W + 2·w2 + {0, 1, W, W+1}.
  const int half = W / 2;
  for (int e = threadIdx.x; e < (TR / 4) * C; e += blockDim.x) {
    int pr = e / C, c = e % C;
    int lp = pr / half, w2 = pr % half;
    int src = row0 + lp * 2 * W + 2 * w2;
    if (src >= R) continue;
    float m = fmaxf(fmaxf(y[(size_t)src * C + c], y[(size_t)(src + 1) * C + c]),
                    fmaxf(y[(size_t)(src + W) * C + c],
                          y[(size_t)(src + W + 1) * C + c]));
    out[(size_t)(row0 / 4 + pr) * C + c] = fmaxf(m, 0.f);
  }
}

}  // namespace

// W must divide TR / 2 = 112 (whole row-pairs per block); C % 4 == 0,
// C <= 128.
extern "C" int conv_fused_f32(const void* pat, const void* w, const void* b,
                              void* y, void* out, int G, int R, int Q, int C,
                              int W, void* stream) {
  size_t smem = sizeof(float) * ((size_t)TR * (kKC + 1) + (size_t)kKC * C);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((R + TR - 1) / TR, G);
  conv_fused_kernel<<<grid, kRowGroups * (C / 4), smem, (cudaStream_t)stream>>>(
      (const float*)pat, (const float*)w, (const float*)b, (float*)y,
      (float*)out, R, Q, C, W);
  return (int)cudaGetLastError();
}
