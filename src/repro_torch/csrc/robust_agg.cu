// Robust (order-statistics) internal aggregation, DESIGN.md §15.2: per
// coordinate, the trimmed mean or the coordinate median over the active
// members of each group's gradient stack.
//
// Replaces src/repro/kernels/robust_agg/kernel.py:robust_agg_kernel
// (_make_kernel). Same result: the Pallas kernel pushes inactive members
// past every active value (3e38) and ranks the members by pairwise compares;
// trimmed_mean sums the values of rank t_eff <= r < n - t_eff (t_eff =
// min(trim, max((n-1)/2, 0))) and divides by max(n - 2 t_eff, 1);
// coord_median averages the values of rank max((n-1)/2, 0) and n/2; a group
// with n = 0 gives 0. Here the values are SORTED in registers instead: the
// value of rank r is the r-th smallest, so both estimators read the sorted
// array, and the trimmed sum runs in ascending order as in the plain
// (sort-based) version. Active values must be finite (the wrapper's caller
// masks non-finite members out).
//
// What bounds it: bytes. At the paper's traffic the stack is (M, K, P) =
// (10, 10, 6.6 M) f32, 2.64 GB read once for 26 MB written. Design: ONE
// launch for all M groups (grid.y = group), whose blocks stride over P.
// Consecutive threads read consecutive coordinates of each member row; with
// K <= 16 and P % 4 == 0 (the robust path's padded stack) a thread owns 4
// coordinates and reads them as one float4 per row, so that enough bytes
// are in flight to keep HBM busy. An inactive member's row is not read at
// all: its slot holds +inf. The group's active mask is built once per block
// (a member per thread, a warp ballot) and reaches the block through shared
// memory as a bit mask. The K values stay in registers, KMAX slots (a power
// of 2), sorted by a bitonic network whose comparators all put the minimum
// at the lower slot: a comparator that touches a slot >= K compares with an
// +inf pad and is a no-op, so it is skipped. For K <= 16 the kernel is
// compiled for the exact K, and the skipped comparators vanish at compile
// time (42 min/max pairs for K = 10); with K known only at run time every
// comparator is a branch. K = 17..64 take that run-time form, in 32 or 64
// slots.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerGroup = 512;  // grid.x; each block strides over P
constexpr int kTrimmedMean = 0;  // method codes shared with the wrapper
constexpr int kCoordMedian = 1;

// Sorts v[0..K) in place (slots >= K hold +inf) and returns the estimator;
// K is KC where KC > 0 (known at compile time), else k_rt.
template <int KMAX, int KC>
__device__ __forceinline__ float sorted_stat(float (&v)[KMAX], int k_rt,
                                             int n, int method, int trim) {
  const int K = KC > 0 ? KC : k_rt;
  // ascending-only bitonic sort: the first step of each merge pairs slot a
  // with its mirror a ^ (size - 1), the later steps with a ^ stride
#pragma unroll
  for (int size = 2; size <= KMAX; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int a = 0; a < KMAX; ++a) {
        const int b = stride == size >> 1 ? a ^ (size - 1) : a ^ stride;
        if (b > a && b < K) {
          const float lo = fminf(v[a], v[b]), hi = fmaxf(v[a], v[b]);
          v[a] = lo;
          v[b] = hi;
        }
      }
    }
  }
  if (n == 0) return 0.f;
  if (method == kTrimmedMean) {
    const int half = (n - 1) / 2;
    const int t_eff = trim < half ? trim : half;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      if (k >= t_eff && k < n - t_eff) acc += v[k];
    const int cnt = n - 2 * t_eff;
    return acc / (float)(cnt > 1 ? cnt : 1);
  }
  const int lo = (n - 1) / 2, hi = n / 2;
  float v_lo = 0.f, v_hi = 0.f;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k == lo) v_lo = v[k];
    if (k == hi) v_hi = v[k];
  }
  return (v_lo + v_hi) * 0.5f;
}

// VEC = 4: a thread owns 4 consecutive coordinates and reads them as one
// float4 per member row (P % 4 == 0, 16-byte aligned rows): a warp keeps
// 512 bytes of each row in flight instead of 128. VEC = 1 otherwise.
template <int KMAX, int KC, int VEC>
__global__ void __launch_bounds__(kThreads)
robust_agg_kernel(const float* __restrict__ X, const float* __restrict__ active,
                  float* __restrict__ out, int k_rt, long long P, int method,
                  int trim) {
  using Vec = typename std::conditional<VEC == 4, float4, float>::type;
  const int K = KC > 0 ? KC : k_rt;
  __shared__ unsigned s_mask[2];           // members 0..31 and 32..63
  const int g = blockIdx.y;
  if (threadIdx.x < 64) {
    const int k = threadIdx.x;
    const unsigned bits = __ballot_sync(
        0xffffffffu, k < K && active[(long long)g * K + k] > 0.f);
    if ((k & 31) == 0) s_mask[k >> 5] = bits;
  }
  __syncthreads();
  const unsigned long long mask =
      s_mask[0] | ((unsigned long long)s_mask[1] << 32);
  const int n = __popcll(mask);
  const long long pv = P / VEC;
  const Vec* xg = reinterpret_cast<const Vec*>(X + (long long)g * K * P);
  Vec* og = reinterpret_cast<Vec*>(out + (long long)g * P);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < pv;
       i += (long long)gridDim.x * blockDim.x) {
    Vec w[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K && ((mask >> k) & 1ull)) {
        w[k] = __ldg(xg + k * pv + i);
      } else {
        float* f = reinterpret_cast<float*>(&w[k]);
#pragma unroll
        for (int c = 0; c < VEC; ++c) f[c] = __int_as_float(0x7f800000);
      }
    }
    Vec res;
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      float v[KMAX];
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        v[k] = reinterpret_cast<const float*>(&w[k])[c];
      reinterpret_cast<float*>(&res)[c] =
          sorted_stat<KMAX, KC>(v, K, n, method, trim);
    }
    og[i] = res;
  }
}

template <int KMAX, int KC>
void launch(const float* X, const float* active, float* out, int M, int K,
            long long P, int method, int trim, cudaStream_t stream) {
  const bool vec4 = KMAX <= 16 && P % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(X) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int per_thread = vec4 ? 4 : 1;
  const long long tiles = (P / per_thread + kThreads - 1) / kThreads;
  dim3 grid((unsigned)(tiles < kBlocksPerGroup ? tiles : kBlocksPerGroup),
            (unsigned)M);
  if constexpr (KMAX <= 16) {
    if (vec4) {
      robust_agg_kernel<KMAX, KC, 4><<<grid, kThreads, 0, stream>>>(
          X, active, out, K, P, method, trim);
      return;
    }
  }
  robust_agg_kernel<KMAX, KC, 1><<<grid, kThreads, 0, stream>>>(
      X, active, out, K, P, method, trim);
}

constexpr int pow2_at_least(int k) {
  return k <= 1 ? 1 : 2 * pow2_at_least((k + 1) / 2);
}

// The kernel compiled for the exact K, for K = KC..16.
template <int KC>
void launch_exact(const float* X, const float* active, float* out, int M,
                  int K, long long P, int method, int trim,
                  cudaStream_t stream) {
  if constexpr (KC <= 16) {
    if (K == KC)
      launch<pow2_at_least(KC), KC>(X, active, out, M, K, P, method, trim,
                                     stream);
    else
      launch_exact<KC + 1>(X, active, out, M, K, P, method, trim, stream);
  }
}

}  // namespace

// X (M, K, P) row-major, active (M, K) 0/1, out (M, P); 1 <= K <= 64,
// M <= 65535, method 0 = trimmed_mean, 1 = coord_median.
extern "C" int robust_agg_f32(const void* X, const void* active, void* out,
                              int M, int K, long long P, int method, int trim,
                              void* stream) {
  if (K < 1 || K > 64 || M < 1 || M > 65535 || P < 1 ||
      (method != kTrimmedMean && method != kCoordMedian) || trim < 0)
    return (int)cudaErrorInvalidValue;
  const float* x = (const float*)X;
  const float* a = (const float*)active;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 16)
    launch_exact<1>(x, a, o, M, K, P, method, trim, s);
  else if (K <= 32)
    launch<32, 0>(x, a, o, M, K, P, method, trim, s);
  else
    launch<64, 0>(x, a, o, M, K, P, method, trim, s);
  return (int)cudaGetLastError();
}
