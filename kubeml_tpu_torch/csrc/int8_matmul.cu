// Weight-only int8 matmul for Hopper (sm_90a): y = (x @ Q) * s.
//
// Replaces the Pallas TPU kernel kubeml_tpu/ops/int8_matmul.py::_mm_kernel
// (wrapper `int8_matmul`). x [M, K] is f32 or bf16, Q [K, N] int8 row-major,
// s [N] f32 per output channel; the sum over all of K is taken in f32 and
// the scale is applied once, in the epilogue, never to a dense weight.
//
// What bounds it on an H100: at decode shapes (M = 8 rows) memory traffic.
// Each step streams every int8 weight once (about 124 MB per GPT-2-small
// decode step counting lm_head) and does only 2*M flops per weight byte.
// The design reads each Q byte once per M tile and keeps the int8 -> f32
// convert on the load into shared memory, so device memory only ever sees
// int8 weights:
//   * output tiles of BM x 64 (BM = 16 for decode-sized M, 64 otherwise),
//     256 threads, each holding a TM x 4 accumulator in registers;
//   * a K loop through shared memory in 64-deep tiles (x and Q converted to
//     f32 on load); ragged M, N and K edges are masked in the kernel, so no
//     padded copy of x or Q is ever made (the TPU version padded to its
//     (8, 128) tiling);
//   * split-K when the output tiles alone cannot fill the card (a 768-wide
//     projection at M = 8 is 12 tiles): each split writes an f32 partial
//     into a workspace and a second kernel sums the splits in a fixed
//     order and applies the scale, so results do not depend on timing.
// This first version uses FMA on the CUDA cores, not wgmma; at decode M
// the weight bytes, not the flops, are the bound it is held against.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One (BM x 64) output tile over one K split. With `partial` non-null the
// raw f32 sums go to partial[split][M][N]; otherwise y = acc * s directly.
template <typename TX, typename TY, int BM>
__global__ void __launch_bounds__(kThreads) int8_matmul_kernel(
    const TX* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ s, TY* __restrict__ y,
    float* __restrict__ partial, int M, int K, int N, int k_per_split) {
  constexpr int TM = BM / 16;
  constexpr int TN = kBN / 16;
  __shared__ float xs[BM][kBK + 1];
  __shared__ float qs[kBK][kBN];
  const int tx = threadIdx.x & 15;  // columns tx + 16 * tn
  const int ty = threadIdx.x >> 4;  // rows ty * TM + tm
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const int split = blockIdx.z;
  const int kbeg = split * k_per_split;
  const int kend = min(K, kbeg + k_per_split);

  float acc[TM][TN];
#pragma unroll
  for (int tm = 0; tm < TM; ++tm)
#pragma unroll
    for (int tn = 0; tn < TN; ++tn) acc[tm][tn] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    for (int idx = threadIdx.x; idx < BM * kBK; idx += kThreads) {
      const int r = idx / kBK;
      const int c = idx - r * kBK;
      const int m = m0 + r;
      const int k = k0 + c;
      xs[r][c] = (m < M && k < kend) ? to_f32(x[(size_t)m * K + k]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < kBK * kBN; idx += kThreads) {
      const int r = idx / kBN;
      const int c = idx - r * kBN;
      const int k = k0 + r;
      const int n = n0 + c;
      qs[r][c] = (k < kend && n < N) ? (float)q[(size_t)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM];
      float w[TN];
#pragma unroll
      for (int tm = 0; tm < TM; ++tm) a[tm] = xs[ty * TM + tm][kk];
#pragma unroll
      for (int tn = 0; tn < TN; ++tn) w[tn] = qs[kk][tx + 16 * tn];
#pragma unroll
      for (int tm = 0; tm < TM; ++tm)
#pragma unroll
        for (int tn = 0; tn < TN; ++tn)
          acc[tm][tn] = fmaf(a[tm], w[tn], acc[tm][tn]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int tm = 0; tm < TM; ++tm) {
    const int m = m0 + ty * TM + tm;
    if (m >= M) continue;
#pragma unroll
    for (int tn = 0; tn < TN; ++tn) {
      const int n = n0 + tx + 16 * tn;
      if (n >= N) continue;
      if (partial != nullptr) {
        partial[((size_t)split * M + m) * N + n] = acc[tm][tn];
      } else {
        y[(size_t)m * N + n] = from_f32<TY>(acc[tm][tn] * s[n]);
      }
    }
  }
}

// y = (sum over splits of partial) * s, splits summed in index order.
template <typename TY>
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ s,
                                     TY* __restrict__ y, int M, int N,
                                     int splits) {
  const size_t total = (size_t)M * N;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += partial[(size_t)sp * total + idx];
  y[idx] = from_f32<TY>(acc * s[idx % N]);
}

template <typename TX, typename TY, int BM>
int launch(const void* x, const void* q, const void* s, void* y,
           void* workspace, int M, int K, int N, int splits, int k_per_split,
           cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  float* partial = splits > 1 ? static_cast<float*>(workspace) : nullptr;
  int8_matmul_kernel<TX, TY, BM><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<TY*>(y), partial, M, K, N,
      k_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t total = (size_t)M * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  splitk_reduce_kernel<TY><<<blocks, threads, 0, stream>>>(
      partial, static_cast<const float*>(s), static_cast<TY*>(y), M, N,
      splits);
  return (int)cudaGetLastError();
}

template <typename TX, typename TY>
int dispatch_bm(int bm, const void* x, const void* q, const void* s, void* y,
                void* workspace, int M, int K, int N, int splits,
                int k_per_split, cudaStream_t stream) {
  switch (bm) {
    case 16:
      return launch<TX, TY, 16>(x, q, s, y, workspace, M, K, N, splits,
                                k_per_split, stream);
    case 64:
      return launch<TX, TY, 64>(x, q, s, y, workspace, M, K, N, splits,
                                k_per_split, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename TX>
int dispatch_y(int y_dtype, int bm, const void* x, const void* q,
               const void* s, void* y, void* workspace, int M, int K, int N,
               int splits, int k_per_split, cudaStream_t stream) {
  switch (y_dtype) {
    case kF32:
      return dispatch_bm<TX, float>(bm, x, q, s, y, workspace, M, K, N, splits,
                                    k_per_split, stream);
    case kBF16:
      return dispatch_bm<TX, __nv_bfloat16>(bm, x, q, s, y, workspace, M, K, N,
                                            splits, k_per_split, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [M, K] (x_dtype), q [K, N] int8, s [N] f32, y [M, N] (y_dtype), all
// contiguous. bm is the output tile height (16 or 64). With splits > 1,
// workspace holds splits * M * N floats and each split covers k_per_split
// (a multiple of 64) rows of K. Returns cudaGetLastError().
extern "C" int kubeml_int8_matmul(const void* x, const void* q, const void* s,
                                  void* y, void* workspace, int M, int K,
                                  int N, int bm, int splits, int k_per_split,
                                  int x_dtype, int y_dtype, void* stream) {
  if (M < 1 || K < 1 || N < 1 || splits < 1 || k_per_split < 1 ||
      k_per_split % kBK != 0 || (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32:
      return dispatch_y<float>(y_dtype, bm, x, q, s, y, workspace, M, K, N,
                               splits, k_per_split, st);
    case kBF16:
      return dispatch_y<__nv_bfloat16>(y_dtype, bm, x, q, s, y, workspace, M,
                                       K, N, splits, k_per_split, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
