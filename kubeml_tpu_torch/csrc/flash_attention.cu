// Flash attention for Hopper (sm_90a): the forward and the FlashAttention-2
// backward (dQ, then dK/dV) over [B, L, H, D] tensors read in place.
//
// Replaces the three Pallas TPU kernels of kubeml_tpu/ops/flash_attention.py:
//   flash_fwd_kernel (f32), flash_fwd_mma_kernel (bf16) <- _fa_kernel
//       (wrapper _flash_fwd_impl)
//   flash_dq_kernel, flash_dq_mma_kernel   <- _dq_kernel
//       (wrapper _flash_bwd_impl, first call)
//   flash_dkv_kernel, flash_dkv_mma_kernel <- _dkv_kernel
//       (wrapper _flash_bwd_impl, second call)
//
// What bounds them on an H100: operations. At the training shape (L 2048,
// D 64) each K/V tile read from device memory feeds a 64 x 64 tile of
// scores, two to four products of 2 x D flops per (query, key) pair; the
// bytes moved are O(L x D) per (b, h) while the work is O(L^2 x D), far
// above the card's ridge from L ~ 1024 on. The design keeps every
// intermediate of that work on chip and does no work twice across blocks:
//   * the TPU's sequential grid axis becomes a loop inside one block. The
//     forward and dQ kernels take one block per (b, h, 64-query tile) and
//     walk the K/V tiles, stopping at the diagonal when causal; the dK/dV
//     kernel takes one block per (b, h, 64-key tile) and walks the Q/dO
//     tiles, starting at the diagonal when causal. Every block owns its
//     output tile, so there are no atomics and the gradients are
//     bit-identical from run to run;
//   * bf16 inputs take the tensor cores: mma.sync m16n8k16 with f32
//     accumulation, 4 warps a block, each warp 16 rows of the 64-row tile
//     (see the bf16 section below). f32 inputs compute in f32 on the CUDA
//     cores, so the chain to the CPU tests stays exact: tiles staged in
//     shared memory as f32, each of 256 threads holding a 4 x 4 block of
//     the score tile in registers (rows ty + 16 i, columns tx + 16 j), so
//     one shared-memory read feeds two FMAs. In both, the online softmax
//     (running max m, sum l) and the output accumulators stay in
//     registers, the row reductions are shuffles;
//   * ragged ends of Lq and Lk are masked in the kernel (rows past L load
//     as zeros and are never stored), with no padding or transposes.
// Arithmetic follows the Pallas kernels: scores are the f32 product times
// 1/sqrt(D); masked scores are -1e30 and their weights exactly 0, so fully
// masked rows give output 0, lse ~ -1e30 and zero gradients, and padded
// keys get exactly zero dK and dV; the row sum is clamped at 1e-9; P is
// rounded to the input dtype before P.V and P^T.dO, dS before dS.K and
// dS^T.Q. Causal masking is top-left aligned: key k attends query q when
// k <= q, both counted from 0, also when Lq != Lk.
// This first version uses mma.sync (Ampere-style warp-level products) and
// plain loads into shared memory, not Hopper's wgmma and TMA, and does not
// overlap the next tile's loads with the current tile's products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kTile = 64;      // queries per q-tile and keys per k-tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int kSP = kTile + 1; // padded row of a [64, 64] score tile

enum DType { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* q;      // [B, Lq, H, D]
  const void* k;      // [B, Lk, H, D]
  const void* v;      // [B, Lk, H, D]
  const float* valid; // [B, Lk], > 0 = real key
  const float* lse;   // [B, H, Lq] (backward input)
  const void* dout;   // [B, Lq, H, D] (backward input)
  const float* dsum;  // [B, H, Lq] rowsum(dO * O) (backward input)
  void* out;          // forward: out [B, Lq, H, D]; dq kernel: dq
  float* lse_out;     // forward: lse [B, H, Lq]
  void* dk;           // [B, Lk, H, D]
  void* dv;           // [B, Lk, H, D]
  int B, Lq, Lk, H;
  float scale;
};

// Rows [row0, row0 + 64) of head h of batch row b of a [B, L, H, D] f32
// tensor into a [64][D + 1] tile; rows at or past L load as zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int b, int h, int row0, int L, int H) {
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = row0 + r;
    dst[r * DP + d] =
        row < L ? src[(((size_t)b * L + row) * H + h) * D + d] : 0.f;
  }
}

// Per-row values ([B, H, L] layout) of rows [row0, row0 + 64); 0 past L.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int b, int h, int row0, int L, int H) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int row = row0 + r;
    dst[r] = row < L ? src[((size_t)b * H + h) * L + row] : 0.f;
  }
}

// kv_valid of keys [k0, k0 + 64); keys past Lk count as padding.
__device__ __forceinline__ void load_valid(float* dst, const float* __restrict__ valid,
                                           int b, int k0, int Lk) {
  for (int j = threadIdx.x; j < kTile; j += kThreads)
    dst[j] = k0 + j < Lk ? valid[(size_t)b * Lk + k0 + j] : 0.f;
}

// s[i][j] = sum_d A[ty + 16 i][d] * Bt[tx + 16 j][d] over [64][D + 1] tiles,
// summed in d order (every kernel recomputes the same scores bit for bit).
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A,
                                         const float* Bt, int ty, int tx) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * DP + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = Bt[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
  }
}

// acc[i][c] += sum_t P[ty + 16 i][t] * M[t][tx + 16 c] for a [64][65] P tile
// and a [64][D + 1] M tile.
template <int D>
__device__ __forceinline__ void tile_acc(float (&acc)[4][D / 16], const float* P,
                                         const float* M, int ty, int tx) {
  constexpr int DP = D + 1;
#pragma unroll 4
  for (int t = 0; t < kTile; ++t) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * kSP + t];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float m = M[t * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], m, acc[i][c]);
    }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t fwd_smem() {  // sQ, sK, sV, sP, sValid
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kSP + kTile);
}
template <int D>
constexpr size_t dq_smem() {  // sQ, sdO, sK, sV, sS, sValid, sLse, sDsum
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kSP + 3 * kTile);
}
template <int D>
constexpr size_t dkv_smem() {  // sK, sV, sQ, sdO, sP, sS, sValid, sLse, sDsum
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kSP + 3 * kTile);
}

// --- f32 forward: one block per (q-tile, h, b) -------------------------

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * DP;
  float* sV = sK + kTile * DP;
  float* sP = sV + kTile * DP;
  float* sValid = sP + kTile * kSP;
  // the longest causal walks (last q-tiles) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);

  load_tile<D>(sQ, q, b, h, q0, a.Lq, a.H);
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const int k_end = kCausal ? min(a.Lk, q0 + kTile) : a.Lk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's sK/sV/sP reads are done
    load_tile<D>(sK, k, b, h, k0, a.Lk, a.H);
    load_tile<D>(sV, v, b, h, k0, a.Lk, a.H);
    load_valid(sValid, a.valid, b, k0, a.Lk);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j;
        const bool keep = sValid[kj] > 0.f && (!kCausal || k0 + kj <= qpos);
        s[i][j] = keep ? s[i][j] * a.scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] <= 0.5f * kNeg ? 0.f : expf(s[i][j] - m_new);
        rs += p;
        sP[(ty + 16 * i) * kSP + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_acc<D>(acc, sP, sV, ty, tx);
  }
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Lq) continue;
    const float lc = fmaxf(l[i], 1e-9f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      out[(((size_t)b * a.Lq + row) * a.H + h) * D + tx + 16 * c] =
          acc[i][c] / lc;
    if (tx == 0) a.lse_out[((size_t)b * a.H + h) * a.Lq + row] = m[i] + logf(lc);
  }
}

// --- f32 dQ: one block per (q-tile, h, b) ------------------------------

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Args a) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * DP;
  float* sK = sdO + kTile * DP;
  float* sV = sK + kTile * DP;
  float* sS = sV + kTile * DP;
  float* sValid = sS + kTile * kSP;
  float* sLse = sValid + kTile;
  float* sDsum = sLse + kTile;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<D>(sQ, static_cast<const float*>(a.q), b, h, q0, a.Lq, a.H);
  load_tile<D>(sdO, static_cast<const float*>(a.dout), b, h, q0, a.Lq, a.H);
  load_rows(sLse, a.lse, b, h, q0, a.Lq, a.H);
  load_rows(sDsum, a.dsum, b, h, q0, a.Lq, a.H);
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  const int k_end = kCausal ? min(a.Lk, q0 + kTile) : a.Lk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<D>(sK, static_cast<const float*>(a.k), b, h, k0, a.Lk, a.H);
    load_tile<D>(sV, static_cast<const float*>(a.v), b, h, k0, a.Lk, a.H);
    load_valid(sValid, a.valid, b, k0, a.Lk);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(s, sQ, sK, ty, tx);
    tile_dot<D>(dp, sdO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j;
        const bool keep = sValid[kj] > 0.f && (!kCausal || k0 + kj <= q0 + r);
        const float x = keep ? s[i][j] * a.scale : kNeg;
        const float p = x <= 0.5f * kNeg ? 0.f : expf(x - sLse[r]);
        sS[r * kSP + kj] = p * (dp[i][j] - sDsum[r]) * a.scale;
      }
    }
    __syncthreads();
    tile_acc<D>(acc, sS, sK, ty, tx);
  }
  float* dq = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Lq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dq[(((size_t)b * a.Lq + row) * a.H + h) * D + tx + 16 * c] =
          acc[i][c];
  }
}

// --- f32 dK/dV: one block per (k-tile, h, b) ---------------------------

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(const Args a) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * DP;
  float* sQ = sV + kTile * DP;
  float* sdO = sQ + kTile * DP;
  float* sP = sdO + kTile * DP;   // [key][query] P^T
  float* sS = sP + kTile * kSP;   // [key][query] dS^T
  float* sValid = sS + kTile * kSP;
  float* sLse = sValid + kTile;
  float* sDsum = sLse + kTile;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<D>(sK, static_cast<const float*>(a.k), b, h, k0, a.Lk, a.H);
  load_tile<D>(sV, static_cast<const float*>(a.v), b, h, k0, a.Lk, a.H);
  load_valid(sValid, a.valid, b, k0, a.Lk);
  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;
  // causal: queries before k0 see none of this tile's keys
  for (int q0 = kCausal ? k0 : 0; q0 < a.Lq; q0 += kTile) {
    __syncthreads();
    load_tile<D>(sQ, static_cast<const float*>(a.q), b, h, q0, a.Lq, a.H);
    load_tile<D>(sdO, static_cast<const float*>(a.dout), b, h, q0, a.Lq, a.H);
    load_rows(sLse, a.lse, b, h, q0, a.Lq, a.H);
    load_rows(sDsum, a.dsum, b, h, q0, a.Lq, a.H);
    __syncthreads();
    // transposed tiles: rows are keys (ty + 16 i), columns queries
    float st[4][4], dpt[4][4];
    tile_dot<D>(st, sK, sQ, ty, tx);
    tile_dot<D>(dpt, sV, sdO, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = tx + 16 * j;
        const bool keep = sValid[r] > 0.f && q0 + qj < a.Lq &&
                          (!kCausal || k0 + r <= q0 + qj);
        const float x = keep ? st[i][j] * a.scale : kNeg;
        const float p = x <= 0.5f * kNeg ? 0.f : expf(x - sLse[qj]);
        sP[r * kSP + qj] = p;
        sS[r * kSP + qj] = p * (dpt[i][j] - sDsum[qj]) * a.scale;
      }
    }
    __syncthreads();
    tile_acc<D>(dv, sP, sdO, ty, tx);
    tile_acc<D>(dk, sS, sQ, ty, tx);
  }
  float* dk_out = static_cast<float*>(a.dk);
  float* dv_out = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= a.Lk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const size_t off = (((size_t)b * a.Lk + row) * a.H + h) * D + tx + 16 * c;
      dk_out[off] = dk[i][c];
      dv_out[off] = dv[i][c];
    }
  }
}

// --- bf16: the same three kernels on the tensor cores ----------------------
//
// mma.sync m16n8k16 (bf16 in, f32 accumulate): 4 warps per block, each warp
// owns 16 rows of the block's 64-row tile. Tiles sit in shared memory as
// bf16, rows padded by 8 elements so the fragment loads hit 32 distinct
// banks; the right-hand operands of P.V, dS.K, P^T.dO and dS^T.Q are staged
// transposed ([D][64]). The score tile's accumulator fragments are, pair by
// pair, the left-hand fragments of the next product (P, dS), so P and dS
// never leave registers; they are rounded to bf16 by that packing, as the
// Pallas kernels cast them.

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;
constexpr int kTS = kTile + 8;  // row stride of a transposed [D][64] tile

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of head h of a [B, L, H, D] bf16 tensor into a
// [64][D + 8] tile, 16 bytes per thread and copy; rows past L are zeros.
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* __restrict__ src,
                                               int b, int h, int row0, int L, int H) {
  constexpr int VPR = D / 8;
  for (int idx = threadIdx.x; idx < kTile * VPR; idx += kMmaThreads) {
    const int r = idx / VPR;
    const int c = idx - r * VPR;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < L)
      val = *reinterpret_cast<const uint4*>(src + (((size_t)b * L + row) * H + h) * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c * 8) = val;
  }
}

// The same rows transposed into a [D][64 + 8] tile. Consecutive threads take
// consecutive rows of one 8-column chunk, so the 2-byte stores of a warp
// fall in distinct words.
template <int D>
__device__ __forceinline__ void load_tile_bf16_t(bf16* dst, const bf16* __restrict__ src,
                                                 int b, int h, int row0, int L, int H) {
  constexpr int VPR = D / 8;
  for (int idx = threadIdx.x; idx < kTile * VPR; idx += kMmaThreads) {
    const int c = idx / kTile;
    const int r = idx - c * kTile;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < L)
      val = *reinterpret_cast<const uint4*>(src + (((size_t)b * L + row) * H + h) * D + c * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(c * 8 + i) * kTS + r] = e[i];
  }
}

// Left-hand fragment of rows [r0, r0 + 16), k-step kk, of a [64][D + 8] tile.
template <int D>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t, int r0, int kk,
                                       int g, int tig) {
  const bf16* p = t + (r0 + g) * (D + 8) + kk * 16 + tig * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * (D + 8));
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * (D + 8) + 8);
}

// acc[nb] += A(rows r0.., D) . Y(rows nb*8.., D)^T for the 8 column blocks of
// a 64-row tile Y: a [16, 64] score-like tile from two [.., D] tiles.
template <int D>
__device__ __forceinline__ void mma_scores(float (&acc)[8][4], const bf16* A, int r0,
                                           const bf16* Y, int g, int tig) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nb][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    frag_a<D>(a, A, r0, kk, g, tig);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const bf16* p = Y + (nb * 8 + g) * (D + 8) + kk * 16 + tig * 2;
      mma_bf16(acc[nb], a, ld32(p), ld32(p + 8));
    }
  }
}

// acc[nb] += X(16 x 64, the f32 accumulator fragments x, rounded to bf16) .
// Z for a transposed tile Zt [D][64 + 8] (Z[t][n] = Zt[n][t]).
template <int D>
__device__ __forceinline__ void mma_rows_by_tile(float (&acc)[D / 8][4], const float (&x)[8][4],
                                                 const bf16* Zt, int g, int tig) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t a[4] = {pack_bf16(x[2 * j][0], x[2 * j][1]),
                           pack_bf16(x[2 * j][2], x[2 * j][3]),
                           pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]),
                           pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3])};
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const bf16* p = Zt + (nb * 8 + g) * kTS + j * 16 + tig * 2;
      mma_bf16(acc[nb], a, ld32(p), ld32(p + 8));
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
constexpr size_t fwd_mma_smem() {  // sQ, sK, sVt, sValid
  return 2 * (2 * kTile * (D + 8) + D * kTS) + sizeof(float) * kTile;
}
template <int D>
constexpr size_t dq_mma_smem() {  // sQ, sdO, sK, sV, sKt, sValid, sLse, sDsum
  return 2 * (4 * kTile * (D + 8) + D * kTS) + sizeof(float) * 3 * kTile;
}
template <int D>
constexpr size_t dkv_mma_smem() {  // sK, sV, sQ, sdO, sQt, sdOt, sValid, sLse, sDsum
  return 2 * (4 * kTile * (D + 8) + 2 * D * kTS) + sizeof(float) * 3 * kTile;
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma_kernel(const Args a) {
  constexpr int NB = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kTile * (D + 8);
  bf16* sVt = sK + kTile * (D + 8);
  float* sValid = reinterpret_cast<float*>(sVt + D * kTS);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int tig = threadIdx.x & 3;
  const int r0 = warp * 16;  // the warp's rows in the tile
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);

  load_tile_bf16<D>(sQ, static_cast<const bf16*>(a.q), b, h, q0, a.Lq, a.H);
  // rows g and g + 8 of the warp's 16: m, l per row; o[nb] = the 4
  // accumulators (row g: cols 2 tig, 2 tig + 1; row g + 8: the same)
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float o[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nb][c] = 0.f;
  const int k_end = kCausal ? min(a.Lk, q0 + kTile) : a.Lk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile_bf16<D>(sK, k, b, h, k0, a.Lk, a.H);
    load_tile_bf16_t<D>(sVt, v, b, h, k0, a.Lk, a.H);
    load_valid(sValid, a.valid, b, k0, a.Lk);
    __syncthreads();
    float s[8][4];
    mma_scores<D>(s, sQ, r0, sK, g, tig);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = nb * 8 + tig * 2 + (c & 1);
        const int qpos = q0 + r0 + g + 8 * (c >> 1);
        const bool keep = sValid[key] > 0.f && (!kCausal || k0 + key <= qpos);
        s[nb][c] = keep ? s[nb][c] * a.scale : kNeg;
        mx[c >> 1] = fmaxf(mx[c >> 1], s[nb][c]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float x = s[nb][c];
        const float p = x <= 0.5f * kNeg ? 0.f : expf(x - m[c >> 1]);
        s[nb][c] = p;
        rs[c >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(rs[i]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[nb][c] *= alpha[c >> 1];
    mma_rows_by_tile<D>(o, s, sVt, g, tig);
  }
  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    if (row >= a.Lq) continue;
    const float lc = fmaxf(l[i], 1e-9f);
    bf16* orow = out + (((size_t)b * a.Lq + row) * a.H + h) * D + tig * 2;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      *reinterpret_cast<uint32_t*>(orow + nb * 8) =
          pack_bf16(o[nb][2 * i] / lc, o[nb][2 * i + 1] / lc);
    if (tig == 0) a.lse_out[((size_t)b * a.H + h) * a.Lq + row] = m[i] + logf(lc);
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kMmaThreads) flash_dq_mma_kernel(const Args a) {
  constexpr int NB = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + kTile * (D + 8);
  bf16* sK = sdO + kTile * (D + 8);
  bf16* sV = sK + kTile * (D + 8);
  bf16* sKt = sV + kTile * (D + 8);
  float* sValid = reinterpret_cast<float*>(sKt + D * kTS);
  float* sLse = sValid + kTile;
  float* sDsum = sLse + kTile;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int tig = threadIdx.x & 3;
  const int r0 = warp * 16;
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);

  load_tile_bf16<D>(sQ, static_cast<const bf16*>(a.q), b, h, q0, a.Lq, a.H);
  load_tile_bf16<D>(sdO, static_cast<const bf16*>(a.dout), b, h, q0, a.Lq, a.H);
  load_rows(sLse, a.lse, b, h, q0, a.Lq, a.H);
  load_rows(sDsum, a.dsum, b, h, q0, a.Lq, a.H);
  float acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nb][c] = 0.f;
  const int k_end = kCausal ? min(a.Lk, q0 + kTile) : a.Lk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile_bf16<D>(sK, k, b, h, k0, a.Lk, a.H);
    load_tile_bf16<D>(sV, v, b, h, k0, a.Lk, a.H);
    load_tile_bf16_t<D>(sKt, k, b, h, k0, a.Lk, a.H);
    load_valid(sValid, a.valid, b, k0, a.Lk);
    __syncthreads();
    float s[8][4], dp[8][4];
    mma_scores<D>(s, sQ, r0, sK, g, tig);
    mma_scores<D>(dp, sdO, r0, sV, g, tig);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = nb * 8 + tig * 2 + (c & 1);
        const int r = r0 + g + 8 * (c >> 1);
        const bool keep = sValid[key] > 0.f && (!kCausal || k0 + key <= q0 + r);
        const float x = keep ? s[nb][c] * a.scale : kNeg;
        const float p = x <= 0.5f * kNeg ? 0.f : expf(x - sLse[r]);
        s[nb][c] = p * (dp[nb][c] - sDsum[r]) * a.scale;  // dS
      }
    mma_rows_by_tile<D>(acc, s, sKt, g, tig);
  }
  bf16* dq = static_cast<bf16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    if (row >= a.Lq) continue;
    bf16* qrow = dq + (((size_t)b * a.Lq + row) * a.H + h) * D + tig * 2;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      *reinterpret_cast<uint32_t*>(qrow + nb * 8) =
          pack_bf16(acc[nb][2 * i], acc[nb][2 * i + 1]);
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kMmaThreads) flash_dkv_mma_kernel(const Args a) {
  constexpr int NB = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kTile * (D + 8);
  bf16* sQ = sV + kTile * (D + 8);
  bf16* sdO = sQ + kTile * (D + 8);
  bf16* sQt = sdO + kTile * (D + 8);
  bf16* sdOt = sQt + D * kTS;
  float* sValid = reinterpret_cast<float*>(sdOt + D * kTS);
  float* sLse = sValid + kTile;
  float* sDsum = sLse + kTile;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int tig = threadIdx.x & 3;
  const int r0 = warp * 16;  // the warp's keys in the tile
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* dout = static_cast<const bf16*>(a.dout);

  load_tile_bf16<D>(sK, static_cast<const bf16*>(a.k), b, h, k0, a.Lk, a.H);
  load_tile_bf16<D>(sV, static_cast<const bf16*>(a.v), b, h, k0, a.Lk, a.H);
  load_valid(sValid, a.valid, b, k0, a.Lk);
  float dk[NB][4], dv[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[nb][c] = dv[nb][c] = 0.f;
  for (int q0 = kCausal ? k0 : 0; q0 < a.Lq; q0 += kTile) {
    __syncthreads();
    load_tile_bf16<D>(sQ, q, b, h, q0, a.Lq, a.H);
    load_tile_bf16<D>(sdO, dout, b, h, q0, a.Lq, a.H);
    load_tile_bf16_t<D>(sQt, q, b, h, q0, a.Lq, a.H);
    load_tile_bf16_t<D>(sdOt, dout, b, h, q0, a.Lq, a.H);
    load_rows(sLse, a.lse, b, h, q0, a.Lq, a.H);
    load_rows(sDsum, a.dsum, b, h, q0, a.Lq, a.H);
    __syncthreads();
    // transposed tiles: rows are keys, columns queries
    float st[8][4], dpt[8][4];
    mma_scores<D>(st, sK, r0, sQ, g, tig);
    mma_scores<D>(dpt, sV, r0, sdO, g, tig);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qc = nb * 8 + tig * 2 + (c & 1);
        const int r = r0 + g + 8 * (c >> 1);
        const bool keep = sValid[r] > 0.f && q0 + qc < a.Lq &&
                          (!kCausal || k0 + r <= q0 + qc);
        const float x = keep ? st[nb][c] * a.scale : kNeg;
        const float p = x <= 0.5f * kNeg ? 0.f : expf(x - sLse[qc]);
        st[nb][c] = p;
        dpt[nb][c] = p * (dpt[nb][c] - sDsum[qc]) * a.scale;  // dS^T
      }
    mma_rows_by_tile<D>(dv, st, sdOt, g, tig);
    mma_rows_by_tile<D>(dk, dpt, sQt, g, tig);
  }
  bf16* dk_out = static_cast<bf16*>(a.dk);
  bf16* dv_out = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + r0 + g + 8 * i;
    if (row >= a.Lk) continue;
    const size_t off = (((size_t)b * a.Lk + row) * a.H + h) * D + tig * 2;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      *reinterpret_cast<uint32_t*>(dk_out + off + nb * 8) =
          pack_bf16(dk[nb][2 * i], dk[nb][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv_out + off + nb * 8) =
          pack_bf16(dv[nb][2 * i], dv[nb][2 * i + 1]);
    }
  }
}

// --- launch ------------------------------------------------------------

template <typename Kern>
int run(Kern kern, dim3 grid, int threads, size_t smem, const Args& a,
        cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

int tiles(int n) { return (n + kTile - 1) / kTile; }

// f32 on the CUDA cores, bf16 on the tensor cores
template <typename T, int D, bool C>
struct Fwd {
  static int go(const Args& a, cudaStream_t s) {
    const dim3 grid(tiles(a.Lq), a.H, a.B);
    if constexpr (std::is_same<T, bf16>::value)
      return run(flash_fwd_mma_kernel<D, C>, grid, kMmaThreads, fwd_mma_smem<D>(), a, s);
    else
      return run(flash_fwd_kernel<D, C>, grid, kThreads, fwd_smem<D>(), a, s);
  }
};

template <typename T, int D, bool C>
struct Dq {
  static int go(const Args& a, cudaStream_t s) {
    const dim3 grid(tiles(a.Lq), a.H, a.B);
    if constexpr (std::is_same<T, bf16>::value)
      return run(flash_dq_mma_kernel<D, C>, grid, kMmaThreads, dq_mma_smem<D>(), a, s);
    else
      return run(flash_dq_kernel<D, C>, grid, kThreads, dq_smem<D>(), a, s);
  }
};

template <typename T, int D, bool C>
struct Dkv {
  static int go(const Args& a, cudaStream_t s) {
    const dim3 grid(tiles(a.Lk), a.H, a.B);
    if constexpr (std::is_same<T, bf16>::value)
      return run(flash_dkv_mma_kernel<D, C>, grid, kMmaThreads, dkv_mma_smem<D>(), a, s);
    else
      return run(flash_dkv_kernel<D, C>, grid, kThreads, dkv_smem<D>(), a, s);
  }
};

template <template <typename, int, bool> class K>
int dispatch(Args a, int D, int causal, int dtype, void* stream) {
  if (a.B < 1 || a.Lq < 1 || a.Lk < 1 || a.H < 1 || a.H > 65535 || a.B > 65535)
    return (int)cudaErrorInvalidValue;
  a.scale = 1.f / sqrtf((float)D);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  if (dtype == kF32 && D == 64) return c ? K<float, 64, true>::go(a, s) : K<float, 64, false>::go(a, s);
  if (dtype == kF32 && D == 128) return c ? K<float, 128, true>::go(a, s) : K<float, 128, false>::go(a, s);
  if (dtype == kBF16 && D == 64)
    return c ? K<__nv_bfloat16, 64, true>::go(a, s) : K<__nv_bfloat16, 64, false>::go(a, s);
  if (dtype == kBF16 && D == 128)
    return c ? K<__nv_bfloat16, 128, true>::go(a, s) : K<__nv_bfloat16, 128, false>::go(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// All tensors contiguous on one card. q, out [B, Lq, H, D] and k, v
// [B, Lk, H, D] in `dtype` (0 f32, 1 bf16), D 64 or 128; valid [B, Lk] f32;
// lse [B, H, Lq] f32. Each returns cudaGetLastError() after its launch.
extern "C" int kubeml_flash_fwd(const void* q, const void* k, const void* v,
                                const void* valid, void* out, void* lse, int B,
                                int Lq, int Lk, int H, int D, int causal,
                                int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.valid = static_cast<const float*>(valid);
  a.out = out;
  a.lse_out = static_cast<float*>(lse);
  a.B = B;
  a.Lq = Lq;
  a.Lk = Lk;
  a.H = H;
  return dispatch<Fwd>(a, D, causal, dtype, stream);
}

// dout [B, Lq, H, D] in `dtype`; dsum [B, H, Lq] f32; dq like q.
extern "C" int kubeml_flash_dq(const void* q, const void* k, const void* v,
                               const void* valid, const void* lse,
                               const void* dout, const void* dsum, void* dq,
                               int B, int Lq, int Lk, int H, int D, int causal,
                               int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.valid = static_cast<const float*>(valid);
  a.lse = static_cast<const float*>(lse);
  a.dout = dout;
  a.dsum = static_cast<const float*>(dsum);
  a.out = dq;
  a.B = B;
  a.Lq = Lq;
  a.Lk = Lk;
  a.H = H;
  return dispatch<Dq>(a, D, causal, dtype, stream);
}

// dk, dv like k and v.
extern "C" int kubeml_flash_dkv(const void* q, const void* k, const void* v,
                                const void* valid, const void* lse,
                                const void* dout, const void* dsum, void* dk,
                                void* dv, int B, int Lq, int Lk, int H, int D,
                                int causal, int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.valid = static_cast<const float*>(valid);
  a.lse = static_cast<const float*>(lse);
  a.dout = dout;
  a.dsum = static_cast<const float*>(dsum);
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.Lq = Lq;
  a.Lk = Lk;
  a.H = H;
  return dispatch<Dkv>(a, D, causal, dtype, stream);
}
