// Flash attention for Hopper (sm_90a): the forward and the FlashAttention-2
// backward (dQ, then dK/dV) over [B, L, H, D] tensors read in place.
//
// Replaces the three Pallas TPU kernels of kubeml_tpu/ops/flash_attention.py:
//   flash_fwd_kernel (f32), flash_fwd_wgmma_kernel (bf16) <- _fa_kernel
//       (wrapper _flash_fwd_impl)
//   flash_dq_kernel (f32), flash_dq_mma_kernel (bf16)     <- _dq_kernel
//       (wrapper _flash_bwd_impl, first call)
//   flash_dkv_kernel (f32), flash_dkv_wgmma_kernel (bf16) <- _dkv_kernel
//       (wrapper _flash_bwd_impl, second call)
//
// What bounds them on an H100: operations. At the training shape (L 2048,
// D 64) each K/V tile read from device memory feeds a whole tile of
// scores, two to four products of 2 x D flops per (query, key) pair; the
// bytes moved are O(L x D) per (b, h) while the work is O(L^2 x D), far
// above the card's ridge from L ~ 1024 on. So the designs keep every
// intermediate on chip, do no work twice across blocks, and aim to keep
// the tensor cores busy:
//   * the TPU's sequential grid axis becomes a loop inside one block. The
//     forward and dQ kernels take one block per (b, h, query tile) and walk
//     the K/V tiles, stopping at the diagonal when causal; the dK/dV
//     kernels take one block per (b, h, key tile) and walk the Q/dO tiles,
//     starting at the diagonal when causal. Every block owns its output
//     tile, so there are no atomics and the gradients are bit-identical
//     from run to run;
//   * bf16 forward and dK/dV (the training path's two largest kernels) use
//     what only Hopper has (see the wgmma section below): warpgroup wgmma
//     products, the only way to the tensor cores' full rate, with operands
//     read from shared memory through descriptors (V, dO and Q transposed
//     by the descriptor, no transposed copies); tiles brought by the Tensor
//     Memory Accelerator into a two-stage ring by a producer warp, so the
//     next tile loads while the current one is multiplied; two consumer
//     warpgroups of 64 rows each (128-row tiles: each K/V or Q/dO tile read
//     feeds 128 rows; dK/dV at D 128 keeps one, for registers); the
//     per-element mask only on tiles that cross the causal diagonal, run
//     past L or hold a padded key (one vote per tile), and the softmax in
//     exp2 with scale * log2(e) folded into one FMA;
//   * bf16 dQ still uses mma.sync m16n8k16 (Ampere-style warp products with
//     plain loads into shared memory, K transposed by 2-byte stores), 4
//     warps per 64-query block; its redesign is the next step;
//   * f32 inputs compute in f32 on the CUDA cores, so the chain to the CPU
//     tests stays exact: tiles staged in shared memory as f32, each of 256
//     threads holding a 4 x 4 block of the score tile in registers (rows
//     ty + 16 i, columns tx + 16 j), so one shared-memory read feeds two
//     FMAs. In all kernels the online softmax (running max m, sum l) and
//     the accumulators stay in registers, the row reductions are shuffles;
//   * ragged ends of Lq and Lk are masked in the kernel (rows past L load
//     as zeros, by TMA's out-of-bounds fill in the wgmma kernels, and are
//     never stored), with no padding or transposes.
// Arithmetic follows the Pallas kernels: scores are the f32 product times
// 1/sqrt(D); masked scores are -1e30 and their weights exactly 0, so fully
// masked rows give output 0, lse ~ -1e30 and zero gradients, and padded
// keys get exactly zero dK and dV; the row sum is clamped at 1e-9; P is
// rounded to the input dtype before P.V and P^T.dO, dS before dS.K and
// dS^T.Q; lse is the natural-log f32 [B, H, Lq]. Causal masking is
// top-left aligned: key k attends query q when k <= q, both counted from
// 0, also when Lq != Lk.

#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is fetched at run time
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

// --- bf16 dQ on the tensor cores with mma.sync ----------------------------
//
// mma.sync m16n8k16 (bf16 in, f32 accumulate): 4 warps per block, each warp
// owns 16 rows of the block's 64-row tile. Tiles sit in shared memory as
// bf16, rows padded by 8 elements so the fragment loads hit 32 distinct
// banks; the right-hand operand of dS.K is staged transposed ([D][64]). The
// score tile's accumulator fragments are, pair by pair, the left-hand
// fragments of the next product (dS), so dS never leaves registers; it is
// rounded to bf16 by that packing, as the Pallas kernel casts it. The
// wgmma kernels below reuse that fragment layout: a wgmma accumulator is
// the same per-warp pattern over 64 rows.

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
constexpr size_t dq_mma_smem() {  // sQ, sdO, sK, sV, sKt, sValid, sLse, sDsum
  return 2 * (4 * kTile * (D + 8) + D * kTS) + sizeof(float) * 3 * kTile;
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

// --- bf16 forward and dK/dV: Hopper warpgroups fed by TMA -------------------
//
// flash_fwd_wgmma_kernel and flash_dkv_wgmma_kernel: consumer warpgroups
// (two; one for dK/dV at D 128, see dkv_groups) that each own 64 rows of
// the block's tile and multiply with wgmma, then one producer warp that
// streams tiles into a ring of kStages shared-memory stages with the Tensor
// Memory Accelerator. Every stage has a full mbarrier (32 producer lanes
// arrive, TMA adds the bytes) and an empty one (the consumer warps arrive
// once their products have read it). A producer warp rather than a
// producer warpgroup, and no setmaxnreg: ptxas gives every thread of the
// block the same register budget whether or not setmaxnreg moves registers
// at run time, so a whole producer warpgroup would only shrink the
// consumers' budget (168 registers a thread at 384 threads, as at 288). Each
// [B, L, H, D] tensor is a 4-D TMA map (D, H, L, B) read in place, boxes of
// 64 columns (128 bytes, 128-byte swizzle) by the tile's rows; rows past L
// arrive as zeros, and a box never leaves its (b, h) slice. The wgmma
// descriptors match that layout: 8-row atoms of 1024 bytes, K-major for
// the operands whose reduction runs along D, MN-major (transposed by the
// descriptor, no copy) for V, dO and Q where it runs along the rows.

constexpr int kWgThreads = 128;             // one warpgroup
constexpr int kFwdThreads = 2 * kWgThreads + 32;  // two consumers + producer
constexpr int kFwdRows = 128;               // queries per forward block
constexpr int kFwdKeys = 128;               // keys per forward K/V tile
constexpr int kDkvRows = 64;                // queries per dK/dV Q/dO tile
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kFwdKeys == 128 && kDkvRows == 64 && kFwdRows == 2 * 64,
              "two 64-row forward warpgroups; score products m64n128 and m64n64");

// Consumer warpgroups of a dK/dV block, each owning 64 keys: two at D 64;
// one at D 128, where dK and dV (128 f32 accumulators a thread) with S^T
// and dP^T need up to 254 registers. ptxas sizes registers for a block's
// threads rounded up to whole warpgroups: 168 a thread for two consumer
// warpgroups and the producer warp (288 -> 384), 255 for one (160 -> 256).
template <int D>
__host__ __device__ constexpr int dkv_groups() {
  return D == 64 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int dkv_threads() {
  return dkv_groups<D>() * kWgThreads + 32;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Until the phase of parity `parity` has completed. A wait of seconds means
// a lost arrival or transfer: trap (a launch error) rather than hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 33)) __trap();
}

// One box of a 4-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accesses of wgmma accumulators across the
// asynchronous products
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a TMA tile in shared memory, 128-byte swizzle: start
// address, leading byte offset `lbo` (MN-major operands: from one 64-column
// box to the next; unused by K-major ones) and stride byte offset 1024
// (from one 8-row atom to the next). Offsets within the tile are added to
// the low field in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d (+)= A . B^T over one k16 step, A and B both in shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A . B over one k16 step, A (bf16 pairs) in registers, B in shared
// memory MN-major (the descriptor transposes it)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (+)= A . B^T over one k16 step, A and B both in shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A . B over one k16 step, A (bf16 pairs) in registers, B in shared
// memory MN-major (the descriptor transposes it)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Shared memory of the forward, byte offsets from a 1024-aligned base:
// Q [D/64 boxes][128 rows][128 B]; kStages K and V tiles, the same shape;
// kv_valid and the tile's all-real vote per stage; the mbarriers.
template <int D>
struct FwdSmem {
  static constexpr int kTile = kFwdKeys * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kFwdRows * D * 2;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kValid = kV + kStages * kTile;
  static constexpr int kFlag = kValid + kStages * kFwdKeys * 4;
  static constexpr int kBar = kFlag + 16;  // full[kStages], empty[kStages], q
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + 1024;  // + alignment
};

// One K/V tile's scores s (raw products, 64 rows x 128 keys of this
// warpgroup; thread holds rows g and g + 8 of its warp's 16) into f32
// weights p in place, in the exp2 domain with scale * log2(e) folded into
// one FMA. m is the running max of the raw scores; alpha the factor that
// rescales the previous tiles. kMask: the tile crosses the causal diagonal
// or holds a padded key, so each score is checked; interior tiles skip it.
template <bool kMask, bool kCausal>
__device__ __forceinline__ void fwd_softmax(float (&s)[kFwdKeys / 2], float (&m)[2],
                                            float (&l)[2], float (&alpha)[2],
                                            const float* valid, int k0, int qrow, float c2,
                                            int t4) {
  if (kMask) {
#pragma unroll
    for (int i = 0; i < kFwdKeys / 2; ++i) {
      const int key = 8 * (i >> 2) + 2 * t4 + (i & 1);
      const bool keep =
          valid[key] > 0.f && (!kCausal || k0 + key <= qrow + 8 * ((i >> 1) & 1));
      if (!keep) s[i] = kNeg;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < kFwdKeys / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    alpha[r] = fast_exp2((m[r] - mx[r]) * c2);
    m[r] = mx[r];
    mc[r] = mx[r] * c2;
  }
#pragma unroll
  for (int i = 0; i < kFwdKeys / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float p = fast_exp2(fmaf(s[i], c2, -mc[r]));
    s[i] = kMask && s[i] <= 0.5f * kNeg ? 0.f : p;
    rs[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
}

// Forward, bf16 (replaces _fa_kernel): one block per (128-query tile, h, b),
// longest causal walks first. Each consumer warpgroup: S = Q K^T as SS
// wgmma m64n128k16 (Q and K K-major), the online softmax on the
// accumulators, then O += P V as RS wgmma m64nDk16 with the S accumulators
// packed to bf16 pairs as the A fragments and V read MN-major.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_wgmma_kernel(const Args a, const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv) {
  using S = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  float* sValid = reinterpret_cast<float*>(sm + S::kValid);
  int* sFlag = reinterpret_cast<int*>(sm + S::kFlag);
  const uint32_t full = base + S::kBar, empty = full + 8 * kStages,
                 qbar = empty + 8 * kStages;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFwdRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k_end = kCausal ? min(a.Lk, q0 + kFwdRows) : a.Lk;
  const int n_tiles = (k_end + kFwdKeys - 1) / kFwdKeys;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * kWgThreads) {  // the producer warp
    const int lane = threadIdx.x - 2 * kWgThreads;
    if (lane == 0) {
      mbar_expect_tx(qbar, kFwdRows * D * 2);
      for (int c = 0; c < D / 64; ++c)
        tma_load(base + S::kQ + c * kFwdRows * 128, &tq, qbar, 64 * c, h, q0, b);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);
      const int k0 = t * kFwdKeys;
      bool all = true;
      for (int j = lane; j < kFwdKeys; j += 32) {
        const float v = k0 + j < a.Lk ? a.valid[(size_t)b * a.Lk + k0 + j] : 0.f;
        sValid[s * kFwdKeys + j] = v;
        all = all && v > 0.f;
      }
      all = __all_sync(0xffffffffu, all);
      if (lane == 0) {
        sFlag[s] = all;
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, 2 * S::kTile);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(base + S::kK + s * S::kTile + c * kFwdKeys * 128, &tk, bar, 64 * c, h, k0, b);
          tma_load(base + S::kV + s * S::kTile + c * kFwdKeys * 128, &tv, bar, 64 * c, h, k0, b);
        }
      } else {
        mbar_arrive(full + 8 * s);
      }
    }
  } else {  // consumers: warpgroup cw owns query rows q0 + 64 cw ..
    const int cw = threadIdx.x / kWgThreads;
    const int tid = threadIdx.x % kWgThreads;
    const int w4 = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int qw0 = q0 + 64 * cw;
    const int qrow = qw0 + 16 * w4 + g;  // this thread's rows: qrow, qrow + 8
    const float c2 = a.scale * kLog2e;
    // operands: Q rows of this warpgroup, K (both K-major), V (MN-major);
    // descriptors are built at each product from 32-bit shared addresses
    const uint32_t sq = base + S::kQ + cw * 64 * 128;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    mbar_wait(qbar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(full + 8 * s, (t / kStages) & 1);
      const int k0 = t * kFwdKeys;
      float sc[kFwdKeys / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {  // k16 steps: 32 bytes within a box
        const uint32_t offq = (kk >> 2) * kFwdRows * 128 + (kk & 3) * 32;
        const uint32_t offk = (kk >> 2) * kFwdKeys * 128 + (kk & 3) * 32;
        wgmma_ss_n128(sc, sw128_desc(sq + offq, 16),
                      sw128_desc(base + S::kK + s * S::kTile + offk, 16), kk > 0);
      }
      wg_commit();
      wg_wait0();
      reg_fence(sc);
      float alpha[2];
      if (!sFlag[s] || (kCausal && k0 + kFwdKeys - 1 > qw0))
        fwd_softmax<true, kCausal>(sc, m, l, alpha, sValid + s * kFwdKeys, k0, qrow, c2, t4);
      else
        fwd_softmax<false, kCausal>(sc, m, l, alpha, sValid + s * kFwdKeys, k0, qrow, c2, t4);
      uint32_t pa[kFwdKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      reg_fence(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 16; ++kk) {  // 16 keys = 2 atoms of 8 rows
        const uint64_t db =
            sw128_desc(base + S::kV + s * S::kTile + kk * 16 * 128, kFwdKeys * 128);
        if constexpr (D == 64)
          wgmma_rs_n64(o, pa[kk], db);
        else
          wgmma_rs_n128(o, pa[kk], db);
      }
      wg_commit();
      wg_wait0();
      reg_fence(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow + 8 * r;
      if (row >= a.Lq) continue;
      const float lc = fmaxf(l[r], 1e-9f);
      const float inv = 1.f / lc;
      bf16* orow = out + (((size_t)b * a.Lq + row) * a.H + h) * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      if (t4 == 0)
        a.lse_out[((size_t)b * a.H + h) * a.Lq + row] =
            (m[r] <= 0.5f * kNeg ? kNeg : m[r] * a.scale) + logf(lc);
    }
  }
}

// Shared memory of dK/dV: K and V of the block's keys; kStages Q and dO
// tiles of 64 queries; per stage the tile's lse * log2(e) and dsum; the
// mbarriers.
template <int D>
struct DkvSmem {
  static constexpr int kTile = kDkvRows * D * 2;
  static constexpr int kK = 0;
  static constexpr int kKeys = 64 * dkv_groups<D>();
  static constexpr int kV = kK + kKeys * D * 2;
  static constexpr int kQ = kV + kKeys * D * 2;
  static constexpr int kdO = kQ + kStages * kTile;
  static constexpr int kLse = kdO + kStages * kTile;
  static constexpr int kDsum = kLse + kStages * kDkvRows * 4;
  static constexpr int kBar = kDsum + kStages * kDkvRows * 4;  // full, empty, kv
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + 1024;
};

// dK/dV, bf16 (replaces _dkv_kernel): one block per (key tile, h, b),
// walking the Q/dO tiles (from the diagonal when causal). Each consumer
// warpgroup owns 64 keys: S^T = K Q^T and dP^T = V dO^T as SS wgmma
// m64n64k16; P^T and dS^T = P^T (dP^T - dsum) scale stay in registers and
// feed dV += P^T dO and dK += dS^T Q as RS wgmma m64nDk16, dO and Q read
// MN-major.
template <int D, bool kCausal>
__global__ void __launch_bounds__(dkv_threads<D>(), 1)
    flash_dkv_wgmma_kernel(const Args a, const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo) {
  using S = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  float* sLse = reinterpret_cast<float*>(sm + S::kLse);
  float* sDsum = reinterpret_cast<float*>(sm + S::kDsum);
  const uint32_t full = base + S::kBar, empty = full + 8 * kStages,
                 kvbar = empty + 8 * kStages;
  constexpr int kKeys = S::kKeys;
  constexpr int kCons = dkv_groups<D>();
  const int k0 = blockIdx.x * kKeys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // causal: queries before k0 see none of this block's keys
  const int q_begin = kCausal ? k0 : 0;
  const int n_tiles = q_begin < a.Lq ? (a.Lq - q_begin + kDkvRows - 1) / kDkvRows : 0;
  bool real = true;  // are all the block's keys real (and below Lk)?
  if (threadIdx.x < kKeys) {
    const int key = k0 + threadIdx.x;
    real = key < a.Lk && a.valid[(size_t)b * a.Lk + key] > 0.f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, 4 * kCons);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const bool all_real = __syncthreads_and(real);

  if (threadIdx.x >= kCons * kWgThreads) {  // the producer warp
    const int lane = threadIdx.x - kCons * kWgThreads;
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * kKeys * D * 2);
      for (int c = 0; c < D / 64; ++c) {
        tma_load(base + S::kK + c * kKeys * 128, &tk, kvbar, 64 * c, h, k0, b);
        tma_load(base + S::kV + c * kKeys * 128, &tv, kvbar, 64 * c, h, k0, b);
      }
    }
    const size_t rows = ((size_t)b * a.H + h) * a.Lq;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);
      const int q0 = q_begin + t * kDkvRows;
      for (int j = lane; j < kDkvRows; j += 32) {
        const bool in = q0 + j < a.Lq;
        sLse[s * kDkvRows + j] = in ? a.lse[rows + q0 + j] * kLog2e : 0.f;
        sDsum[s * kDkvRows + j] = in ? a.dsum[rows + q0 + j] : 0.f;
      }
      if (lane == 0) {
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, 2 * S::kTile);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(base + S::kQ + s * S::kTile + c * kDkvRows * 128, &tq, bar, 64 * c, h, q0, b);
          tma_load(base + S::kdO + s * S::kTile + c * kDkvRows * 128, &tdo, bar, 64 * c, h, q0,
                   b);
        }
      } else {
        mbar_arrive(full + 8 * s);
      }
    }
  } else {  // consumers: warpgroup cw owns keys k0 + 64 cw ..
    const int cw = threadIdx.x / kWgThreads;
    const int tid = threadIdx.x % kWgThreads;
    const int w4 = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int kw0 = k0 + 64 * cw;
    const int krow = kw0 + 16 * w4 + g;  // this thread's keys: krow, krow + 8
    bool key_ok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      key_ok[r] = krow + 8 * r < a.Lk && a.valid[(size_t)b * a.Lk + krow + 8 * r] > 0.f;
    const float c2 = a.scale * kLog2e;
    // operands: K, V rows of this warpgroup and the Q, dO tiles, K-major
    // for S^T and dP^T, Q and dO MN-major for dK and dV; descriptors are
    // built at each product from 32-bit shared addresses
    const uint32_t sk = base + S::kK + cw * 64 * 128;
    const uint32_t sv = base + S::kV + cw * 64 * 128;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kvbar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(full + 8 * s, (t / kStages) & 1);
      const int q0 = q_begin + t * kDkvRows;
      const uint32_t sq = base + S::kQ + s * S::kTile;
      const uint32_t sdo = base + S::kdO + s * S::kTile;
      float st[kDkvRows / 2], dpt[kDkvRows / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {  // k16 steps: 32 bytes within a box
        const uint32_t offa = (kk >> 2) * kKeys * 128 + (kk & 3) * 32;
        const uint32_t offb = (kk >> 2) * kDkvRows * 128 + (kk & 3) * 32;
        wgmma_ss_n64(st, sw128_desc(sk + offa, 16), sw128_desc(sq + offb, 16), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t offa = (kk >> 2) * kKeys * 128 + (kk & 3) * 32;
        const uint32_t offb = (kk >> 2) * kDkvRows * 128 + (kk & 3) * 32;
        wgmma_ss_n64(dpt, sw128_desc(sv + offa, 16), sw128_desc(sdo + offb, 16), kk > 0);
      }
      wg_commit();
      wg_wait0();
      reg_fence(st);
      reg_fence(dpt);
      const float* lse2 = sLse + s * kDkvRows;
      const float* dsum = sDsum + s * kDkvRows;
      // a tile needs the per-element mask if it crosses the diagonal, runs
      // past Lq or the block holds a padded key
      const bool masked =
          !all_real || q0 + kDkvRows > a.Lq || (kCausal && q0 < kw0 + 63);
#pragma unroll
      for (int i = 0; i < kDkvRows / 2; ++i) {
        const int col = 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int r = (i >> 1) & 1;
        float p = fast_exp2(fmaf(st[i], c2, -lse2[col]));
        if (masked) {
          const bool keep = key_ok[r] && q0 + col < a.Lq &&
                            (!kCausal || krow + 8 * r <= q0 + col);
          p = keep ? p : 0.f;
        }
        st[i] = p;
        dpt[i] = p * (dpt[i] - dsum[col]) * a.scale;
      }
      uint32_t pa[kDkvRows / 16][4], da[kDkvRows / 16][4];
#pragma unroll
      for (int kk = 0; kk < kDkvRows / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kk][e] = pack_bf16(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
          da[kk][e] = pack_bf16(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
        }
      reg_fence(dv);
      reg_fence(dk);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kDkvRows / 16; ++kk) {  // 16 queries = 2 atoms
        const uint64_t bdo = sw128_desc(sdo + kk * 16 * 128, kDkvRows * 128);
        const uint64_t bq = sw128_desc(sq + kk * 16 * 128, kDkvRows * 128);
        if constexpr (D == 64) {
          wgmma_rs_n64(dv, pa[kk], bdo);
          wgmma_rs_n64(dk, da[kk], bq);
        } else {
          wgmma_rs_n128(dv, pa[kk], bdo);
          wgmma_rs_n128(dk, da[kk], bq);
        }
      }
      wg_commit();
      wg_wait0();
      reg_fence(dv);
      reg_fence(dk);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    bf16* dk_out = static_cast<bf16*>(a.dk);
    bf16* dv_out = static_cast<bf16*>(a.dv);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = krow + 8 * r;
      if (row >= a.Lk) continue;
      const size_t off = (((size_t)b * a.Lk + row) * a.H + h) * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk_out + off + 8 * j) =
            pack_bf16(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv_out + off + 8 * j) =
            pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// --- launch ------------------------------------------------------------

// `maps`: the wgmma kernels' TMA maps, passed by value
template <typename Kern, typename... Maps>
int run(Kern kern, dim3 grid, int threads, size_t smem, const Args& a,
        cudaStream_t s, const Maps&... maps) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, threads, smem, s>>>(a, maps...);
  return (int)cudaGetLastError();
}

int tiles(int n) { return (n + kTile - 1) / kTile; }

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), fetched through the runtime's entry
// point query (no link against libcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 [B, L, H, D] tensor as the 4-D map (D, H, L, B): boxes of 64
// columns by `rows` rows of one (b, h), 128-byte swizzle, rows past L
// filled with zeros. Built on every call (the pointers change).
int bf16_map(CUtensorMap* map, const void* p, int B, int L, int H, int D, int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)L * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
                         strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// f32 on the CUDA cores; bf16 forward and dK/dV with wgmma and TMA, bf16
// dQ with mma.sync
template <typename T, int D, bool C>
struct Fwd {
  static int go(const Args& a, cudaStream_t s) {
    if constexpr (std::is_same<T, bf16>::value) {
      CUtensorMap tq, tk, tv;
      int e;
      if ((e = bf16_map(&tq, a.q, a.B, a.Lq, a.H, D, kFwdRows)) ||
          (e = bf16_map(&tk, a.k, a.B, a.Lk, a.H, D, kFwdKeys)) ||
          (e = bf16_map(&tv, a.v, a.B, a.Lk, a.H, D, kFwdKeys)))
        return e;
      const dim3 grid((a.Lq + kFwdRows - 1) / kFwdRows, a.H, a.B);
      return run(flash_fwd_wgmma_kernel<D, C>, grid, kFwdThreads, FwdSmem<D>::kBytes, a, s, tq,
                 tk, tv);
    } else {
      return run(flash_fwd_kernel<D, C>, dim3(tiles(a.Lq), a.H, a.B), kThreads, fwd_smem<D>(),
                 a, s);
    }
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
    if constexpr (std::is_same<T, bf16>::value) {
      CUtensorMap tq, tk, tv, tdo;
      int e;
      if ((e = bf16_map(&tq, a.q, a.B, a.Lq, a.H, D, kDkvRows)) ||
          (e = bf16_map(&tk, a.k, a.B, a.Lk, a.H, D, DkvSmem<D>::kKeys)) ||
          (e = bf16_map(&tv, a.v, a.B, a.Lk, a.H, D, DkvSmem<D>::kKeys)) ||
          (e = bf16_map(&tdo, a.dout, a.B, a.Lq, a.H, D, kDkvRows)))
        return e;
      const dim3 grid((a.Lk + DkvSmem<D>::kKeys - 1) / DkvSmem<D>::kKeys, a.H, a.B);
      return run(flash_dkv_wgmma_kernel<D, C>, grid, dkv_threads<D>(), DkvSmem<D>::kBytes, a, s,
                 tq, tk, tv, tdo);
    } else {
      return run(flash_dkv_kernel<D, C>, dim3(tiles(a.Lk), a.H, a.B), kThreads, dkv_smem<D>(),
                 a, s);
    }
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
