// Weight-only int8 matmul for Hopper (sm_90a): y = (x @ Q) * s, one launch
// of warpgroup products on int8 weight tiles streamed by the Tensor Memory
// Accelerator.
//
// Replaces the Pallas TPU kernel kubeml_tpu/ops/int8_matmul.py::_mm_kernel
// (line 55; wrapper `int8_matmul`). x [M, K] is f32 or bf16, Q [K, N] int8
// row-major exactly as serving/quant.py stores it, s [N] f32 per output
// channel; the sum over all of K is taken in f32 and the scale is applied
// once, in the epilogue.
//
// What bounds it on an H100: at decode (M <= 8 resident rows) the bytes of
// Q. A GPT-2-small decode step streams 123.5 MB of int8 weights (37 us at
// 3.35 TB/s) and does 2 x M flops per weight byte. So every weight byte is
// read once, through shared memory, with many bytes in flight, and the
// conversion and the products must keep pace with HBM:
//   * the weights are the 64-row operand: a consumer warpgroup computes the
//     transposed tile y^T[128 columns, MT rows] = Q^T . x^T as two wgmma
//     m64nMTk16 products in the RS form. A is the int8 weights converted to
//     bf16 in registers (exact: |q| <= 128); B is the x tile in shared
//     memory, K-major as x lies. The wgmma n is the M tile (8 at decode,
//     32 at prefill), so M 8 is never padded to the 16 or 64 rows an
//     m-major tile needs;
//   * which output column a row of A stands for is free: thread (warp w,
//     group g) owns columns 4 (8 w + g) .. + 3, rows g and g + 8 of both
//     64-row products. One 32-bit shared load of a weight row then holds
//     that thread's four columns at one k, and byte permutes (prmt) with a
//     float magic number build the bf16 fragments: four loads and ~44
//     integer/float operations per 16 bytes of Q, no single-byte loads;
//   * f32 x runs on the tensor cores too: x splits exactly into three bf16
//     terms (hi, mid, lo: the top 8, next 8 and last 8 significant bits,
//     by truncation), each product of a bf16 term and an int8 value is
//     exact in f32, and three products add into one f32 accumulator. bf16 x
//     is one term. Non-finite x keeps hi = x and mid = lo = 0, so inf and
//     NaN propagate as in int8_dot;
//   * Q streams through a four-stage ring of 64 K-rows x 128 columns,
//     driven by one producer warp with full and empty mbarriers: a 2-D TMA
//     box (128-byte swizzle, rows past K arrive as zeros) where Q's rows are
//     16-byte aligned (N % 16 == 0), else 16-byte asynchronous copies of the
//     16-byte-aligned span around each row's 128 bytes (the lm_head, N =
//     50257: TMA needs 16-byte row strides). The same warp brings each
//     64-deep x chunk into the stage beside Q (a TMA box where x's rows are
//     16-byte aligned, else value by value), so no consumer waits on a
//     global load; the consumers split it into bf16
//     planes in shared memory (128-byte swizzle, double-buffered) and
//     release the stage as soon as its bytes are in registers and planes,
//     before their products run. Rows past M and K read as zeros, columns
//     past N are computed and never stored;
//   * where the column tiles cannot fill the card (every per-layer
//     projection at decode), a thread-block cluster of up to 8 blocks splits
//     K in one launch: ranks 1.. leave their accumulators in their shared
//     memory and rank 0 adds them in rank order over distributed shared
//     memory, then scales and stores. Deterministic, no workspace, no second
//     kernel.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <type_traits>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 128;       // output columns per block (one warpgroup)
constexpr int kBK = 64;          // K rows per ring stage and x chunk
constexpr int kStages = 4;
constexpr int kRowBytes = 144;   // a staged Q row: 128 columns + alignment slack
constexpr int kQBytes = kBK * kRowBytes;  // Q part of a stage: 9216, a multiple of 1024
constexpr int kThreads = 128 + 32;            // consumer warpgroup + producer warp
constexpr uint32_t kMagic = 0x4B000000u;      // f32 2^23: bits 0x4B0000uu = 2^23 + uu
constexpr float kMagicBias = 8388736.f;       // 2^23 + 128

enum DType { kF32 = 0, kBF16 = 1 };

template <typename TX>
__host__ __device__ constexpr int terms() {
  return std::is_same<TX, float>::value ? 3 : 1;
}

// Shared memory, byte offsets from a 1024-aligned base: the ring (each
// stage 64 rows of Q, then the chunk's x as it lies in memory, [MT][64]
// TX), then two x chunks of terms() bf16 planes [MT rows][64 k] (128-byte
// swizzle), then the mbarriers. Split-K ranks leave their accumulators in
// the ring.
template <typename TX, int MT>
struct Smem {
  static constexpr int kXRow = kBK * sizeof(TX);
  static constexpr int kStage = kQBytes + MT * kXRow;  // a multiple of 1024
  static constexpr int kPlane = MT * 128;
  static constexpr int kX = kStages * kStage;
  static constexpr int kBar = kX + 2 * terms<TX>() * kPlane;
  static constexpr int kBytes = kBar + 16 * kStages + 1024;  // + alignment
  static_assert(kStage % 1024 == 0 && kX >= kCols * MT * 4, "stage alignment, split-K buffer");
};

struct Args {
  const void* x;     // [M, K]
  const int8_t* q;   // [K, N]
  const float* s;    // [N]
  void* y;           // [M, N]
  int M, K, N;
  int k_per_rank;    // K rows per cluster rank, a multiple of kBK
  int rows_copied;   // Q stages by 16-byte copies of each row, not TMA boxes
  int x_tma;         // x stages by TMA boxes (rows 16-byte aligned), else
                     // value by value
};

// One box of a 2-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 16 bytes from 16-byte-aligned global `src`: an asynchronous copy that a
// later cp.async.mbarrier.arrive waits for
__device__ __forceinline__ void copy16_async(uint32_t dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

// d (+)= A . B over one k16 step: A (bf16 pairs) in registers, B (8 rows of
// x) in shared memory, K-major
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A . B over one k16 step: A (bf16 pairs) in registers, B (32 rows of
// x) in shared memory, K-major
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int MT>
__device__ __forceinline__ void wgmma_rs(float (&d)[MT / 2], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  if constexpr (MT == 8)
    wgmma_rs_n8(d, a, db, scale_d);
  else
    wgmma_rs_n32(d, a, db, scale_d);
}

// Byte j of four int8 weights (pre-xored with 0x80: unsigned offsets) as
// an exact f32: 2^23 + u - (2^23 + 128).
template <int J>
__device__ __forceinline__ float q_value(uint32_t w) {
  return __uint_as_float(__byte_perm(w, kMagic, 0x7540 | J)) - kMagicBias;
}

// bf16 pair {lo: byte J of w_lo, hi: byte J of w_hi}; the values are small
// integers, so their f32 low halves are zero and bf16 is the high half.
template <int J>
__device__ __forceinline__ uint32_t q_pair(uint32_t w_lo, uint32_t w_hi) {
  return __byte_perm(__float_as_uint(q_value<J>(w_lo)), __float_as_uint(q_value<J>(w_hi)),
                     0x7632);
}

// x split into terms<TX>() bf16 terms whose sum is x exactly: each term
// the leading 8 significant bits (truncation) of what the earlier ones
// left; non-finite x is all in hi.
__device__ __forceinline__ void split3(float v, uint32_t (&t)[3]) {
  const uint32_t b = __float_as_uint(v);
  if (!isfinite(v)) {
    t[0] = isnan(v) ? 0x7FC0u : b >> 16;
    t[1] = t[2] = 0;
    return;
  }
  const float r = v - __uint_as_float(b & 0xFFFF0000u);
  const uint32_t rb = __float_as_uint(r);
  t[0] = b >> 16;
  t[1] = rb >> 16;
  t[2] = __float_as_uint(r - __uint_as_float(rb & 0xFFFF0000u)) >> 16;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The producer warp's copy of x[m0 .., k0 .. k0 + 64) into a stage's raw
// rows ([MT][64] TX at `raw`), value by value, where x's rows are not
// 16-byte aligned (else a TMA box brings them). Values outside x are not
// copied: the consumers read them as 0.
template <typename TX, int MT>
__device__ __forceinline__ void stage_x(const Args& a, TX* raw, int m0, int k0, int lane) {
  const TX* x = static_cast<const TX*>(a.x);
  for (int i = lane; i < MT * kBK; i += 32) {
    const int m = m0 + i / kBK, k = k0 + i % kBK;
    if (m < a.M && k < a.K) raw[i] = x[(size_t)m * a.K + k];
  }
}

// A stage's raw x chunk as bf16 planes (terms<TX>() of them) at `xs`, in
// the 128-byte-swizzled K-major layout of the wgmma B operand; values past
// M or K as 0. Each thread takes quads of 4 k.
template <typename TX, int MT>
__device__ __forceinline__ void store_x(const TX* raw, unsigned char* xs, int m0, int k0,
                                        const Args& a, int tid) {
  constexpr int T = terms<TX>();
#pragma unroll
  for (int j = 0; j < MT / 8; ++j) {
    const int i = tid + 128 * j;
    const int r = i >> 4, kq = i & 15;
    float v[4];
    if constexpr (std::is_same<TX, float>::value) {
      const float4 f = *reinterpret_cast<const float4*>(raw + 4 * i);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(raw + 4 * i);
      v[0] = __uint_as_float(u.x << 16), v[1] = __uint_as_float(u.x & 0xFFFF0000u);
      v[2] = __uint_as_float(u.y << 16), v[3] = __uint_as_float(u.y & 0xFFFF0000u);
    }
    const bool row_in = m0 + r < a.M;
    uint32_t t[4][3];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split3(row_in && k0 + 4 * kq + e < a.K ? v[e] : 0.f, t[e]);
    const int off = (r >> 3) * 1024 + (r & 7) * 128 + (((kq >> 1) ^ (r & 7)) << 4) + (kq & 1) * 8;
#pragma unroll
    for (int p = 0; p < T; ++p)
      *reinterpret_cast<uint2*>(xs + p * MT * 128 + off) =
          make_uint2(t[0][p] | (t[1][p] << 16), t[2][p] | (t[3][p] << 16));
  }
}

// y = (x Q) s for one (cluster rank, 128-column box, MT-row tile): grid
// (cluster, column boxes, row tiles), the cluster along x.
template <typename TX, typename TY, int MT>
__global__ void __launch_bounds__(kThreads)
    int8_mm_wgmma_kernel(const Args a, const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tx) {
  using S = Smem<TX, MT>;
  constexpr int T = terms<TX>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t full = base + S::kBar, empty = full + 8 * kStages;
  const int rank = blockIdx.x;
  const int n0 = blockIdx.y * kCols;
  const int m0 = blockIdx.z * MT;
  const int kbeg = rank * a.k_per_rank;
  const int kend = min(a.K, kbeg + a.k_per_rank);
  const int n_chunks = (kend - kbeg + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // 32 producer lanes, and lane 0's expect_tx for the TMA boxes
      mbar_init(full + 8 * s, 33);
      mbar_init(empty + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int cb = 4 * (8 * w + g);  // a consumer's first column in the box
  float acc[2][MT / 2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < MT / 2; ++i) acc[t][i] = 0.f;

  if (tid >= 128) {  // the producer warp
    const int pl = tid - 128;
    for (int c = 0; c < n_chunks; ++c) {
      const int st = c % kStages;
      mbar_wait(empty + 8 * st, ((c / kStages) & 1) ^ 1);
      const int k0 = kbeg + c * kBK;
      const uint32_t dst = base + st * S::kStage, bar = full + 8 * st;
      if (pl == 0) {
        mbar_expect_tx(bar, (a.rows_copied ? 0 : kBK * kCols) + (a.x_tma ? MT * S::kXRow : 0));
        if (!a.rows_copied) tma_load_2d(dst, &tq, bar, n0, k0);
        if (a.x_tma) tma_load_2d(dst + kQBytes, &tx, bar, k0, m0);
      }
      if (a.rows_copied) {
        // each row's 16-byte-aligned span around columns [n0, min(N, n0 +
        // 128)), at most 9 pieces of 16 bytes, one piece a lane at a time;
        // a span ends inside the 16 bytes that hold the row's last column,
        // so it never leaves Q's allocation. Each lane's arrival on the
        // full barrier waits for its own copies.
        for (int i = pl; i < kBK * 9; i += 32) {
          const int r = i / 9, piece = i - 9 * r;
          const uintptr_t row = reinterpret_cast<uintptr_t>(a.q) + (size_t)(k0 + r) * a.N;
          const uintptr_t lo = ((row + n0) & ~uintptr_t(15)) + 16 * piece;
          const uintptr_t hi = row + min(a.N, n0 + kCols);
          if (k0 + r < kend && lo < hi) copy16_async(dst + r * kRowBytes + 16 * piece, lo);
        }
      }
      if (!a.x_tma)
        stage_x<TX, MT>(a, reinterpret_cast<TX*>(sm + st * S::kStage + kQBytes), m0, k0, pl);
      // each lane's arrival waits for its own asynchronous copies; x stored
      // value by value is in shared memory before the lane arrives
      if (a.x_tma) {
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar)
                     : "memory");
      } else {
        asm volatile("cp.async.wait_all;" ::: "memory");
        mbar_arrive(bar);
      }
    }
  } else {  // the consumer warpgroup
    // copied rows start (address of row k, column n0) mod 16 bytes
    // into their slot: row k's offset is (qa + k N) mod 16
    const uint32_t qa = (uint32_t)(reinterpret_cast<uintptr_t>(a.q) + n0);
    for (int c = 0; c < n_chunks; ++c) {
      const int k0 = kbeg + c * kBK;
      const int st = c % kStages;
      mbar_wait(full + 8 * st, (c / kStages) & 1);
      const unsigned char* stage = sm + st * S::kStage;
      const uint32_t xs = base + S::kX + (c & 1) * T * S::kPlane;
      store_x<TX, MT>(reinterpret_cast<const TX*>(stage + kQBytes),
                      sm + S::kX + (c & 1) * T * S::kPlane, m0, k0, a, tid);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, 128;" ::: "memory");
      uint32_t af[4][2][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t wd[4];  // rows 16 kk + 2 t4 + {0, 1, 8, 9}, this thread's 4 columns
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * kk + 2 * t4 + (i & 1) + 8 * (i >> 1);
          uint32_t v;
          if (!a.rows_copied) {  // TMA box: 128-byte rows, 16-byte chunks swizzled
            v = *reinterpret_cast<const uint32_t*>(
                stage + r * kCols + ((((cb >> 4) ^ (r & 7)) << 4) | (cb & 15)));
          } else {
            const uint32_t p = r * kRowBytes + ((qa + (uint32_t)(k0 + r) * (uint32_t)a.N) & 15) + cb;
            const uint32_t* wp = reinterpret_cast<const uint32_t*>(stage + (p & ~3u));
            v = __funnelshift_r(wp[0], wp[1], 8 * (p & 3));
          }
          wd[i] = v ^ 0x80808080u;
        }
        af[kk][0][0] = q_pair<0>(wd[0], wd[1]);
        af[kk][0][1] = q_pair<1>(wd[0], wd[1]);
        af[kk][0][2] = q_pair<0>(wd[2], wd[3]);
        af[kk][0][3] = q_pair<1>(wd[2], wd[3]);
        af[kk][1][0] = q_pair<2>(wd[0], wd[1]);
        af[kk][1][1] = q_pair<3>(wd[0], wd[1]);
        af[kk][1][2] = q_pair<2>(wd[2], wd[3]);
        af[kk][1][3] = q_pair<3>(wd[2], wd[3]);
      }
      // the stage's Q and x are in registers and planes now: release it
      // before the products, so the producer refills it meanwhile
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
      // every fragment is built before the first product: no register
      // write between the asynchronous products
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(af[kk][t][e])::"memory");
      // the chunk's 64-deep sum on the tensor cores into part, then added
      // to acc with round-to-nearest: the tensor cores' additions do not
      // round to nearest, so their error stays that of 64-deep sums
      float part[2][MT / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < T; ++p) {
          const uint64_t db = sw128_desc(xs + p * S::kPlane + kk * 32, 16);
          wgmma_rs<MT>(part[0], af[kk][0], db, kk + p > 0);
          wgmma_rs<MT>(part[1], af[kk][1], db, kk + p > 0);
        }
      wg_commit();
      wg_wait0();
      reg_fence(part[0]);
      reg_fence(part[1]);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int i = 0; i < MT / 2; ++i) acc[t][i] += part[t][i];
    }
  }

  if (gridDim.x > 1) {  // split K: rank 0 adds the other ranks' sums in order
    cg::cluster_group cl = cg::this_cluster();
    float* red = reinterpret_cast<float*>(sm);  // [MT][128], in the drained ring
    if (rank > 0 && tid < 128) {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int i = 0; i < MT / 2; ++i) red[(t * (MT / 2) + i) * 128 + tid] = acc[t][i];
    }
    cl.sync();
    if (rank == 0 && tid < 128) {
      for (int r = 1; r < (int)gridDim.x; ++r) {
        const float* other = cl.map_shared_rank(red, r);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int i = 0; i < MT / 2; ++i) acc[t][i] += other[(t * (MT / 2) + i) * 128 + tid];
      }
    }
    cl.sync();  // no rank leaves while rank 0 reads its shared memory
    if (rank > 0) return;
  }
  if (tid >= 128) return;

  // epilogue: accumulator row g + 8 h of product t is column cb + 2 t + h;
  // its entries 4 j + 2 h + e are rows m0 + 8 j + 2 t4 + e
  const int col = n0 + cb;
  float sc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) sc[j] = col + j < a.N ? a.s[col + j] : 0.f;
  TY* y = static_cast<TY*>(a.y);
  const bool vec = (a.N & 3) == 0 && col + 3 < a.N;
#pragma unroll
  for (int j = 0; j < MT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * t4 + e;
      if (m >= a.M) continue;
      const float v[4] = {acc[0][4 * j + e] * sc[0], acc[0][4 * j + 2 + e] * sc[1],
                          acc[1][4 * j + e] * sc[2], acc[1][4 * j + 2 + e] * sc[3]};
      TY* row = y + (size_t)m * a.N + col;
      if (vec) {
        if constexpr (std::is_same<TY, float>::value) {
          *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
          __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
          __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
          *reinterpret_cast<uint2*>(row) =
              make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < a.N) {
            if constexpr (std::is_same<TY, float>::value)
              row[q] = v[q];
            else
              row[q] = __float2bfloat16(v[q]);
          }
      }
    }
}

// A row-major [rows, cols] tensor of `esize`-byte values as the 2-D map
// (cols, rows): boxes of box_cols by box_rows, rows and columns past the
// ends filled with zeros. Q: int8 boxes of 128 columns by kBK rows,
// 128-byte swizzle; x: boxes of kBK values by the M tile, no swizzle.
int map_2d(CUtensorMap* map, const void* p, CUtensorMapDataType type, int esize, int rows,
           int cols, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = enc(map, type, 2, const_cast<void*>(p), dims, strides, box, step,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename TX, typename TY, int MT>
int launch(const Args& a, const CUtensorMap& tq, const CUtensorMap& tx, int cluster,
           cudaStream_t stream) {
  const auto kern = int8_mm_wgmma_kernel<TX, TY, MT>;
  const int smem = Smem<TX, MT>::kBytes;
  // the shared-memory limit is raised once per device for this
  // instantiation, not on every call
  static std::atomic<uint64_t> raised{0};  // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const uint64_t bit = uint64_t(1) << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    raised.fetch_or(bit);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (a.N + kCols - 1) / kCols, (a.M + MT - 1) / MT);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a, tq, tx);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename TX, typename TY>
int dispatch_mt(int mt, const Args& a, const CUtensorMap& tq, const CUtensorMap& tx,
                int cluster, cudaStream_t st) {
  switch (mt) {
    case 8: return launch<TX, TY, 8>(a, tq, tx, cluster, st);
    case 32: return launch<TX, TY, 32>(a, tq, tx, cluster, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TX>
int dispatch_y(int y_dtype, int mt, const Args& a, const CUtensorMap& tq,
               const CUtensorMap& tx, int cluster, cudaStream_t st) {
  switch (y_dtype) {
    case kF32: return dispatch_mt<TX, float>(mt, a, tq, tx, cluster, st);
    case kBF16: return dispatch_mt<TX, __nv_bfloat16>(mt, a, tq, tx, cluster, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [M, K] (x_dtype), q [K, N] int8, s [N] f32, y [M, N] (y_dtype), all
// contiguous. m_tile (8 or 32) is the rows of a block's tile; cluster
// (1-8) blocks split K, each k_per_rank rows (a multiple of 64, every rank
// non-empty). Returns cudaGetLastError() after the one launch.
extern "C" int kubeml_int8_matmul(const void* x, const void* q, const void* s, void* y, int M,
                                  int K, int N, int m_tile, int cluster, int k_per_rank,
                                  int x_dtype, int y_dtype, void* stream) {
  if (M < 1 || K < 1 || N < 1 || cluster < 1 || cluster > 8 || k_per_rank < 1 ||
      k_per_rank % kBK != 0 || (long long)(cluster - 1) * k_per_rank >= K ||
      (long long)cluster * k_per_rank < K || (M + m_tile - 1) / max(m_tile, 1) > 65535 ||
      (N + kCols - 1) / kCols > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = x;
  a.q = static_cast<const int8_t*>(q);
  a.s = static_cast<const float*>(s);
  a.y = y;
  a.M = M;
  a.K = K;
  a.N = N;
  a.k_per_rank = k_per_rank;
  // TMA needs 16-byte-aligned rows
  a.rows_copied = N % 16 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0;
  // TMA boxes of x need 16-byte-aligned rows too
  const int xsize = x_dtype == kF32 ? 4 : 2;
  a.x_tma = (size_t)K * xsize % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  CUtensorMap tq, tx;
  memset(&tq, 0, sizeof(tq));
  memset(&tx, 0, sizeof(tx));
  int e;
  if (!a.rows_copied && (e = map_2d(&tq, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, kCols, kBK,
                                    CU_TENSOR_MAP_SWIZZLE_128B)))
    return e;
  if (a.x_tma &&
      (e = map_2d(&tx, x,
                  x_dtype == kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  xsize, M, K, kBK, m_tile, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32: return dispatch_y<float>(y_dtype, m_tile, a, tq, tx, cluster, st);
    case kBF16: return dispatch_y<__nv_bfloat16>(y_dtype, m_tile, a, tq, tx, cluster, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
