// Paged attention for Hopper (sm_90a): attend straight through per-row page
// tables, no contiguous K/V copy.
//
// Replaces the Pallas TPU kernel kubeml_tpu/ops/paged_attention.py::_pa_kernel
// (wrapper `paged_attention`). One kernel serves L == 1 decode steps and
// L > 1 suffix prefill: query l of row b sits at logical position
// positions[b] + l and attends every key at or before it.
//
// What bounds it on an H100: memory traffic. A decode step reads each row's
// live K and V pages once (B x live_tokens x H x D x 2 values) and does only
// 4 x D flops per key and query, far below the card's ~20 flop/byte f32
// ridge. The design therefore reads every live page exactly once per
// (row, head, query tile) and never materialises the gathered [B, P*pt, H, D]
// block the plain path builds:
//   * grid (B, H, ceil(L / qtile)); each block loads its row's page-table
//     entries itself and walks pages 0 .. min(live, pages its last query
//     needs) - 1, so reads stop at the row's live depth;
//   * per page, the [pt, D] K and V slices of head h (strided by H*D in the
//     arena) are staged into shared memory, converted to f32 on load
//     (bf16 or int8 storage), and reused by every query of the tile;
//   * online softmax in f32 (running max m, sum l, accumulator in
//     registers); int8 pages fold their per-page-per-head scale s/127 into
//     the scores after QK^T and into PV after the product, like the TPU
//     kernel.
// Masked keys contribute exactly 0: scores take -1e30 (not -inf, so exp()
// of a fully masked row stays finite), p is forced to 0 for them, and the
// final division uses max(l, 1e-9). Pages past `live` are never read, so a
// poisoned arena outside the written positions cannot change the output.
// Queries are tiled (qtile <= 16) because prefill L reaches hundreds of
// tokens, where the TPU kernel held all of L in one block.
// Decode has few (row, head) pairs - 96 at 8 rows x 12 heads, fewer than
// the card's 132 SMs - and each would walk up to 64 pages one after
// another, so the wrapper splits the page walk across blocks when the grid
// is small (flash-decoding): block z covers pages [split * pps, +pps) and
// writes its unnormalised (m, l, acc) to a workspace; a second kernel
// merges the splits in index order, so results do not depend on timing.
// This first version uses plain FMA loops, not wgmma/TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;
constexpr int kMaxQTile = 16;
constexpr int kMaxD = 128;
constexpr int kMaxAcc = kMaxQTile * kMaxD / kThreads;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename TQ, typename TKV, bool kQuant>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ pages,
    const int* __restrict__ positions, TQ* __restrict__ out,
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int B, int L, int H, int D, int pt, int P,
    int qtile, int splits, int pages_per_split, float sm_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z % splits;
  const int q0 = (blockIdx.z / splits) * qtile;
  const int nq = min(qtile, L - q0);
  const int dp = D + 1;  // padded row: conflict-free column reads
  float* sq = smem;                // [qtile][dp] queries, f32
  float* sk = sq + qtile * dp;     // [pt][dp]    K page, f32
  float* sv = sk + pt * dp;        // [pt][D]     V page, f32
  float* sp = sv + pt * D;         // [qtile][pt] scores, then p
  float* sm = sp + qtile * pt;     // [qtile] running max
  float* sl = sm + qtile;          // [qtile] running sum
  float* sa = sl + qtile;          // [qtile] rescale factor of this page
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int pos = positions[b];
  // pages the row occupies after this call's writes (at least one, at most
  // the table width: bucket-padding rows may sit past the table)
  const int live = max(1, min((pos + L + pt - 1) / pt, P));
  // pages the tile's last query can see
  const int need = (pos + q0 + nq - 1) / pt + 1;
  const int npg = max(1, min(live, need));
  const int pg_begin = split * pages_per_split;
  const int pg_end = min(npg, pg_begin + pages_per_split);

  for (int idx = tid; idx < nq * D; idx += kThreads) {
    const int i = idx / D;
    const int d = idx - i * D;
    sq[i * dp + d] = to_f32(q[((size_t)(b * L + q0 + i) * H + h) * D + d]);
  }
  for (int i = tid; i < nq; i += kThreads) {
    sm[i] = kNeg;
    sl[i] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int pg = pg_begin; pg < pg_end; ++pg) {
    const int phys = pages[(size_t)b * P + pg];
    const size_t page_base = (size_t)phys * pt * H * D + (size_t)h * D;
    for (int idx = tid; idx < pt * D; idx += kThreads) {
      const int t = idx / D;
      const int d = idx - t * D;
      const size_t off = page_base + (size_t)t * H * D + d;
      sk[t * dp + d] = to_f32(k_pages[off]);
      sv[t * D + d] = to_f32(v_pages[off]);
    }
    float ksf = 1.f;
    float vsf = 1.f;
    if (kQuant) {
      ksf = k_scale[(size_t)phys * H + h] / 127.f;
      vsf = v_scale[(size_t)phys * H + h] / 127.f;
    }
    __syncthreads();

    const int kpos0 = pg * pt;
    for (int idx = tid; idx < nq * pt; idx += kThreads) {
      const int i = idx / pt;
      const int j = idx - i * pt;
      const float* qi = sq + i * dp;
      const float* kj = sk + j * dp;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qi[d], kj[d], s);
      s *= sm_scale;
      if (kQuant) s *= ksf;
      sp[idx] = (kpos0 + j <= pos + q0 + i) ? s : kNeg;
    }
    __syncthreads();

    for (int i = warp; i < nq; i += kThreads / 32) {
      float* row = sp + i * pt;
      float mx = kNeg;
      for (int j = lane; j < pt; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sm[i];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < pt; j += 32) {
        const float s = row[j];
        const float p = (s <= 0.5f * kNeg) ? 0.f : expf(s - m_new);
        row[j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sa[i] = alpha;
        sl[i] = sl[i] * alpha + sum;
        sm[i] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kMaxAcc; ++r) {
      const int idx = tid + r * kThreads;
      if (idx < nq * D) {
        const int i = idx / D;
        const int d = idx - i * D;
        const float* prow = sp + i * pt;
        float pv = 0.f;
        for (int j = 0; j < pt; ++j) pv = fmaf(prow[j], sv[j * D + d], pv);
        if (kQuant) pv *= vsf;
        acc[r] = acc[r] * sa[i] + pv;
      }
    }
    __syncthreads();  // the next page overwrites sk/sv/sp
  }

  // row (b, q0 + i, h) of split `split` in the [splits, B, L, H] partials
  const size_t prow = ((size_t)split * B + b) * L + q0;
  if (splits > 1) {
    for (int i = tid; i < nq; i += kThreads) {
      part_m[(prow + i) * H + h] = sm[i];
      part_l[(prow + i) * H + h] = sl[i];
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) {
    const int idx = tid + r * kThreads;
    if (idx < nq * D) {
      const int i = idx / D;
      const int d = idx - i * D;
      if (splits > 1) {
        part_acc[((prow + i) * H + h) * D + d] = acc[r];
      } else {
        out[((size_t)(b * L + q0 + i) * H + h) * D + d] =
            from_f32<TQ>(acc[r] / fmaxf(sl[i], 1e-9f));
      }
    }
  }
}

// Merge the page splits of one (row, query, head): rescale each split's
// (l, acc) from its own running max to the overall one, sum in split order,
// divide once. A split that saw only masked keys has m = -1e30, l = 0,
// acc = 0 and adds nothing. One block per (b, l, h), one thread per d.
template <typename TQ>
__global__ void paged_attention_combine(const float* __restrict__ part_m,
                                        const float* __restrict__ part_l,
                                        const float* __restrict__ part_acc,
                                        TQ* __restrict__ out, int rows, int D,
                                        int splits) {
  const int row = blockIdx.x;  // (b * L + l) * H + h
  const int d = threadIdx.x;
  float m = kNeg;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part_m[(size_t)s * rows + row]);
  float l = 0.f;
  float o = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(part_m[(size_t)s * rows + row] - m);
    l += part_l[(size_t)s * rows + row] * w;
    o += part_acc[((size_t)s * rows + row) * D + d] * w;
  }
  out[(size_t)row * D + d] = from_f32<TQ>(o / fmaxf(l, 1e-9f));
}

template <typename TQ, typename TKV, bool kQuant>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* pages,
           const void* positions, void* out, float* workspace, int B, int L,
           int H, int D, int pt, int P, int splits, int pages_per_split,
           cudaStream_t stream) {
  const int qtile = L < kMaxQTile ? L : kMaxQTile;
  const size_t smem =
      sizeof(float) * ((size_t)qtile * (D + 1) + (size_t)pt * (D + 1) +
                       (size_t)pt * D + (size_t)qtile * pt + 3 * (size_t)qtile);
  auto kern = paged_attention_kernel<TQ, TKV, kQuant>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = B * L * H;
  float* part_m = splits > 1 ? workspace : nullptr;
  float* part_l = splits > 1 ? workspace + (size_t)splits * rows : nullptr;
  float* part_acc =
      splits > 1 ? workspace + 2 * (size_t)splits * rows : nullptr;
  const dim3 grid(B, H, ((L + qtile - 1) / qtile) * splits);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(pages),
      static_cast<const int*>(positions), static_cast<TQ*>(out), part_m,
      part_l, part_acc, B, L, H, D, pt, P, qtile, splits, pages_per_split,
      1.f / sqrtf((float)D));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  paged_attention_combine<TQ><<<rows, D, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<TQ*>(out), rows, D, splits);
  return (int)cudaGetLastError();
}

template <typename TQ>
int dispatch_kv(int kv_dtype, const void* q, const void* k_pages,
                const void* v_pages, const void* k_scale, const void* v_scale,
                const void* pages, const void* positions, void* out,
                float* ws, int B, int L, int H, int D, int pt, int P,
                int splits, int pps, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      return launch<TQ, float, false>(q, k_pages, v_pages, k_scale, v_scale,
                                      pages, positions, out, ws, B, L, H, D, pt,
                                      P, splits, pps, stream);
    case kBF16:
      return launch<TQ, __nv_bfloat16, false>(q, k_pages, v_pages, k_scale,
                                              v_scale, pages, positions, out,
                                              ws, B, L, H, D, pt, P, splits,
                                              pps, stream);
    case kI8:
      return launch<TQ, int8_t, true>(q, k_pages, v_pages, k_scale, v_scale,
                                      pages, positions, out, ws, B, L, H, D, pt,
                                      P, splits, pps, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out [B, L, H, D] (q_dtype); k_pages, v_pages [N, pt, H, D] (kv_dtype);
// k_scale, v_scale [N, H] f32 (int8 arenas only, else null); pages [B, P]
// and positions [B] int32. All contiguous. With splits > 1 each block walks
// pages_per_split pages and workspace holds splits * B * L * H * (D + 2)
// floats of partials. Returns cudaGetLastError().
extern "C" int kubeml_paged_attention(const void* q, const void* k_pages,
                                      const void* v_pages, const void* k_scale,
                                      const void* v_scale, const void* pages,
                                      const void* positions, void* out,
                                      void* workspace, int B, int L, int H,
                                      int D, int pt, int P, int splits,
                                      int pages_per_split, int q_dtype,
                                      int kv_dtype, void* stream) {
  if (B < 1 || L < 1 || H < 1 || D < 1 || D > kMaxD || pt < 1 || P < 1 ||
      splits < 1 || pages_per_split < 1 ||
      (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  if (kv_dtype == kI8 && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  float* ws = static_cast<float*>(workspace);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32:
      return dispatch_kv<float>(kv_dtype, q, k_pages, v_pages, k_scale,
                                v_scale, pages, positions, out, ws, B, L, H, D,
                                pt, P, splits, pages_per_split, s);
    case kBF16:
      return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_pages, v_pages, k_scale,
                                        v_scale, pages, positions, out, ws, B,
                                        L, H, D, pt, P, splits,
                                        pages_per_split, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
