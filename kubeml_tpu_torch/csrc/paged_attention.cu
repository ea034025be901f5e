// Paged attention for Hopper (sm_90a): attend straight through per-row page
// tables, pages streamed by TMA into a shared-memory ring, split page walks
// merged inside a thread-block cluster, one launch a call.
//
// Replaces the Pallas TPU kernel kubeml_tpu/ops/paged_attention.py::_pa_kernel
// (line 113; wrapper `paged_attention`). q [B, L, H, D] f32 or bf16, any
// D up to 128; arenas [N, pt, H, D] f32, bf16 or int8 (int8 with [N, H] f32
// scales), any page size; pages [B, P] and positions [B] int32. Query l of
// row b sits at positions[b] + l and attends every key at or before it; a
// row reads its pages up to live = clamp(ceil((pos + L) / pt), 1, P) and
// never past them.
//
// What bounds it on an H100: bytes at decode. A decode step reads each row's
// live K and V pages once and does 4 x D operations per key: under one
// operation per byte, far below the f32 ridge, so tensor cores would sit idle
// and the gain is in bytes in flight. Prefill tiles (L in the hundreds) are
// bound by f32 operations on the CUDA cores. The design:
//   * the kernel is built for a padded head dim DP (64 for D <= 64, else
//     128): staged rows, q and the accumulators hold DP values, those past
//     D zero; q and out are read and written at the true D;
//   * a block owns (row, group of hg heads, query tile, cluster rank) and
//     walks slabs of ct tokens (ct divides the page: a whole page unless the
//     ring would not fit); a slab's rows for the group are ct x hg x D
//     contiguous values in the arena. The wrapper's plan (ops/
//     paged_attention.py::_plan) picks hg, ct, the stages, the query tile
//     and the cluster, and lays out shared memory; kubeml_paged_attention
//     checks the plan and launches it;
//   * one producer warp streams slabs into a ring of `stages` stages: per
//     slab one TMA box [ct, hg, DP] of K and one of V from 3-D tensor maps
//     over the arenas (values past D and heads past H arrive as zeros),
//     completing on the stage's full mbarrier; int8 scales come by 4-byte
//     cp.async beside them. Arenas whose rows TMA cannot address (D x bytes
//     not a multiple of 16) are copied value by value by the same warp. The
//     host keeps each arena's maps in a table, so a call looks them up. The
//     block reads positions[b] and its row of the page table itself, the
//     table's first 128 entries loaded beside positions[b];
//   * consumer warps on the CUDA cores, in f32. Decode mapping (short L, in
//     tiles of up to 7 queries): one warp per (head, query); lanes over
//     keys x D slices (DP / 32 lanes a key, 32 values each, 16-byte loads
//     starting at a chunk rotated by the key, so that dense rows give no
//     bank conflicts), dot products finished by shuffles, the online softmax
//     in registers (two slabs a pass; the max moves only when a score passes
//     it by 8), P.V with lanes over D. Tile mapping (longer L): lanes over
//     queries x D slices (two queries and the same 32 values a lane, so
//     64 / S queries a warp), every key of the slab walked by every lane
//     (16-byte loads shared by the lanes of one slice), dots finished by
//     shuffles, the online softmax per group of 4 keys, causal key groups
//     past the warp's last query skipped. bf16 and int8 become f32 in
//     registers after the shared load; int8 scales s/127 fold in after the
//     products, as in the TPU kernel;
//   * where the (row, head group, query tile) blocks cannot fill 132 SMs, a
//     cluster of up to 8 blocks splits the slabs the tile needs evenly
//     between its ranks (decided on the card from the row's live depth, so
//     ragged rows balance). Ranks 1.. leave (m, l, acc) in their drained
//     rings; rank 0 merges them over distributed shared memory in rank order
//     between two cluster barriers and stores. One launch, no workspace, no
//     combine kernel; repeats are bit-identical.
// Masked keys contribute exactly 0: scores take -1e30 (not -inf), p is 0 for
// them (arenas start as zeros and hold finite values, so 0 x v is 0, as in
// the TPU kernel), rows read past a slab's end are zeroed before use, and
// the final division uses max(l, 1e-9). Pages past `live` are never read,
// so a poisoned arena outside the written positions cannot change the
// output.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <string.h>

#include <atomic>
#include <initializer_list>
#include <mutex>
#include <type_traits>
#include <utility>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e30f;
// consumer warps; one producer warp beside them. 8 warps in all let ptxas
// give the tile mapping 255 registers a thread (288 threads get 168, and
// spill); min blocks 1 keeps it from spilling scalars at 64 registers
constexpr int kMaxWarps = 7;
constexpr int kMaxThreads = 32 * (kMaxWarps + 1);
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block can use
constexpr int kKeyGroup = 4;      // tile mapping: keys between softmax updates (8 spill)

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

// The launch plan and the block's shared-memory layout, as the wrapper
// computes them (ops/paged_attention.py::_plan); kubeml_paged_attention
// checks that they fit the kernel and the card.
struct Plan {
  int hg;           // heads a block owns
  int qtile;        // queries a block owns
  int tile;         // the tile mapping (else the decode mapping)
  int stages;       // ring stages
  int cluster;      // blocks splitting a tile's slabs
  int ct;           // tokens a stage (a slab; divides the page)
  int warps;        // consumer warps
  int box_bytes;    // a staged slab's K (or V): [ct][hg][DP], 128-byte aligned
  int stage_bytes;  // K box, V box, then int8 scales
  int area_bytes;   // the ring (or the merge buffer, if larger)
  int smem;         // the block's dynamic shared memory
  int tma;          // slabs by TMA (else value by value)
};

struct Args {
  const void* q;
  const void* kp;  // the arenas, read value by value where no tensor map
  const void* vp;  // can address them
  const float* ks;
  const float* vs;
  const int* pages;
  const int* positions;
  void* out;
  int B, L, H, D, pt, P;
  int hg, qtile, n_qt, warps, stages, ct, box_bytes, stage_bytes, area_bytes, tma;
  int nsub;  // slabs a page
  float sm_scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void copy4_async(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

// A slab's [ct][hg][DP] values copied value by value, for arenas whose
// rows TMA cannot address (D x bytes not a multiple of 16); values past D
// and heads past H as zeros
template <typename TKV, int DP>
__device__ __forceinline__ void copy_slab(unsigned char* dst, const void* src, const Args& a,
                                          int tok0, int h0, int nh, int lane) {
  using U = typename std::conditional<
      sizeof(TKV) == 4, uint32_t,
      typename std::conditional<sizeof(TKV) == 2, uint16_t, uint8_t>::type>::type;
  const U* in = static_cast<const U*>(src);
  U* out = reinterpret_cast<U*>(dst);
  const int n = a.ct * a.hg * DP;
  for (int x = lane; x < n; x += 32) {
    const int d = x % DP, h = (x / DP) % a.hg, j = x / (DP * a.hg);
    out[x] = d < a.D && h < nh ? in[((size_t)(tok0 + j) * a.H + h0 + h) * a.D + d] : U(0);
  }
}

// 16 staged bytes as f32 values: 4 f32, 8 bf16 or 16 int8 (exact: the int8
// byte, offset by 128, becomes the low bits of the float 2^23)
template <typename T>
__device__ __forceinline__ void unpack16(const unsigned char* p, float (&f)[16 / sizeof(T)]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      f[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    } else {
      const uint32_t x = w[i] ^ 0x80808080u;
      f[4 * i + 0] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540)) - 8388736.f;
      f[4 * i + 1] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7541)) - 8388736.f;
      f[4 * i + 2] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7542)) - 8388736.f;
      f[4 * i + 3] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7543)) - 8388736.f;
    }
  }
}

// N consecutive staged values (N * sizeof(T) is 2, 4, 8 or 16 bytes) as f32
template <typename T, int N>
__device__ __forceinline__ void load_vals(const unsigned char* p, float (&f)[N]) {
  constexpr int bytes = N * (int)sizeof(T);
  uint32_t w[4] = {0, 0, 0, 0};
  if constexpr (bytes == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else if constexpr (bytes == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  } else if constexpr (bytes == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    static_assert(bytes == 2, "2 to 16 bytes");
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if constexpr (std::is_same<T, float>::value)
      f[e] = __uint_as_float(w[e]);
    else if constexpr (std::is_same<T, __nv_bfloat16>::value)
      f[e] = __uint_as_float((w[e / 2] >> (16 * (e % 2))) << 16);
    else
      f[e] = (float)(int8_t)(w[e / 4] >> (8 * (e % 4)));
  }
}

// row[off .. off + N) = v * inv where below D, stored as T (vector stores
// where the N values are whole and aligned)
template <typename T, int N>
__device__ __forceinline__ void store_vals(T* row, int off, int D, const float (&v)[N], float inv) {
  T* out = row + off;
  if (off + N > D || D % N != 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (off + i >= D) break;
      if constexpr (std::is_same<T, float>::value)
        out[i] = v[i] * inv;
      else
        out[i] = __float2bfloat16(v[i] * inv);
    }
  } else if constexpr (std::is_same<T, float>::value && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(out + i) =
          make_float4(v[i] * inv, v[i + 1] * inv, v[i + 2] * inv, v[i + 3] * inv);
  } else if constexpr (std::is_same<T, float>::value && N == 2) {
    *reinterpret_cast<float2*>(out) = make_float2(v[0] * inv, v[1] * inv);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (std::is_same<T, float>::value)
        out[i] = v[i] * inv;
      else
        out[i] = __float2bfloat16(v[i] * inv);
    }
  }
}

// grid (cluster rank, head group, row x query tile), the cluster along x;
// warps 0 .. a.warps - 1 consume, warp a.warps produces. Both mappings give
// a lane the 16-byte chunks s, s + S, s + 2S, ... (S = DP / 32 slices, 32
// values) of a head's K and V rows: the decode mapping for one key of one
// query, the tile mapping for every key of two queries.
template <typename TQ, typename TKV, int DP, bool kTile>
__global__ void __launch_bounds__(kMaxThreads, 1)
    paged_attention_ring_kernel(const Args a, const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv) {
  constexpr int es = sizeof(TKV);
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int S = DP / 32, NCH = 2 * es, E = 16 / es;
  constexpr int NQ = kTile ? 2 : 1;         // queries a lane owns
  constexpr int DQ = kTile ? 32 : DP / 32;   // output values a lane owns a query
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t full = base + a.area_bytes, empty = full + 8 * a.stages;

  const int rank = blockIdx.x, C = gridDim.x;
  const int h0 = blockIdx.y * a.hg, nh = min(a.hg, a.H - h0);
  const int b = blockIdx.z / a.n_qt;
  const int q0 = (blockIdx.z % a.n_qt) * a.qtile, nq = min(a.qtile, a.L - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the producer's copy of the row's first 128 table entries, loaded beside
  // positions[b] (the ranks' split needs that first)
  const int* row = a.pages + (size_t)b * a.P;
  int tab[4] = {0, 0, 0, 0};
  if (warp == a.warps) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (lane + 32 * k < a.P) tab[k] = row[lane + 32 * k];
  }
  const int pos = a.positions[b];
  // pages the row occupies after this call's writes (at least one, at most
  // the table: bucket-padding rows may sit past it), then the slabs of them
  // that the tile's last query can see, split evenly between the cluster's
  // ranks
  const int live = max(1, min((pos + a.L + a.pt - 1) / a.pt, a.P));
  const int nsl = max(1, min(live * a.nsub, (pos + q0 + nq - 1) / a.ct + 1));
  const int per = (nsl + C - 1) / C;
  const int sl_beg = min(nsl, rank * per);
  const int count = min(nsl, sl_beg + per) - sl_beg;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      // the producer lane 0's expect_tx (without TMA: its arrival after
      // the copies) and 32 asynchronous arrivals
      mbar_init(full + 8 * s, 33);
      mbar_init(empty + 8 * s, a.warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float m[NQ], l[NQ], acc[NQ][DQ];
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    m[t] = kNeg;
    l[t] = 0.f;
#pragma unroll
    for (int d = 0; d < DQ; ++d) acc[t][d] = 0.f;
  }
  const int hl = warp % a.hg, s = lane % S, grp = lane / S;
  // decode: the warp's query; tile: the lane's first query (then + 1)
  const int lq = kTile ? (warp / a.hg) * (2 * 32 / S) + 2 * grp : warp / a.hg;
  // the warp's last query (tile: of its 64 / S)
  const int lq_last = kTile ? min(nq, (warp / a.hg + 1) * (2 * 32 / S)) - 1 : lq;
  const bool ok = warp < a.warps && hl < nh && lq_last >= 0 &&
                  (kTile ? (warp / a.hg) * (2 * 32 / S) < nq : lq < nq);
  const int qmax = pos + q0 + lq_last;

  if (warp == a.warps) {  // the producer warp
    int far = 0, far_at = -1;  // table entries past the first 128, 32 at a time
    for (int i = 0; i < count; ++i) {
      const int st = i % a.stages;
      const int sl = sl_beg + i, pg = sl / a.nsub;
      int phys;
      if (pg < 128) {
        const int w = pg >> 5;
        phys = __shfl_sync(0xffffffffu, w == 0 ? tab[0] : w == 1 ? tab[1] : w == 2 ? tab[2] : tab[3],
                           pg & 31);
      } else {
        if ((pg & ~31) != far_at) {
          far_at = pg & ~31;
          far = far_at + lane < a.P ? row[far_at + lane] : 0;
        }
        phys = __shfl_sync(0xffffffffu, far, pg & 31);
      }
      const int tok0 = phys * a.pt + (sl - pg * a.nsub) * a.ct;  // the slab's first arena row
      mbar_wait(empty + 8 * st, ((i / a.stages) & 1) ^ 1);
      const uint32_t dst = base + st * a.stage_bytes, bar = full + 8 * st;
      if (a.tma) {
        if (lane == 0) {
          // whole boxes count, values past D and heads past H included
          // (they arrive as zeros)
          mbar_expect_tx(bar, 2 * a.ct * a.hg * DP * es);
          tma_load_3d(dst, &tk, bar, 0, h0, tok0);
          tma_load_3d(dst + a.box_bytes, &tv, bar, 0, h0, tok0);
        }
      } else {
        unsigned char* stage = sm + st * a.stage_bytes;
        copy_slab<TKV, DP>(stage, a.kp, a, tok0, h0, nh, lane);
        copy_slab<TKV, DP>(stage + a.box_bytes, a.vp, a, tok0, h0, nh, lane);
      }
      if constexpr (kQuant) {
        const uint32_t sdst = dst + 2 * a.box_bytes;
        const size_t s0 = (size_t)phys * a.H + h0;
        if (lane < nh)
          copy4_async(sdst + 4 * lane, a.ks + s0 + lane);
        else if (lane >= 16 && lane - 16 < nh)
          copy4_async(sdst + 4 * (a.hg + lane - 16), a.vs + s0 + lane - 16);
      }
      // each lane arrives once its own scale copies have landed; without
      // TMA, lane 0 arrives last, after every lane's stores
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
      if (!a.tma) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar);
      }
    }
  } else {
    // a staged token row: hg * DP values, dense. The lane's k-th chunk of its
    // slice; the decode mapping starts each key's lanes at another chunk
    // (rotated by the key), so that the 8 lanes of a 16-byte load phase hit
    // distinct banks
    const int rs = a.hg * DP * es;
    const int rot = kTile ? 0 : grp;
    auto chunk = [&](int k) { return s + S * ((k + rot) & (NCH - 1)); };
    // the lane's q values, chunk by chunk, query lq + t (zeros past D)
    float qv[NQ][32];
#pragma unroll
    for (int t = 0; t < NQ; ++t) {
      const bool in = ok && lq + t < nq;
      const TQ* qr = static_cast<const TQ*>(a.q) +
                     (((size_t)b * a.L + q0 + (in ? lq + t : 0)) * a.H + h0 + hl) * a.D;
#pragma unroll
      for (int k = 0; k < NCH; ++k)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = chunk(k) * E + e;
          qv[t][k * E + e] = in && d < a.D ? to_f32(qr[d]) : 0.f;
        }
    }
    // stage i's K rows, V rows and int8 scale factors for head hl, once its
    // bytes have landed
    struct Slab {
      const unsigned char* k;
      const unsigned char* v;
      float ksf, vsf;
      int kpos0;
    };
    auto wait_slab = [&](int i) {
      const int st = i % a.stages;
      mbar_wait(full + 8 * st, (i / a.stages) & 1);
      Slab pg;
      const unsigned char* stage = sm + st * a.stage_bytes;
      pg.k = stage + hl * DP * es;
      pg.v = pg.k + a.box_bytes;
      pg.ksf = pg.vsf = 1.f;
      if constexpr (kQuant) {
        const float* sc = reinterpret_cast<const float*>(stage + 2 * a.box_bytes);
        pg.ksf = sc[hl] / 127.f;
        pg.vsf = sc[a.hg + hl] / 127.f;
      }
      pg.kpos0 = (sl_beg + i) * a.ct;
      return pg;
    };
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (i % a.stages));
    };
    if constexpr (!kTile) {
      // decode: lane (key grp, slice s) of each pass of 32 / S keys over NP
      // slabs at once (two while two remain; four measured no faster): one
      // softmax update per pass;
      // dot products finished by shuffles, P.V with lanes over D
      constexpr int KC = 32 / S;
      const int qp = pos + q0 + lq;
      auto step = [&](int i, auto np) {
        constexpr int NP = decltype(np)::value;
        Slab pg[NP];
#pragma unroll
        for (int n = 0; n < NP; ++n) pg[n] = wait_slab(i + n);
        if (ok && pg[0].kpos0 <= qp) {
          for (int kc = 0; kc < a.ct && pg[0].kpos0 + kc <= qp; kc += KC) {
            const int j = kc + grp;
            float sc[NP], mx = kNeg;
#pragma unroll
            for (int n = 0; n < NP; ++n) {
              const bool key = j < a.ct && pg[n].kpos0 + j <= qp;
              float dot = 0.f;
              if (key) {
                float half[2] = {0.f, 0.f};  // two chains of FMAs
#pragma unroll
                for (int k = 0; k < NCH; ++k) {
                  float f[E];
                  unpack16<TKV>(pg[n].k + j * rs + chunk(k) * 16, f);
#pragma unroll
                  for (int e = 0; e < E; ++e)
                    half[e & 1] = fmaf(qv[0][k * E + e], f[e], half[e & 1]);
                }
                dot = half[0] + half[1];
              }
#pragma unroll
              for (int o = 1; o < S; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
              float x = dot * a.sm_scale;
              if constexpr (kQuant) x *= pg[n].ksf;
              sc[n] = key ? x : kNeg;
              mx = fmaxf(mx, sc[n]);
            }
            // the running max moves only when a score passes it by more
            // than 8 (p then stays below e^8): most passes skip the
            // reduction and the rescale
            float m_new = m[0], alpha = 1.f;
            if (__any_sync(0xffffffffu, mx > m[0] + 8.f)) {
#pragma unroll
              for (int o = S; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
              m_new = fmaxf(m[0], mx);
              alpha = expf(m[0] - m_new);
            }
            // p is 0 for every dead key (masked, or past the slab)
            float p[NP], psum = 0.f;
#pragma unroll
            for (int n = 0; n < NP; ++n) {
              p[n] = sc[n] <= 0.5f * kNeg ? 0.f : expf(sc[n] - m_new);
              psum += p[n];
            }
            // the row sum stays a sum per key lane (slice 0) until the end
            l[0] = l[0] * alpha + (s == 0 ? psum : 0.f);
            m[0] = m_new;
            // P.V over the pass's keys, lanes over D, without branches: rows
            // past the last live key are read (clamped to the slab) but
            // never multiplied in
            float pv[DQ];
#pragma unroll
            for (int d = 0; d < DQ; ++d) pv[d] = 0.f;
#pragma unroll
            for (int n = 0; n < NP; ++n) {
              const int nk = min(min(KC, a.ct - kc), qp - pg[n].kpos0 - kc + 1);
              const unsigned char* vcol = pg[n].v + lane * DQ * es;
              const float w = kQuant ? pg[n].vsf : 1.f;
#pragma unroll
              for (int jj = 0; jj < KC; ++jj) {
                const float pj = __shfl_sync(0xffffffffu, p[n], jj * S) * w;
                float f[DQ];
                load_vals<TKV, DQ>(vcol + min(kc + jj, a.ct - 1) * rs, f);
#pragma unroll
                for (int d = 0; d < DQ; ++d) pv[d] = fmaf(pj, jj < nk ? f[d] : 0.f, pv[d]);
              }
            }
#pragma unroll
            for (int d = 0; d < DQ; ++d) acc[0][d] = fmaf(acc[0][d], alpha, pv[d]);
          }
        }
#pragma unroll
        for (int n = 0; n < NP; ++n) release(i + n);
      };
      int i = 0;
      for (; i + 2 <= count; i += 2) step(i, std::integral_constant<int, 2>{});
      if (i < count) step(i, std::integral_constant<int, 1>{});
    } else {
      for (int i = 0; i < count; ++i) {
        const Slab pg = wait_slab(i);
        const int kpos0 = pg.kpos0;
        if (ok && kpos0 <= qmax) {
          // tile: every lane walks every key of the group, its two queries
          // against its 32 values; dots finished by shuffles over the S
          // slices; the online softmax per group of 4 keys. No branch per
          // key, so the group's loads and products interleave: rows past
          // the slab are read clamped to it, and keys past a query or the
          // slab score -1e30 and are never multiplied in
          for (int j0 = 0; j0 < a.ct && kpos0 + j0 <= qmax; j0 += kKeyGroup) {
            float sc[NQ][kKeyGroup];
#pragma unroll
            for (int jj = 0; jj < kKeyGroup; ++jj) {
              const int j = min(j0 + jj, a.ct - 1);
              float dot[NQ] = {};
#pragma unroll
              for (int k = 0; k < NCH; ++k) {
                float f[E];
                unpack16<TKV>(pg.k + j * rs + chunk(k) * 16, f);
#pragma unroll
                for (int e = 0; e < E; ++e)
#pragma unroll
                  for (int t = 0; t < NQ; ++t) dot[t] = fmaf(qv[t][k * E + e], f[e], dot[t]);
              }
#pragma unroll
              for (int t = 0; t < NQ; ++t) {
#pragma unroll
                for (int o = 1; o < S; o <<= 1) dot[t] += __shfl_xor_sync(0xffffffffu, dot[t], o);
                float x = dot[t] * a.sm_scale;
                if constexpr (kQuant) x *= pg.ksf;
                sc[t][jj] = j0 + jj < a.ct && kpos0 + j0 + jj <= pos + q0 + lq + t ? x : kNeg;
              }
            }
#pragma unroll
            for (int t = 0; t < NQ; ++t) {
              float gm = kNeg;
#pragma unroll
              for (int jj = 0; jj < kKeyGroup; ++jj) gm = fmaxf(gm, sc[t][jj]);
              const float m_new = fmaxf(m[t], gm);
              const float alpha = expf(m[t] - m_new);
              m[t] = m_new;
              l[t] *= alpha;
#pragma unroll
              for (int d = 0; d < DQ; ++d) acc[t][d] *= alpha;
#pragma unroll
              for (int jj = 0; jj < kKeyGroup; ++jj) {
                const float p = sc[t][jj] <= 0.5f * kNeg ? 0.f : expf(sc[t][jj] - m_new);
                l[t] += p;
                sc[t][jj] = kQuant ? p * pg.vsf : p;
              }
            }
#pragma unroll
            for (int jj = 0; jj < kKeyGroup; ++jj) {
              const int j = min(j0 + jj, a.ct - 1);
              const bool live = j0 + jj < a.ct;
#pragma unroll
              for (int k = 0; k < NCH; ++k) {
                float f[E];
                unpack16<TKV>(pg.v + j * rs + chunk(k) * 16, f);
#pragma unroll
                for (int e = 0; e < E; ++e) {
                  const float v = live ? f[e] : 0.f;
#pragma unroll
                  for (int t = 0; t < NQ; ++t)
                    acc[t][k * E + e] = fmaf(sc[t][jj], v, acc[t][k * E + e]);
                }
              }
            }
          }
        }
        release(i);
      }
    }
  }

  if constexpr (!kTile) {  // the decode row sum: one reduction over the key lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) l[0] += __shfl_xor_sync(0xffffffffu, l[0], o);
  }
  if (C > 1) {  // split walks: rank 0 merges the ranks' (m, l, acc) in order
    cg::cluster_group cl = cg::this_cluster();
    constexpr int F = NQ * (DQ + 2);  // floats a lane leaves: per query m, l, acc
    float* mg = reinterpret_cast<float*>(sm);  // [warps][F][32], in the drained ring
    if (warp < a.warps) {
      // every consumer is done with the ring before any overwrites it
      asm volatile("bar.sync 1, %0;" ::"r"(32 * a.warps) : "memory");
      if (rank > 0) {
        float* mine = mg + warp * F * 32 + lane;
#pragma unroll
        for (int t = 0; t < NQ; ++t) {
          mine[32 * t * (DQ + 2)] = m[t];
          mine[32 * (t * (DQ + 2) + 1)] = l[t];
#pragma unroll
          for (int d = 0; d < DQ; ++d) mine[32 * (t * (DQ + 2) + 2 + d)] = acc[t][d];
        }
      }
    }
    cl.sync();
    if (rank == 0 && warp < a.warps) {
      const int at = warp * F * 32 + lane;
#pragma unroll
      for (int t = 0; t < NQ; ++t) {
        const int f0 = at + 32 * t * (DQ + 2);
        // every rank's max first, the loads all in flight together
        float mr[kMaxCluster];
#pragma unroll
        for (int r = 1; r < kMaxCluster; ++r)
          mr[r] = r < C ? cl.map_shared_rank(mg, r)[f0] : kNeg;
        float mt = m[t];
#pragma unroll
        for (int r = 1; r < kMaxCluster; ++r) mt = fmaxf(mt, mr[r]);
        const float w0 = expf(m[t] - mt);
        l[t] *= w0;
#pragma unroll
        for (int d = 0; d < DQ; ++d) acc[t][d] *= w0;
        // then each rank's (l, acc), weighted, in rank order
#pragma unroll
        for (int r = 1; r < kMaxCluster; ++r) {
          if (r < C) {
            const float* other = cl.map_shared_rank(mg, r) + f0;
            const float wr = expf(mr[r] - mt);
            l[t] = fmaf(other[32], wr, l[t]);
#pragma unroll
            for (int d = 0; d < DQ; ++d) acc[t][d] = fmaf(other[32 * (2 + d)], wr, acc[t][d]);
          }
        }
      }
    }
    cl.sync();  // no rank leaves while rank 0 reads its shared memory
    if (rank > 0) return;
  }
  if (!ok) return;
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    if (lq + t >= nq) continue;
    TQ* o = static_cast<TQ*>(a.out) + (((size_t)b * a.L + q0 + lq + t) * a.H + h0 + hl) * a.D;
    const float inv = 1.f / fmaxf(l[t], 1e-9f);
    if constexpr (!kTile) {
      store_vals<TQ, DQ>(o, lane * DQ, a.D, acc[t], inv);
    } else {
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        float v[E];
#pragma unroll
        for (int e = 0; e < E; ++e) v[e] = acc[t][k * E + e];
        store_vals<TQ, E>(o, (s + S * k) * E, a.D, v, inv);
      }
    }
  }
}

template <typename TQ, typename TKV, int DP, bool kTile>
int launch(const Args& a, const CUtensorMap& tk, const CUtensorMap& tv, int cluster, int smem,
           cudaStream_t stream) {
  const auto kern = paged_attention_ring_kernel<TQ, TKV, DP, kTile>;
  // the shared-memory limit is raised once per device for this
  // instantiation, not on every call
  static std::atomic<uint64_t> raised{0};  // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const uint64_t bit = uint64_t(1) << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    raised.fetch_or(bit);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (a.H + a.hg - 1) / a.hg, a.B * a.n_qt);
  cfg.blockDim = dim3(32 * (a.warps + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a, tk, tv);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int dispatch_shape(int dp, bool tile, const Args& a, const CUtensorMap& tk, const CUtensorMap& tv,
                   int cluster, int smem, cudaStream_t st) {
  if (dp == 64)
    return tile ? launch<TQ, TKV, 64, true>(a, tk, tv, cluster, smem, st)
                : launch<TQ, TKV, 64, false>(a, tk, tv, cluster, smem, st);
  return tile ? launch<TQ, TKV, 128, true>(a, tk, tv, cluster, smem, st)
              : launch<TQ, TKV, 128, false>(a, tk, tv, cluster, smem, st);
}

template <typename TQ>
int dispatch_kv(int kv_dtype, int dp, bool tile, const Args& a, const CUtensorMap& tk,
                const CUtensorMap& tv, int cluster, int smem, cudaStream_t st) {
  switch (kv_dtype) {
    case kF32: return dispatch_shape<TQ, float>(dp, tile, a, tk, tv, cluster, smem, st);
    case kBF16: return dispatch_shape<TQ, __nv_bfloat16>(dp, tile, a, tk, tv, cluster, smem, st);
    case kI8: return dispatch_shape<TQ, int8_t>(dp, tile, a, tk, tv, cluster, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tensor map of an arena [N, pt, H, D] as the 3-D tensor (D, H, N * pt)
// with boxes of (DP, hg, ct): one slab's token rows for a head group,
// values past D and heads past H filled with zeros. An arena lives as long
// as its decoder, so maps are kept by everything they encode (address,
// shape, dtype, box) and not encoded again on every call; a new arena at a
// freed one's address with the same shape gets the same map. One model
// needs a map a layer, arena and box (head groups and slabs change with
// the batch and L), so the table holds 1024 and is emptied, not churned,
// when three quarters are used.
struct MapKey {
  const void* p;
  int n, pt, h, d, dtype, hg, ct;
  bool operator==(const MapKey& o) const {
    return p == o.p && n == o.n && pt == o.pt && h == o.h && d == o.d && dtype == o.dtype &&
           hg == o.hg && ct == o.ct;
  }
};

constexpr int kMapSlots = 1024;  // a power of two

struct MapCache {
  std::mutex mu;
  MapKey keys[kMapSlots];
  CUtensorMap maps[kMapSlots];
  bool used[kMapSlots];
  int filled;
  long long encodes, clears;
};

MapCache& map_cache() {
  static MapCache c;  // zero-initialized: static storage
  return c;
}

int map_slot(const MapKey& k) {
  uint64_t h = reinterpret_cast<uintptr_t>(k.p);
  for (const int f : {k.n, k.pt, k.h, k.d, k.dtype, k.hg, k.ct})
    h = (h ^ (uint32_t)f) * 0x100000001B3ull;
  h ^= h >> 29;
  h *= 0xBF58476D1CE4E5B9ull;
  return (int)(h >> 40) & (kMapSlots - 1);
}

int arena_map(CUtensorMap* map, const MapKey& k) {
  MapCache& c = map_cache();
  std::lock_guard<std::mutex> lock(c.mu);
  int i = map_slot(k);
  for (; c.used[i]; i = (i + 1) & (kMapSlots - 1))
    if (c.keys[i] == k) {
      *map = c.maps[i];
      return 0;
    }
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  const int es = k.dtype == kF32 ? 4 : k.dtype == kBF16 ? 2 : 1;
  const CUtensorMapDataType type = k.dtype == kF32    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : k.dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                      : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t dims[3] = {(cuuint64_t)k.d, (cuuint64_t)k.h, (cuuint64_t)k.n * k.pt};
  const cuuint64_t strides[2] = {(cuuint64_t)k.d * es, (cuuint64_t)k.h * k.d * es};
  const cuuint32_t box[3] = {k.d <= 64 ? 64u : 128u, (cuuint32_t)k.hg, (cuuint32_t)k.ct};
  const cuuint32_t step[3] = {1, 1, 1};
  CUtensorMap m;
  memset(&m, 0, sizeof(m));
  if (enc(&m, type, 3, const_cast<void*>(k.p), dims, strides, box, step,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  if (4 * (c.filled + 1) > 3 * kMapSlots) {
    memset(c.used, 0, sizeof(c.used));
    c.filled = 0;
    ++c.clears;
    i = map_slot(k);
  }
  c.used[i] = true;
  c.keys[i] = k;
  c.maps[i] = m;
  ++c.filled;
  ++c.encodes;
  *map = m;
  return 0;
}

}  // namespace

// q, out [B, L, H, D] (q_dtype); k_pages, v_pages [N, pt, H, D] (kv_dtype),
// 16-byte aligned, N pages; k_scale, v_scale [N, H] f32 (int8 arenas only, else
// null); pages [B, P] and positions [B] int32. All contiguous, D 1-128 (the
// kernel pads it to DP, 64 or 128). `plan` is the launch (see Plan): hg
// heads and qtile queries a block (decode mapping: one warp per (head,
// query); tile mapping: 2048 / DP queries a warp), `stages` ring stages of
// ct-token slabs, a cluster of 1-8 blocks splitting each tile's slabs.
// Returns cudaGetLastError() after the one launch.
extern "C" int kubeml_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                      const void* k_scale, const void* v_scale, const void* pages,
                                      const void* positions, void* out, int B, int L, int H,
                                      int D, int N, int pt, int P, const void* plan, int q_dtype,
                                      int kv_dtype, void* stream) {
  if (plan == nullptr || kv_dtype < kF32 || kv_dtype > kI8) return (int)cudaErrorInvalidValue;
  const Plan& p = *static_cast<const Plan*>(plan);
  const int es = kv_dtype == kF32 ? 4 : kv_dtype == kBF16 ? 2 : 1;
  const bool quant = kv_dtype == kI8, tile = p.tile != 0;
  const int dp = D <= 64 ? 64 : 128, lpw = 2048 / dp;
  if (B < 1 || L < 1 || H < 1 || D < 1 || D > 128 || N < 1 || pt < 1 || P < 1 ||
      reinterpret_cast<uintptr_t>(k_pages) % 16 || reinterpret_cast<uintptr_t>(v_pages) % 16 ||
      (quant && (k_scale == nullptr || v_scale == nullptr)) || (long long)N * pt > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  // the plan: a geometry the kernel serves, and a layout that holds the
  // boxes, the scales, the ring and the merge buffer within the card's limit
  const long long merge = 4LL * p.warps * 32 * (tile ? 2 * 34 : dp / 32 + 2);
  if (p.hg < 1 || p.hg > H || p.hg > 8 || p.qtile < 1 || p.stages < 2 || p.cluster < 1 ||
      p.cluster > kMaxCluster || p.ct < 1 || p.ct > 256 || pt % p.ct != 0 ||
      (tile && p.qtile % lpw != 0) || p.warps < 1 || p.warps > kMaxWarps ||
      p.warps != p.hg * (tile ? p.qtile / lpw : p.qtile) || p.box_bytes % 128 != 0 ||
      p.box_bytes < (long long)p.ct * p.hg * dp * es || p.stage_bytes % 128 != 0 ||
      p.stage_bytes < 2LL * p.box_bytes + (quant ? 8 * p.hg : 0) ||
      p.area_bytes < (long long)p.stages * p.stage_bytes || p.area_bytes < merge ||
      p.smem < p.area_bytes + 16LL * p.stages + 128 || p.smem > kMaxSmem ||
      (p.tma && (D * es) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const int n_qt = (L + p.qtile - 1) / p.qtile;
  if ((long long)B * n_qt > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tk, tv;
  memset(&tk, 0, sizeof(tk));
  memset(&tv, 0, sizeof(tv));
  int e;
  if (p.tma && ((e = arena_map(&tk, MapKey{k_pages, N, pt, H, D, kv_dtype, p.hg, p.ct})) ||
                (e = arena_map(&tv, MapKey{v_pages, N, pt, H, D, kv_dtype, p.hg, p.ct}))))
    return e;
  Args a{};
  a.q = q;
  a.kp = k_pages;
  a.vp = v_pages;
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.pages = static_cast<const int*>(pages);
  a.positions = static_cast<const int*>(positions);
  a.out = out;
  a.B = B, a.L = L, a.H = H, a.D = D, a.pt = pt, a.P = P;
  a.hg = p.hg, a.qtile = p.qtile, a.n_qt = n_qt, a.warps = p.warps, a.stages = p.stages;
  a.ct = p.ct, a.box_bytes = p.box_bytes, a.stage_bytes = p.stage_bytes;
  a.area_bytes = p.area_bytes, a.tma = p.tma, a.nsub = pt / p.ct;
  a.sm_scale = 1.f / sqrtf((float)D);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32: return dispatch_kv<float>(kv_dtype, dp, tile, a, tk, tv, p.cluster, p.smem, s);
    case kBF16:
      return dispatch_kv<__nv_bfloat16>(kv_dtype, dp, tile, a, tk, tv, p.cluster, p.smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tensor-map table's counts since the process started: out[0] maps
// encoded, out[1] times the table was emptied, out[2] maps held.
extern "C" int kubeml_paged_attention_map_stats(long long* out) {
  MapCache& c = map_cache();
  std::lock_guard<std::mutex> lock(c.mu);
  out[0] = c.encodes;
  out[1] = c.clears;
  out[2] = c.filled;
  return 0;
}
