// Device bodies shared by the five attention kernels of attention.cu.
//
// Each body computes ONE work item with the whole CTA (THREADS threads):
//   flash_item        one (batch*head, 64-row query tile) of causal /
//                     windowed prefill attention on the CUDA cores, fp32;
//   flash_tc_item     the same over a 128-row query tile on the tensor
//                     cores (wgmma, bf16 operands, fp32 accumulators), K/V
//                     tiles through TMA: the bf16 body;
//   paged_decode_item one (slot, kv head) of single-token GQA decode over
//                     the shared page pool, online softmax over pages: the
//                     fp32 body;
//   decode_item       the same over a dense per-slot cache, masked by
//                     kv_positions (ring caches included): the fp32 body;
//   split_decode_item one piece of a (slot, kv head)'s rows, of the dense
//                     cache or of the page pool (a row-source policy says
//                     where a tile's rows live); the last piece to finish
//                     merges them all: the bf16 body of both caches
//                     (flash-decoding).
// The standalone kernels run one item per CTA; the fused bullet kernels
// loop their CTAs over items of either kind. Because the fused kernels
// call these same bodies with the same block size, their outputs equal
// the standalone kernels' bit for bit. The type decides the body: float
// runs flash_item, paged_decode_item and decode_item, bfloat16
// flash_tc_item and split_decode_item, so each dtype's arithmetic is fixed.
//
// The split's geometry (SPLIT_TILE, MAX_SPLIT, SPLIT_G, SPLIT_MIN_TILES)
// is not stated here: the build passes it as -D defines from the one
// Python module that the wrappers read too (repro_torch/kernels/
// geometry.py).
//
// Numerics follow the TPU kernels they replace: softmax statistics and
// accumulators stay fp32, masked logits are -1e30, out = acc / max(l,
// 1e-30). The fp32 bodies scale q by D^-0.5 in fp32; the bf16 bodies
// (tensor cores) scale the fp32 logits of the bf16 product instead and
// round the probabilities to bf16 for the PV product. A decode slot with
// pos < 0 (or, dense, no attended row) returns zeros.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda.h>  // CUtensorMap (the maps are encoded through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#if !defined(SPLIT_TILE) || !defined(MAX_SPLIT) || !defined(SPLIT_G) || \
    !defined(SPLIT_MIN_TILES)
#error "SPLIT_TILE, MAX_SPLIT, SPLIT_G, SPLIT_MIN_TILES come from the build (geometry.py)"
#endif

namespace bullet {

constexpr int THREADS = 256;              // every kernel's block size
constexpr int ROW_THREADS = 4;            // threads that share a query row
constexpr int BQ = THREADS / ROW_THREADS; // query rows per prefill tile
constexpr int BK = 32;                    // keys per prefill KV tile
constexpr int COLS = BK / ROW_THREADS;    // score columns per thread
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// -------------------------------------------------------------------------
// Prefill: flash attention over (BH, S, D), GQA kv head = bh / group.
// -------------------------------------------------------------------------

struct FlashArgs {
  const void *q, *k, *v;
  void *o;
  // q_offset: the position of query row 0 among the keys (a chunk of a
  // prompt whose first q_offset tokens are already in k and v); query row
  // i sits at q_offset + i, key row j at j
  int bh, sq, sk, group, causal, window, q_offset;
  float scale;
  // bf16 only: TMA maps of q, k and v as 3-D (D, S, heads) views, encoded
  // host-side by the C entry point (q in boxes of 64 columns x TC_BQ rows,
  // k and v of 64 x TC_BK); the kernel takes FlashArgs as a
  // __grid_constant__ parameter so the maps stay in parameter space
  CUtensorMap tq, tk, tv;
};

// shared floats: Q tile [BQ][D+1], K tile [BK][D+1], V tile [BK][D],
// P tile [BQ][BK+1] (+1 pads keep the column walks free of bank conflicts)
__host__ __device__ constexpr int flash_smem_floats(int d) {
  return BQ * (d + 1) + BK * (d + 1) + BK * d + BQ * (BK + 1);
}

// query rows per prefill item: BQ for the fp32 body, TC_BQ for bf16
constexpr int TC_BQ = 128;
template <typename T> __host__ __device__ constexpr int flash_bq() {
  return std::is_same<T, float>::value ? BQ : TC_BQ;
}
template <typename T> __host__ __device__ inline int flash_q_tiles(int sq) {
  return (sq + flash_bq<T>() - 1) / flash_bq<T>();
}

// One (bh, q-tile) item. Thread t owns query row r = t / 4 of the tile; the
// 4 threads of a row split the tile's BK key columns (c = j + 4*i) for
// QK^T and the head dims (d = j + 4*i) for PV.
template <typename T, int D>
__device__ void flash_item(const FlashArgs &a, int item, float *smem) {
  const T *q = static_cast<const T *>(a.q);
  const T *k = static_cast<const T *>(a.k);
  const T *v = static_cast<const T *>(a.v);
  T *o = static_cast<T *>(a.o);
  float *Qs = smem;
  float *Ks = Qs + BQ * (D + 1);
  float *Vs = Ks + BK * (D + 1);
  float *Ps = Vs + BK * D;

  const int n_qt = flash_q_tiles<float>(a.sq);
  const int bh = item / n_qt, qt = item % n_qt;
  const int kvh = bh / a.group;
  const int tid = threadIdx.x;
  const int r = tid / ROW_THREADS, j = tid % ROW_THREADS;
  const int q0 = qt * BQ;
  const int q_hi = min(q0 + BQ, a.sq) - 1;   // last real query row
  // positions of the tile's first and last real rows, and of row r
  const int p0 = q0 + a.q_offset, p_hi = q_hi + a.q_offset;
  const int qrow = q0 + r, qpos = p0 + r;

  __syncthreads();  // smem may still be read by the previous item
  for (int e = tid; e < BQ * D; e += THREADS) {
    const int row = e / D, col = e % D;
    const int s = q0 + row;
    Qs[row * (D + 1) + col] =
        s < a.sq ? to_f(q[((size_t)bh * a.sq + s) * D + col]) * a.scale : 0.f;
  }

  float m = NEG_INF, l = 0.f;
  float acc[D / ROW_THREADS];
#pragma unroll
  for (int i = 0; i < D / ROW_THREADS; ++i) acc[i] = 0.f;

  const int n_kt = (a.sk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    // skip tiles every real row of this q tile masks out (uniform per CTA)
    if (a.causal && k0 > p_hi) break;
    if (a.window > 0 && k0 + BK - 1 <= p0 - a.window) continue;

    __syncthreads();  // previous tile's K/V/P fully consumed
    for (int e = tid; e < BK * D; e += THREADS) {
      const int row = e / D, col = e % D;
      const int s = k0 + row;
      const bool in = s < a.sk;
      const size_t g = ((size_t)kvh * a.sk + s) * D + col;
      Ks[row * (D + 1) + col] = in ? to_f(k[g]) : 0.f;
      Vs[row * D + col] = in ? to_f(v[g]) : 0.f;
    }
    __syncthreads();

    float sc[COLS];
#pragma unroll
    for (int i = 0; i < COLS; ++i) sc[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = Qs[r * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < COLS; ++i)
        sc[i] += qd * Ks[(j + ROW_THREADS * i) * (D + 1) + d];
    }
    float tmax = NEG_INF;
    bool valid[COLS];
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const int kpos = k0 + j + ROW_THREADS * i;
      bool ok = kpos < a.sk;
      if (a.causal) ok = ok && kpos <= qpos;
      if (a.window > 0) ok = ok && kpos > qpos - a.window;
      valid[i] = ok;
      sc[i] = ok ? sc[i] : NEG_INF;
      tmax = fmaxf(tmax, sc[i]);
    }
    // the 4 threads of a row are adjacent lanes: butterfly over them
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const float p = valid[i] ? expf(sc[i] - m_new) : 0.f;
      Ps[r * (BK + 1) + j + ROW_THREADS * i] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();  // the row's P values come from all 4 of its threads

#pragma unroll
    for (int i = 0; i < D / ROW_THREADS; ++i) acc[i] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float p = Ps[r * (BK + 1) + c];
#pragma unroll
      for (int i = 0; i < D / ROW_THREADS; ++i)
        acc[i] += p * Vs[c * D + j + ROW_THREADS * i];
    }
  }

  if (qrow < a.sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T *orow = o + ((size_t)bh * a.sq + qrow) * D;
#pragma unroll
    for (int i = 0; i < D / ROW_THREADS; ++i)
      orow[j + ROW_THREADS * i] = from_f<T>(acc[i] * inv);
  }
}

// -------------------------------------------------------------------------
// Decode: one token per slot, over the page pool or over a per-slot cache.
// -------------------------------------------------------------------------

struct DecodeArgs {              // the paged cache
  const void *q;                 // (B, K, G, D)
  const void *kp, *vp;           // (P+1, ps, K, D)
  const int *bt;                 // (B, n_b) physical page per block
  const int *pos;                // (B,) position of the new token, <0 idle
  void *o;                       // (B, K, G, D)
  int b, kh, g, ps, n_b;
  float scale;
  // bf16 only (split_decode_item), as DenseDecodeArgs
  int n_split;
  float *ws_acc;                 // (B*K, n_split, G, D) partial accumulators
  float *ws_ml;                  // (B*K, n_split, G, 2) partial (m, l)
  int *counts;                   // (B*K,) zero at launch; reset by the merger
};

struct DenseDecodeArgs {         // the dense per-slot cache
  const void *q;                 // (B, K, G, D)
  const void *k, *v;             // (B, S, K, D)
  const int *kvpos;              // (B, S) absolute position per row, <0 empty
  const int *pos;                // (B,) position of the new token
  void *o;                       // (B, K, G, D)
  int b, kh, g, s;
  float scale;
  // bf16 only (split_decode_item): pieces per (slot, kv head), and for
  // n_split > 1 the partials' workspace and the arrival counters
  int n_split;
  float *ws_acc;                 // (B*K, n_split, G, D) partial accumulators
  float *ws_ml;                  // (B*K, n_split, G, 2) partial (m, l)
  int *counts;                   // (B*K,) zero at launch; reset by the merger
};

// rows per tile of the dense cache: the paged pool's page size, so that with
// linear positions dense and paged decode walk the same rows in the same
// tiles
constexpr int DECODE_TILE = 16;

// shared floats: q [G][D], K tile [rows][D], V tile [rows][D], scores
// [G][rows], acc [G][D], m / l / alpha [G], then (dense) one int per tile
// row: the row is attended
__host__ __device__ inline int decode_smem_floats(int g, int rows, int d) {
  return 2 * g * d + 2 * rows * d + g * rows + 3 * g + rows;
}

// One (slot, kv head) item: the G query heads of that kv head share the
// CTA. Walks only the pages that hold positions <= pos; the rest of the
// table is fully masked and would leave m, l and acc unchanged exactly.
template <typename T, int D>
__device__ void paged_decode_item(const DecodeArgs &a, int item,
                                  float *smem) {
  const T *q = static_cast<const T *>(a.q);
  const T *kp = static_cast<const T *>(a.kp);
  const T *vp = static_cast<const T *>(a.vp);
  T *o = static_cast<T *>(a.o);
  const int G = a.g, PS = a.ps;
  float *qs = smem;
  float *ks = qs + G * D;
  float *vs = ks + PS * D;
  float *sc = vs + PS * D;
  float *acc = sc + G * PS;
  float *ms = acc + G * D;
  float *ls = ms + G;
  float *al = ls + G;

  const int b = item / a.kh, h = item % a.kh;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int pos = a.pos[b];
  const int n_live = pos < 0 ? 0 : min(a.n_b, pos / PS + 1);
  const size_t qo = ((size_t)b * a.kh + h) * G * D;

  __syncthreads();  // smem may still be read by the previous item
  for (int e = tid; e < G * D; e += THREADS) {
    qs[e] = to_f(q[qo + e]) * a.scale;
    acc[e] = 0.f;
  }
  for (int e = tid; e < G; e += THREADS) {
    ms[e] = NEG_INF;
    ls[e] = 0.f;
  }

  for (int i = 0; i < n_live; ++i) {
    const int page = a.bt[(size_t)b * a.n_b + i];
    __syncthreads();  // previous page fully consumed
    for (int e = tid; e < PS * D; e += THREADS) {
      const int t = e / D, d = e % D;
      const size_t gi = (((size_t)page * PS + t) * a.kh + h) * D + d;
      ks[e] = to_f(kp[gi]);
      vs[e] = to_f(vp[gi]);
    }
    __syncthreads();
    // scores: one warp per (g, t), lanes split the head dim
    for (int s = warp; s < G * PS; s += WARPS) {
      const int gg = s / PS, t = s % PS;
      float part = 0.f;
      for (int d = lane; d < D; d += 32) part += qs[gg * D + d] * ks[t * D + d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) sc[s] = i * PS + t <= pos ? part : NEG_INF;
    }
    __syncthreads();
    // online softmax: one warp per query head g
    for (int gg = warp; gg < G; gg += WARPS) {
      float tmax = NEG_INF;
      for (int t = lane; t < PS; t += 32) tmax = fmaxf(tmax, sc[gg * PS + t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_old = ms[gg];
      const float m_new = fmaxf(m_old, tmax);
      float psum = 0.f;
      for (int t = lane; t < PS; t += 32) {
        const float p =
            i * PS + t <= pos ? expf(sc[gg * PS + t] - m_new) : 0.f;
        sc[gg * PS + t] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        al[gg] = alpha;
        ls[gg] = ls[gg] * alpha + psum;
        ms[gg] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < G * D; e += THREADS) {
      const int gg = e / D, d = e % D;
      float x = acc[e] * al[gg];
      for (int t = 0; t < PS; ++t) x += sc[gg * PS + t] * vs[t * D + d];
      acc[e] = x;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += THREADS)
    o[qo + e] = from_f<T>(acc[e] / fmaxf(ls[e / D], 1e-30f));
}

// One (slot b, kv head h) item over the dense per-slot cache: the G query
// heads of that kv head share the CTA and walk the slot's S rows in tiles of
// DECODE_TILE rows with an online softmax. Row j is attended when
// 0 <= kv_positions[b, j] <= pos; the tail tile is masked, so any S works.
// A tile none of whose rows is attended is skipped whole (it would leave m,
// l and acc unchanged exactly); that is decided from the positions, never
// from the tile's index, since a ring cache's rows are not ordered by
// position. A slot with no attended row returns zeros. Products and sums
// are spelled with the round-to-nearest intrinsics in the order of the
// paged body's compiled arithmetic, so with linear positions the two agree
// bit for bit (tests/port/test_torch_kernels_cuda.py checks it on the card).
template <typename T, int D>
__device__ void decode_item(const DenseDecodeArgs &a, int item,
                            float *smem) {
  constexpr int R = DECODE_TILE;
  const T *q = static_cast<const T *>(a.q);
  const T *kc = static_cast<const T *>(a.k);
  const T *vc = static_cast<const T *>(a.v);
  T *o = static_cast<T *>(a.o);
  const int G = a.g;
  float *qs = smem;
  float *ks = qs + G * D;
  float *vs = ks + R * D;
  float *sc = vs + R * D;
  float *acc = sc + G * R;
  float *ms = acc + G * D;
  float *ls = ms + G;
  float *al = ls + G;
  int *ok = reinterpret_cast<int *>(al + G);

  const int b = item / a.kh, h = item % a.kh;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int pos = a.pos[b];
  const int n_tiles = pos < 0 ? 0 : (a.s + R - 1) / R;
  const size_t qo = ((size_t)b * a.kh + h) * G * D;

  __syncthreads();  // smem may still be read by the previous item
  for (int e = tid; e < G * D; e += THREADS) {
    qs[e] = __fmul_rn(to_f(q[qo + e]), a.scale);
    acc[e] = 0.f;
  }
  for (int e = tid; e < G; e += THREADS) {
    ms[e] = NEG_INF;
    ls[e] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    __syncthreads();  // previous tile fully consumed
    int any = 0;
    for (int t = tid; t < R; t += THREADS) {
      const int j = i * R + t;                // row of the slot
      const int p = j < a.s ? a.kvpos[(size_t)b * a.s + j] : -1;
      ok[t] = p >= 0 && p <= pos;
      any |= ok[t];
    }
    if (!__syncthreads_or(any)) continue;   // uniform across the CTA
    const size_t row0 = (size_t)b * a.s + (size_t)i * R;  // the tile's row 0
    const int live = min(R, a.s - i * R);                 // rows that exist
    for (int e = tid; e < R * D; e += THREADS) {
      const int t = e / D, d = e % D;
      const size_t gi = ((row0 + t) * a.kh + h) * D + d;
      ks[e] = t < live ? to_f(kc[gi]) : 0.f;
      vs[e] = t < live ? to_f(vc[gi]) : 0.f;
    }
    __syncthreads();
    // scores: one warp per (g, t), lanes split the head dim
    for (int s = warp; s < G * R; s += WARPS) {
      const int gg = s / R, t = s % R;
      float part = 0.f;
      for (int d = lane; d < D; d += 32)
        part = __fmaf_rn(qs[gg * D + d], ks[t * D + d], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
      if (lane == 0) sc[s] = ok[t] ? part : NEG_INF;
    }
    __syncthreads();
    // online softmax: one warp per query head g
    for (int gg = warp; gg < G; gg += WARPS) {
      float tmax = NEG_INF;
      for (int t = lane; t < R; t += 32) tmax = fmaxf(tmax, sc[gg * R + t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_old = ms[gg];
      const float m_new = fmaxf(m_old, tmax);
      float psum = 0.f;
      for (int t = lane; t < R; t += 32) {
        const float p = ok[t] ? expf(__fsub_rn(sc[gg * R + t], m_new)) : 0.f;
        sc[gg * R + t] = p;
        psum = __fadd_rn(psum, p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, off));
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(__fsub_rn(m_old, m_new));
        al[gg] = alpha;
        ls[gg] = __fmaf_rn(ls[gg], alpha, psum);
        ms[gg] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < G * D; e += THREADS) {
      const int gg = e / D, d = e % D;
      float x = __fmul_rn(acc[e], al[gg]);
      for (int t = 0; t < R; ++t)
        x = __fmaf_rn(sc[gg * R + t], vs[t * D + d], x);
      acc[e] = x;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += THREADS)
    o[qo + e] = from_f<T>(__fdiv_rn(acc[e], fmaxf(ls[e / D], 1e-30f)));
}

// -------------------------------------------------------------------------
// Hopper (sm_90a) primitives of the bf16 bodies: mbarriers, TMA, wgmma.
// -------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_inval(uint32_t bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}
// the one expected arrival, plus the bytes the barrier's TMA loads bring
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes) : "memory");
}
// wait until the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// a (64 columns x rows x 1) box of a 3-D tensor map into shared memory
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap *map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving accesses of an accumulator across a wait
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// shared-memory matrix descriptor of a 128-byte-swizzled operand (the
// layout a SWIZZLE_128B TMA box writes): start address, leading and stride
// byte offsets (each >> 4), layout type 1 = 128B swizzle
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t *>(&v);
}

// wgmma.mma_async for the two products of flash_tc_item. The accumulator
// layout (m64nN, f32): thread t of the warpgroup holds d[i] at row
// 16*(t/32) + (t%32)/4 + 8*((i/2)%2), column 8*(i/4) + 2*(t%4) + i%2; the
// register A operand of m64k16 takes the same positions, so S's
// accumulator becomes P's operand without moving between threads.
// D(64x64) += A(64x16, shared) * B(16x64, shared), both K-major
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64x64) += A(64x16, registers) * B(16x64, shared, MN-major): the PV
// product at D = 64, where a row of V is one 128-byte swizzle chunk
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D(64x128) += A(64x16, registers) * B(16x128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D(64x256) += A(64x16, registers) * B(16x256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n256k16(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}


// -------------------------------------------------------------------------
// Prefill on the tensor cores (bf16): flash_tc_item.
// -------------------------------------------------------------------------

constexpr int TC_BK = 64;       // keys per K/V tile
constexpr int TC_STAGES = 2;    // K/V tiles in flight

// dynamic shared memory of flash_tc_item: 1024 bytes of alignment slack
// (128-byte swizzle atoms are 1024-byte aligned), the q tile, TC_STAGES
// K and V tiles, TC_STAGES + 1 mbarriers, a release count per stage
__host__ __device__ constexpr int flash_tc_smem_bytes(int d) {
  return 1024 + TC_BQ * d * 2 + TC_STAGES * 2 * TC_BK * d * 2 +
         8 * (TC_STAGES + 1) + 4 * TC_STAGES;
}

// One (bh, 128-row query tile) item in bf16. Warpgroup w (threads 128w ..
// 128w+127) owns query rows 64w .. 64w+63 of the tile. Thread 0 brings the
// q tile and a ring of TC_STAGES K/V tiles of 64 keys through TMA (128-byte
// swizzle, rows past S zero-filled); per K/V tile each warpgroup computes
// S = Q K^T with wgmma (A and B from shared memory, fp32 accumulators),
// masks the tile if it crosses the causal diagonal, the window's edge or
// the end of the keys, runs the online softmax on S in fp32 registers
// (base 2), rounds P to bf16 in registers and accumulates O += P V with
// wgmma (A from registers, V read MN-major). The warpgroups are not held
// in step: each releases a stage when its products are done, and the
// later of the two refills it, so one's softmax can overlap the other's
// products. Tiles that the causal or window mask removes whole for the
// CTA are never loaded; a warpgroup skips the ones it masks whole. The
// barriers are initialised per item and invalidated after it, so the
// persistent fused kernel starts each item at phase 0. With LSE (the
// forward of the gradient, an instantiation of its own) each row's
// log2-sum-exp2 goes to lse2 (BH, Sq) too. D = 64, 128 or 256:
// a row is D/64 chunks of 128 bytes (one at D = 64, so the q tile and each
// K/V tile are one TMA box and half D = 128's shared memory), and the PV
// product is one m64nDk16 wgmma per 16 keys (o holds D/2 floats a thread).
template <int D, bool LSE = false>
__device__ void flash_tc_item(const FlashArgs &a, int item,
                              unsigned char *smem, float *lse2 = nullptr) {
  constexpr int NC = D / 64;            // 128-byte column chunks of a row
  constexpr int QCH = TC_BQ * 128;      // one chunk of the q tile
  constexpr int KCH = TC_BK * 128;      // one chunk of a K or V tile
  constexpr int KVB = NC * KCH;         // one K or V tile
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t skv = sq + NC * QCH;   // stage s: K at skv + 2*s*KVB, V +KVB
  const uint32_t bars = skv + TC_STAGES * 2 * KVB;
  const uint32_t qbar = bars + 8 * TC_STAGES;
  // per stage: how many warpgroups have released it (generic pointer)
  int *done = reinterpret_cast<int *>(smem + (qbar + 8 - smem_u32(smem)));

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int lane = t % 32, pair = lane % 4;
  const int n_qt = flash_q_tiles<__nv_bfloat16>(a.sq);
  const int bh = item / n_qt;
  const int qt = n_qt - 1 - item % n_qt;   // a head's longest tiles first
  const int kvh = bh / a.group;
  const int q0 = qt * TC_BQ;              // the q tile's first row (TMA)
  const int q_hi = min(q0 + TC_BQ, a.sq) - 1;
  const int n_kt = (a.sk + TC_BK - 1) / TC_BK;
  // the K/V tiles some row of this q tile attends (uniform per CTA), from
  // the positions of its first and last rows
  const int kt_lo =
      a.window > 0 ? max(0, q0 + a.q_offset - a.window + 1) / TC_BK : 0;
  const int kt_hi =
      a.causal ? min(n_kt, (q_hi + a.q_offset) / TC_BK + 1) : n_kt;
  const int n = max(0, kt_hi - kt_lo);

  auto load_kv = [&](int s, int kt) {
    const uint32_t bar = bars + 8 * s, kb = skv + 2 * s * KVB;
    mbar_expect_tx(bar, 2 * KVB);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load_3d(kb + c * KCH, &a.tk, bar, c * 64, kt * TC_BK, kvh);
      tma_load_3d(kb + KVB + c * KCH, &a.tv, bar, c * 64, kt * TC_BK, kvh);
    }
  };

  __syncthreads();  // smem may still be read by the previous item
  if (tid == 0) {
    for (int s = 0; s <= TC_STAGES; ++s) mbar_init(bars + 8 * s, 1);
    for (int s = 0; s < TC_STAGES; ++s) done[s] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, NC * QCH);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load_3d(sq + c * QCH, &a.tq, qbar, c * 64, q0, bh);
    for (int s = 0; s < TC_STAGES && s < n; ++s) load_kv(s, kt_lo + s);
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows r0, r0 + 8
  const float sl2 = a.scale * 1.4426950408889634f;      // logits, base 2
  const int w_lo = q0 + 64 * wg;                         // warpgroup's rows
  const int w_hi = min(w_lo + 63, a.sq - 1);
  const int r0 = w_lo + 16 * (t / 32) + lane / 4;
  const uint32_t qa = sq + wg * 64 * 128;                // its A operand
  mbar_wait(qbar, 0);

  // the masks compare keys with query rows: kq is the tile's first key
  // position less the query offset, so query row r and key kq + c are
  // compared as positions q_offset + r and q_offset + kq + c are
  const int sk_q = a.sk - a.q_offset;  // the end of the keys, likewise
  for (int i = 0; i < n; ++i) {
    const int s = i % TC_STAGES, kq = (kt_lo + i) * TC_BK - a.q_offset;
    mbar_wait(bars + 8 * s, (i / TC_STAGES) & 1);
    const bool need = w_lo <= w_hi && (!a.causal || kq <= w_hi) &&
                      (a.window <= 0 || kq + TC_BK - 1 > w_lo - a.window);
    if (need) {  // uniform per warpgroup
      const uint32_t kb = skv + 2 * s * KVB, vb = kb + KVB;
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes
        wgmma_ss_m64n64k16(sc, sw128_desc(qa + (kk / 4) * QCH + off, 16, 1024),
                           sw128_desc(kb + (kk / 4) * KCH + off, 16, 1024),
                           kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);

      // mask only a tile that crosses the diagonal, the window's lower
      // edge or the end of the keys, for this warpgroup's rows
      const bool edge = (a.causal && kq + TC_BK - 1 > w_lo) ||
                        kq + TC_BK > sk_q ||
                        (a.window > 0 && kq <= w_hi - a.window);
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float x = sc[j] * sl2;
        if (edge) {
          const int kp = kq + 8 * (j / 4) + 2 * pair + j % 2;
          const int qp = r0 + 8 * ((j / 2) % 2);
          const bool ok = kp < sk_q && (!a.causal || kp <= qp) &&
                          (a.window <= 0 || kp > qp - a.window);
          x = ok ? x : -INFINITY;
        }
        sc[j] = x;
        if ((j / 2) % 2 == 0)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
      // a row's 64 columns lie on the 4 adjacent lanes of a quad
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float al0 = exp2f(m0 - n0), al1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      float s0 = 0.f, s1 = 0.f;  // this thread's share of the row sums
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const bool top = (j / 2) % 2 == 0;
        const float p = exp2f(sc[j] - (top ? n0 : n1));  // masked: 0
        sc[j] = p;
        if (top)
          s0 += p;
        else
          s1 += p;
      }
      l0 = l0 * al0 + s0;
      l1 = l1 * al1 + s1;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= (j / 2) % 2 == 0 ? al0 : al1;
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // keys 16kk .. 16kk+15: rows of V, 2048 bytes apart; the D columns
        // span NC chunks KCH apart (LBO), 8-row groups 1024 apart (SBO)
        // (at D = 64 one chunk: the LBO is never stepped)
        const uint64_t dv = sw128_desc(vb + kk * 16 * 128, KCH, 1024);
        if constexpr (D == 256)
          wgmma_rs_m64n256k16(o, pa[kk], dv, 1);
        else if constexpr (D == 128)
          wgmma_rs_m64n128k16(o, pa[kk], dv, 1);
        else
          wgmma_rs_m64n64k16(o, pa[kk], dv, 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
    }
    // this warpgroup is done with stage s; the later of the two refills it
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if (t == 0 && atomicAdd(done + s, 1) == 1) {
      done[s] = 0;
      if (i + TC_STAGES < n) load_kv(s, kt_lo + i + TC_STAGES);
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if constexpr (LSE) {
    // the gradient's forward: each row's log2-sum-exp2 of its scaled
    // logits, m + log2(l) in base 2 (the serving kernels compile this out)
    if (pair == 0 && r0 < a.sq)
      lse2[(size_t)bh * a.sq + r0] = m0 + log2f(fmaxf(l0, 1e-30f));
    if (pair == 0 && r0 + 8 < a.sq)
      lse2[(size_t)bh * a.sq + r0 + 8] = m1 + log2f(fmaxf(l1, 1e-30f));
  }
  __nv_bfloat16 *out = static_cast<__nv_bfloat16 *>(a.o);
#pragma unroll
  for (int j = 0; j < D / 2; j += 2) {
    const bool top = (j / 2) % 2 == 0;
    const int row = r0 + (top ? 0 : 8);
    const int col = 8 * (j / 4) + 2 * pair;
    const float inv = top ? inv0 : inv1;
    if (row < a.sq)
      *reinterpret_cast<__nv_bfloat162 *>(
          out + ((size_t)bh * a.sq + row) * D + col) =
          __floats2bfloat162_rn(o[j] * inv, o[j + 1] * inv);
  }
  __syncthreads();  // no thread still waits on a barrier
  if (tid == 0)
    for (int s = 0; s <= TC_STAGES; ++s) mbar_inval(bars + 8 * s);
}

// -------------------------------------------------------------------------
// Decode split across CTAs (bf16), over either cache: split_decode_item.
// SPLIT_TILE rows per tile, MAX_SPLIT pieces per (slot, kv head) at most,
// SPLIT_G query heads of a kv head at most (one m16 operand): -D defines.
// -------------------------------------------------------------------------

// dynamic shared memory of split_decode_item: two buffers of K and V tiles
// in bf16, q in bf16 with its rows padded to SPLIT_G, the probabilities in
// bf16 (all rows padded by 16 bytes, so the 8 row addresses of an ldmatrix
// fall in distinct banks), then floats: the scores [SPLIT_G][rows], m / l /
// alpha [SPLIT_G]; then ints: each buffer's attended rows and their count,
// and the merge flag. The merge's (n_split, G) weights and l reuse the
// tiles.
__host__ __device__ inline size_t split_smem_bytes(int d) {
  return (size_t)2 * (4 * SPLIT_TILE * (d + 8) + SPLIT_G * (d + 8) +
                      SPLIT_G * (SPLIT_TILE + 8)) +
         sizeof(float) * (SPLIT_G * SPLIT_TILE + 3 * SPLIT_G) +
         sizeof(int) * (2 * SPLIT_TILE + 3);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void *src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most N of this thread's copy groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// four 8x8 bf16 matrices from shared memory, one row address a lane
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// two 8x8 bf16 matrices, transposed; lanes 0-15 give the row addresses
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
// C(16x8) += A(16x16, row) * B(16x8, col), bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where a tile's rows come from: the row-source policies of
// split_decode_item, stateless (they read the launch's arguments where
// they lie, as the item does, so they hold no registers of their own).
// Warp 0 holds what a tile's row list needs (r0 for rows lane, r1 for
// rows lane + 32), read one tile ahead of the copies:
//   rows(a, pos)               the rows the pieces split (S, or the slot's
//                              live rows);
//   pieces(a, pos, ns)         how many of the launch's ns pieces of the
//                              (slot, kv head) take rows;
//   tiles_end(a, pos, t_lo, t_end)  the end of the tiles a piece walks;
//   fetch(a, b, ti, lane, r0, r1)   read what tile ti's list needs;
//   list(a, pos, ti, r0, r1, lane, idx)  write the numbers of tile ti's
//                              attended rows, in order, to idx and return
//                              their count;
//   base(a, b, ti)             what idx counts from: attended row j of
//                              tile ti lives at ((base + idx[j]) K + h) D;
//   k(a), v(a)                 the caches.
// With linear positions both list the same rows in the same order, so
// dense and paged decode agree bit for bit over the gathered rows.
template <typename A> struct RowSource;

// The dense cache: row j of slot b is attended when 0 <= kv_positions[b,
// j] <= pos; a ring's rows are unordered, so the positions decide, never
// the index. Warp 0 holds a tile's positions.
template <> struct RowSource<DenseDecodeArgs> {
  using A = DenseDecodeArgs;
  __device__ static int rows(const A &a, int) { return a.s; }
  __device__ static int pieces(const A &, int, int ns) { return ns; }
  __device__ static int tiles_end(const A &, int pos, int t_lo, int t_end) {
    return pos < 0 ? t_lo : t_end;
  }
  __device__ static void fetch(const A &a, int b, int ti, int lane, int &r0,
                               int &r1) {
    const int *kvp = a.kvpos + (size_t)b * a.s;
    const int j = ti * SPLIT_TILE + lane;
    r0 = j < a.s ? kvp[j] : -1;
    r1 = j + 32 < a.s ? kvp[j + 32] : -1;
  }
  __device__ static int list(const A &, int pos, int, int r0, int r1,
                             int lane, int *idx) {
    const bool ok0 = r0 >= 0 && r0 <= pos, ok1 = r1 >= 0 && r1 <= pos;
    const unsigned m0 = __ballot_sync(0xffffffffu, ok0);
    const unsigned m1 = __ballot_sync(0xffffffffu, ok1);
    const unsigned below = (1u << lane) - 1u;
    if (ok0) idx[__popc(m0 & below)] = lane;
    if (ok1) idx[__popc(m0) + __popc(m1 & below)] = 32 + lane;
    return __popc(m0) + __popc(m1);
  }
  __device__ static size_t base(const A &a, int b, int ti) {
    return (size_t)b * a.s + (size_t)ti * SPLIT_TILE;
  }
  __device__ static const __nv_bfloat16 *k(const A &a) {
    return static_cast<const __nv_bfloat16 *>(a.k);
  }
  __device__ static const __nv_bfloat16 *v(const A &a) {
    return static_cast<const __nv_bfloat16 *>(a.v);
  }
};

// The page pool: positions are linear, so the slot's attended rows are its
// first live = min(pos + 1, n_b ps) (none for pos < 0) and tile ti's are
// its first min(64, live - 64 ti); no position is read. The pieces split
// the slot's own T = ceil(live / 64) tiles, min(T / SPLIT_MIN_TILES, ns)
// of them (at least 1): for any table that holds the slot that is the
// split count at the slot's own rows, so where the pieces fall, and the
// slot's result, do not depend on the table's width (the bucket the other
// slots set). Row r of the slot lives at pool row bt[b, r / ps] ps
// + r % ps, so warp 0 holds each row's page id (the lanes of one page
// read one table entry together); any page size works. Only listed rows
// are copied, so a page past live (the trash page) is never read.
template <> struct RowSource<DecodeArgs> {
  using A = DecodeArgs;
  __device__ static int live(const A &a, int pos) {
    return pos < 0 ? 0 : min(pos + 1, a.n_b * a.ps);
  }
  __device__ static int rows(const A &a, int pos) { return live(a, pos); }
  __device__ static int pieces(const A &a, int pos, int ns) {
    const int t = (live(a, pos) + SPLIT_TILE - 1) / SPLIT_TILE;
    return max(1, min(t / SPLIT_MIN_TILES, ns));
  }
  __device__ static int tiles_end(const A &a, int pos, int t_lo, int t_end) {
    return max(t_lo, min(t_end, (live(a, pos) + SPLIT_TILE - 1) / SPLIT_TILE));
  }
  // the table's entries whatever pos is, so the first read need not wait
  // for it (entries are valid page ids; pages are read only once listed)
  __device__ static void fetch(const A &a, int b, int ti, int lane, int &r0,
                               int &r1) {
    const int *bt = a.bt + (size_t)b * a.n_b;
    const int j = ti * SPLIT_TILE + lane, n = a.n_b * a.ps;
    r0 = j < n ? bt[j / a.ps] : 0;
    r1 = j + 32 < n ? bt[(j + 32) / a.ps] : 0;
  }
  __device__ static int list(const A &a, int pos, int ti, int r0, int r1,
                             int lane, int *idx) {
    const int j = ti * SPLIT_TILE + lane;
    const int n = min(SPLIT_TILE, live(a, pos) - ti * SPLIT_TILE);
    if (lane < n) idx[lane] = r0 * a.ps + j % a.ps;
    if (lane + 32 < n) idx[lane + 32] = r1 * a.ps + (j + 32) % a.ps;
    return n;
  }
  __device__ static size_t base(const A &, int, int) { return 0; }
  __device__ static const __nv_bfloat16 *k(const A &a) {
    return static_cast<const __nv_bfloat16 *>(a.kp);
  }
  __device__ static const __nv_bfloat16 *v(const A &a) {
    return static_cast<const __nv_bfloat16 *>(a.vp);
  }
};

// Item = (slot b, kv head h, piece p) with item = (b*K + h)*n_split + p:
// of the n = pieces(...) <= n_split pieces that take rows, piece p walks
// tiles [p*T/n, (p+1)*T/n) of the slot's T = ceil(rows / 64) row tiles
// (A = DenseDecodeArgs: the dense cache's S rows, n = n_split;
// A = DecodeArgs: the slot's own live rows); a piece p >= n returns at
// once. Per tile warp 0 lists the attended rows (the row source above)
// and only those rows' K and V are read, 16 bytes a thread with
// neighbouring threads on neighbouring addresses, through cp.async into
// two shared buffers: the
// next tile's rows (and what the list of the one after needs) are in
// flight while this tile computes. Both products run on the
// tensor cores with mma.sync m16n8k16 (bf16 operands, fp32 accumulators):
// the G query heads, padded to 16 rows, times the tile's rows for the
// scores (warp w takes rows 8w..8w+7), one warp per query head for the
// online softmax in fp32, the probabilities rounded to bf16 times V for
// the output (warp w takes columns D/8 w .. D/8 (w+1): one 8-column
// mma.sync block at D = 64, pairs of them above), kept in registers across
// the tiles. With n = 1 the item writes its output. Otherwise
// it writes its partial (m, l, acc) to the workspace and counts itself in
// with a fence and an atomic add; the last piece of the (b, h) to arrive
// merges the n partials in piece order 0..n-1 (so the result is the
// same whatever the arrival order), weighting each by exp(m_i - max m) (0
// for a piece with no attended row), writes the output and resets the
// counter. A slot with no attended row returns zeros.
template <int D, typename A>
__device__ void split_decode_item(const A &a, int item, unsigned char *smem) {
  using bf16 = __nv_bfloat16;
  constexpr int R = SPLIT_TILE, GP = SPLIT_G;
  constexpr int RS = D + 8, PS_ = R + 8;   // row strides (elements)
  constexpr int NB = D / 64;               // 8-column blocks of a warp's PV
  static_assert(NB == 1 || NB % 2 == 0, "PV takes 1 or pairs of blocks");
  const bf16 *q = static_cast<const bf16 *>(a.q);
  bf16 *o = static_cast<bf16 *>(a.o);
  const int G = a.g, ns = a.n_split;
  bf16 *kv = reinterpret_cast<bf16 *>(smem);  // [2 buffers][K, V][R][RS]
  bf16 *qs = kv + 4 * R * RS;                 // [GP][RS]
  bf16 *ps = qs + GP * RS;                    // [GP][PS_]
  float *sc = reinterpret_cast<float *>(ps + GP * PS_);  // [GP][R]
  float *ms = sc + GP * R;
  float *ls = ms + GP;
  float *al = ls + GP;
  int *idx = reinterpret_cast<int *>(al + GP);  // [2 buffers][R]
  int *flag = idx + 2 * R;  // [0..1] attended rows per buffer, [2] merges

  const int bkh = item / ns, piece = item % ns;
  const int b = bkh / a.kh, h = bkh % a.kh;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t qo = (size_t)bkh * G * D;

  // pos first (the pieces may depend on it), then together what the first
  // tile's list needs (warp 0 holds it one tile ahead: rows lane, lane +
  // 32) and q (cp.async)
  using Rows = RowSource<A>;
  const int pos = a.pos[b];
  const int np = Rows::pieces(a, pos, ns);
  if (piece >= np) return;  // uniform: a piece without rows of its own
  const int n_t = (Rows::rows(a, pos) + R - 1) / R;
  const int t_lo = (int)((long long)piece * n_t / np);
  const int t_end = (int)((long long)(piece + 1) * n_t / np);
  int r0 = -1, r1 = -1;
  if (warp == 0 && t_lo < t_end) Rows::fetch(a, b, t_lo, lane, r0, r1);
  __syncthreads();  // smem may still be read by the previous item
  for (int e = tid; e < G * (D / 8); e += THREADS) {
    const int g = e / (D / 8), c = (e % (D / 8)) * 8;
    cp_async16(smem_u32(qs + g * RS + c), q + qo + g * D + c);
  }
  cp_async_commit();
  for (int e = tid; e < (GP - G) * D; e += THREADS)
    qs[(G + e / D) * RS + e % D] = __float2bfloat16(0.f);
  for (int e = tid; e < GP * PS_; e += THREADS) ps[e] = __float2bfloat16(0.f);
  for (int e = tid; e < GP; e += THREADS) {
    ms[e] = NEG_INF;
    ls[e] = 0.f;
    al[e] = 1.f;
  }
  const int t_hi = Rows::tiles_end(a, pos, t_lo, t_end);

  // warp 0: list tile ti - 1's attended rows from what it holds (r0, r1)
  // into buffer bf, then read what tile ti's list needs
#define SPLIT_LIST_ROWS(bf, ti)                                              \
  do {                                                                       \
    const int n_ = Rows::list(a, pos, (ti)-1, r0, r1, lane, idx + (bf)*R);   \
    if (lane == 0) flag[bf] = n_;                                            \
    if ((ti) < t_hi) Rows::fetch(a, b, (ti), lane, r0, r1);                  \
  } while (0)
  // all threads: copy the listed rows of tile ti into buffer bf, and zero
  // the V rows up to the next multiple of 16 (the last PV step reads them,
  // times P = 0)
#define SPLIT_COPY_ROWS(ti, bf)                                              \
  do {                                                                       \
    const int n_ok_ = flag[bf];                                              \
    const size_t row0_ = Rows::base(a, b, (ti));                             \
    bf16 *kb_ = kv + 2 * (bf) * R * RS, *vb_ = kb_ + R * RS;                 \
    for (int e = tid; e < n_ok_ * (D / 8); e += THREADS) {                   \
      const int j = e / (D / 8), c = (e % (D / 8)) * 8;                      \
      const size_t gi = ((row0_ + idx[(bf) * R + j]) * a.kh + h) * D + c;    \
      cp_async16(smem_u32(kb_ + j * RS + c), Rows::k(a) + gi);               \
      cp_async16(smem_u32(vb_ + j * RS + c), Rows::v(a) + gi);               \
    }                                                                        \
    cp_async_commit();                                                       \
    const int pad_ = ((n_ok_ + 15) / 16) * 16;                               \
    for (int e = tid; e < (pad_ - n_ok_) * (D / 8); e += THREADS) {          \
      const int j = n_ok_ + e / (D / 8), c = (e % (D / 8)) * 8;              \
      *reinterpret_cast<uint4 *>(vb_ + j * RS + c) = make_uint4(0, 0, 0, 0); \
    }                                                                        \
  } while (0)

  if (warp == 0 && t_lo < t_hi) SPLIT_LIST_ROWS(0, t_lo + 1);
  __syncthreads();
  if (t_lo < t_hi) SPLIT_COPY_ROWS(t_lo, 0);

  float oc[NB][4];  // this warp's output columns, rows g = lane/4 and + 8
#pragma unroll
  for (int n = 0; n < NB; ++n)
    oc[n][0] = oc[n][1] = oc[n][2] = oc[n][3] = 0.f;
  const int g0 = lane / 4, g1 = g0 + 8;

  // tile ti computes from buffer (ti - t_lo) % 2 while tile ti + 1's rows
  // are copied into the other
  for (int ti = t_lo; ti < t_hi; ++ti) {
    const int bf = (ti - t_lo) & 1;
    const bool next = ti + 1 < t_hi;
    if (warp == 0 && next) SPLIT_LIST_ROWS(bf ^ 1, ti + 2);
    __syncthreads();  // the list is written; tile ti - 1 is consumed
    if (next) {
      SPLIT_COPY_ROWS(ti + 1, bf ^ 1);
      cp_async_wait<1>();  // q's and tile ti's copies have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n_ok = flag[bf];
    if (n_ok == 0) {  // uniform across the CTA
      __syncthreads();  // every thread has read flag[bf] before it is reused
      continue;
    }
    const bf16 *ks = kv + 2 * bf * R * RS, *vs = ks + R * RS;

    // scores: warp w, rows 8w .. 8w+7 of the tile, all D columns
    if (8 * warp < n_ok) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t qa[4], qb[4], kf[4];
        ldsm_x4(qa, smem_u32(qs + (lane % 16) * RS + 16 * kk + 8 * (lane / 16)));
        ldsm_x4(qb, smem_u32(qs + (lane % 16) * RS + 16 * kk + 16 +
                             8 * (lane / 16)));
        ldsm_x4(kf, smem_u32(ks + (8 * warp + lane % 8) * RS + 16 * kk +
                             8 * (lane / 8)));
        mma_16816(c, qa, kf[0], kf[1]);
        mma_16816(c, qb, kf[2], kf[3]);
      }
      const int j = 8 * warp + 2 * (lane % 4);
      sc[g0 * R + j] = j < n_ok ? c[0] * a.scale : -INFINITY;
      sc[g0 * R + j + 1] = j + 1 < n_ok ? c[1] * a.scale : -INFINITY;
      sc[g1 * R + j] = j < n_ok ? c[2] * a.scale : -INFINITY;
      sc[g1 * R + j + 1] = j + 1 < n_ok ? c[3] * a.scale : -INFINITY;
    }
    __syncthreads();
    // online softmax: one warp per query head; P in bf16, zero past n_ok
    for (int g = warp; g < G; g += WARPS) {
      float mx = NEG_INF;
      for (int j = lane; j < n_ok; j += 32) mx = fmaxf(mx, sc[g * R + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[g], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < R; j += 32) {
        const float p = j < n_ok ? expf(sc[g * R + j] - m_new) : 0.f;
        ps[g * PS_ + j] = __float2bfloat16(p);
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        al[g] = alpha;
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    // PV: warp w, columns D/8 w .. D/8 (w+1), over the attended rows
    {
      const float a0 = al[g0], a1 = al[g1];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        oc[n][0] *= a0;
        oc[n][1] *= a0;
        oc[n][2] *= a1;
        oc[n][3] *= a1;
      }
      const int d0 = warp * (D / 8);
      for (int k16 = 0; k16 < n_ok; k16 += 16) {
        uint32_t pa[4];
        ldsm_x4(pa, smem_u32(ps + (lane % 16) * PS_ + k16 + 8 * (lane / 16)));
        if constexpr (NB == 1) {
          // D = 64: the warp's one block, rows k16..+7 / k16+8..+15 of V
          // (lanes 0-15 give the addresses)
          uint32_t vf[2];
          ldsm_x2_t(vf, smem_u32(vs + (k16 + lane % 8 + 8 * ((lane / 8) % 2)) *
                                          RS + d0));
          mma_16816(oc[0], pa, vf[0], vf[1]);
        } else {
#pragma unroll
          for (int n = 0; n < NB; n += 2) {
            // matrices: rows k16..+7 / k16+8..+15 of V, columns of blocks
            // n and n+1
            uint32_t vf[4];
            ldsm_x4_t(vf, smem_u32(vs + (k16 + lane % 8 + 8 * ((lane / 8) % 2)) *
                                            RS + d0 + 8 * n + 8 * (lane / 16)));
            mma_16816(oc[n], pa, vf[0], vf[1]);
            mma_16816(oc[n + 1], pa, vf[2], vf[3]);
          }
        }
      }
    }
  }
#undef SPLIT_LIST_ROWS
#undef SPLIT_COPY_ROWS
  cp_async_wait<0>();  // no copy outlives the item (a piece without tiles)
  __syncthreads();

  // this thread's outputs: rows g0 and g1, columns d0 + 8n + 2 (lane % 4)
  const int dc = warp * (D / 8) + 2 * (lane % 4);
  if (np == 1) {
    const float i0 = 1.f / fmaxf(ls[g0], 1e-30f), i1 = 1.f / fmaxf(ls[g1], 1e-30f);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int c = dc + 8 * n;
      if (g0 < G)
        *reinterpret_cast<__nv_bfloat162 *>(o + qo + g0 * D + c) =
            __floats2bfloat162_rn(oc[n][0] * i0, oc[n][1] * i0);
      if (g1 < G)
        *reinterpret_cast<__nv_bfloat162 *>(o + qo + g1 * D + c) =
            __floats2bfloat162_rn(oc[n][2] * i1, oc[n][3] * i1);
    }
    return;
  }
  float *wacc = a.ws_acc + (size_t)item * G * D;
  float *wml = a.ws_ml + (size_t)item * G * 2;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int c = dc + 8 * n;
    if (g0 < G)
      *reinterpret_cast<float2 *>(wacc + g0 * D + c) =
          make_float2(oc[n][0], oc[n][1]);
    if (g1 < G)
      *reinterpret_cast<float2 *>(wacc + g1 * D + c) =
          make_float2(oc[n][2], oc[n][3]);
  }
  for (int g = tid; g < G; g += THREADS) {
    wml[2 * g] = ms[g];
    wml[2 * g + 1] = ls[g];
  }
  __threadfence();  // the partial is visible before the arrival counts
  __syncthreads();
  if (tid == 0) flag[2] = atomicAdd(a.counts + bkh, 1) == np - 1;
  __syncthreads();
  if (!flag[2]) return;  // uniform: another piece merges
  __threadfence();

  // every piece's (m, l) at once, then each query head's weights from
  // shared memory: the loads overlap instead of chaining
  float *wt = reinterpret_cast<float *>(smem);  // (n, G) weights
  float *lt = wt + np * G;                      // (n, G) l
  const float *mlb = a.ws_ml + (size_t)bkh * ns * G * 2;
  for (int e = tid; e < np * G; e += THREADS) {
    const float2 ml = __ldcg(reinterpret_cast<const float2 *>(mlb) + e);
    wt[e] = ml.x;
    lt[e] = ml.y;
  }
  __syncthreads();
  for (int g = tid; g < G; g += THREADS) {
    float mx = NEG_INF;
    for (int i = 0; i < np; ++i) mx = fmaxf(mx, wt[i * G + g]);
    float l = 0.f;
    for (int i = 0; i < np; ++i) {
      const float mi = wt[i * G + g];
      const float w = mi == NEG_INF ? 0.f : expf(mi - mx);
      wt[i * G + g] = w;
      l = fmaf(w, lt[i * G + g], l);
    }
    ls[g] = l;
  }
  __syncthreads();
  // the accumulators: U pieces of loads in flight per thread (8 float4),
  // summed in piece order
  constexpr int U = 8;
  const float *accb = a.ws_acc + (size_t)bkh * ns * G * D;
  for (int e = tid * 4; e < G * D; e += THREADS * 4) {
    const int g = e / D;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i0 = 0; i0 < np; i0 += U) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u < np)
          v[u] = __ldcg(reinterpret_cast<const float4 *>(
              accb + (size_t)(i0 + u) * G * D + e));
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u < np) {
          const float w = wt[(i0 + u) * G + g];
          x.x = fmaf(w, v[u].x, x.x);
          x.y = fmaf(w, v[u].y, x.y);
          x.z = fmaf(w, v[u].z, x.z);
          x.w = fmaf(w, v[u].w, x.w);
        }
      }
    }
    const float l = fmaxf(ls[g], 1e-30f);
    *reinterpret_cast<__nv_bfloat162 *>(o + qo + e) =
        __floats2bfloat162_rn(x.x / l, x.y / l);
    *reinterpret_cast<__nv_bfloat162 *>(o + qo + e + 2) =
        __floats2bfloat162_rn(x.z / l, x.w / l);
  }
  if (tid == 0) a.counts[bkh] = 0;  // ready for the next launch
}

}  // namespace bullet
