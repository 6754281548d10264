// Device bodies shared by the three attention kernels of attention.cu.
//
// Each body computes ONE work item with the whole CTA (THREADS threads):
//   flash_item        one (batch*head, query tile) of causal / windowed
//                     prefill attention, online softmax over KV tiles;
//   paged_decode_item one (slot, kv head) of single-token GQA decode over
//                     the shared page pool, online softmax over pages.
// The standalone kernels run one item per CTA; the fused bullet kernel
// loops its CTAs over items of either kind. Because the fused kernel
// calls these same bodies with the same block size, its outputs equal the
// standalone kernels' bit for bit.
//
// Numerics follow the TPU kernels they replace: q is scaled by D^-0.5 in
// fp32, logits, softmax statistics and accumulators stay fp32, masked
// logits are -1e30, out = acc / max(l, 1e-30). A decode slot with pos < 0
// walks no page and returns zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
  int bh, sq, sk, group, causal, window;
  float scale;
};

// shared floats: Q tile [BQ][D+1], K tile [BK][D+1], V tile [BK][D],
// P tile [BQ][BK+1] (+1 pads keep the column walks free of bank conflicts)
__host__ __device__ constexpr int flash_smem_floats(int d) {
  return BQ * (d + 1) + BK * (d + 1) + BK * d + BQ * (BK + 1);
}

__host__ __device__ inline int flash_q_tiles(int sq) {
  return (sq + BQ - 1) / BQ;
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

  const int n_qt = flash_q_tiles(a.sq);
  const int bh = item / n_qt, qt = item % n_qt;
  const int kvh = bh / a.group;
  const int tid = threadIdx.x;
  const int r = tid / ROW_THREADS, j = tid % ROW_THREADS;
  const int q0 = qt * BQ;
  const int qpos = q0 + r;
  const int q_hi = min(q0 + BQ, a.sq) - 1;   // last real query row

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
    if (a.causal && k0 > q_hi) break;
    if (a.window > 0 && k0 + BK - 1 <= q0 - a.window) continue;

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

  if (qpos < a.sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T *orow = o + ((size_t)bh * a.sq + qpos) * D;
#pragma unroll
    for (int i = 0; i < D / ROW_THREADS; ++i)
      orow[j + ROW_THREADS * i] = from_f<T>(acc[i] * inv);
  }
}

// -------------------------------------------------------------------------
// Decode: one token per slot over the page pool (P+1, ps, K, D).
// -------------------------------------------------------------------------

struct DecodeArgs {
  const void *q;                 // (B, K, G, D)
  const void *kp, *vp;           // (P+1, ps, K, D)
  const int *bt;                 // (B, n_b) physical page per block
  const int *pos;                // (B,) position of the new token, <0 idle
  void *o;                       // (B, K, G, D)
  int b, kh, g, ps, n_b;
  float scale;
};

// shared floats: q [G][D], K page [ps][D], V page [ps][D], scores [G][ps],
// acc [G][D], m / l / alpha [G]
__host__ __device__ inline int decode_smem_floats(int g, int ps, int d) {
  return 2 * g * d + 2 * ps * d + g * ps + 3 * g;
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

}  // namespace bullet
