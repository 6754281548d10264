// Hand-written Hopper (sm_90a) backward of the flash prefill attention
// (kernel 1) in fp32, behind the same plain C interface as attention.cu
// (loaded with ctypes by repro_torch/kernels/build.py). It launches on the
// stream it is given, allocates nothing (the wrapper allocates the outputs
// and the workspaces), and returns cudaGetLastError() after its launches,
// or cudaErrorInvalidValue for what it is not built for.
//
// flash_attention_bwd
//   Replaces no TPU kernel: the JAX package takes attention's gradient
//   through XLA (jax.grad of flash_ref_attention; jax.grad through its
//   Pallas flash kernel fails, ROADMAP §3). It is the gradient of
//   flash_attention_fwd's fp32 body (flash_rt_item): q (BH, Sq, D), k and v
//   (BH/G, Sk, D), the forward's output o and the output's gradient dO (BH,
//   Sq, D), kv head = bh / G, scale D^-0.5, query row i at position i
//   (q_offset 0), key row j at j, key j seen by query i iff j < Sk and
//   (non-causal or j <= i) and (no window or j > i - window). Reads each
//   row's log2-sum-exp2 lse2 (BH, Sq) as the training forward
//   (flash_attention_fwd_lse, the same body with the store added) wrote it,
//   so no pass recomputes it. Writes dq (BH, Sq, D) and dk, dv (BH/G, Sk,
//   D), fp32, at D = 64, 128 and 256. Any Sq and Sk work (ragged tails are
//   masked; Sq != Sk for cross-attention).
//
//   Bound on an H100: operations. The backward does 2.5 times the forward's
//   products (Q K^T again, dO V^T, P^T dO, dS^T Q, dS K against Q K^T and
//   P V): 10 multiply-adds a seen (query, key) pair a head dim, fp32 FMAs on
//   the CUDA cores (no TF32; the fp32 peak is 67 TFLOP/s). This body runs 7
//   products, S = Q K^T and dP = dO V^T once in each pass, against the 5
//   the bound counts.
//
//   Design: FlashAttention-2's split (no atomics, so two runs give the same
//   bits), three launches:
//   1. delta = rowsum(dO * o), a warp a row, o and dO read once;
//   2. one launch of two kinds of CTA, the kind whose longest CTA is the
//      longer first (Plan), each kind's heavy CTAs first:
//      - dK/dV, one CTA per (kv head, kpc key tiles, share): for each key
//        tile, for each (query head, query tile) item of its share, in head
//        order, of the G heads x the query tiles that meet its keys, S^T =
//        K Q^T and dP^T = V dO^T, P^T = exp2(S^T scale log2e - lse2) and
//        dS^T = P^T (dP^T - delta), dV += P^T dO and dK += dS^T Q. The pass
//        lasts as long as its longest CTA, and a causal prompt's first key
//        tiles, or any inside a long window, hold many items; so the
//        wrapper may share each key tile's items out over `split` CTAs
//        (flash_attention.bwd_split): each writes its fp32 partial dK, dV,
//        and 3. a last launch sums the shares in share order. Where key
//        tiles hold few items and are many (cross-attention's short query
//        side), a CTA walks kpc of them, the next one's K and V loading
//        during this one's last item, so fewer CTAs start and end;
//      - dQ, one CTA per (bh, query tile), its causal tiles longest first:
//        for the key tiles its rows see, S, dP, dS as above and dQ += dS K.
//   The 8 warps form two groups of 4. Group A computes S and P (exp2 by the
//   hardware's ex2.approx), then dV (dK/dV) or half of dQ's keys; group B
//   dP and dS, then dK or the other half; P and dS pass between them
//   through shared memory (at D = 64, where a dQ key tile is short, both
//   groups share dS's step).
//   Shared memory feeds the FMAs: an SM serves 128 bytes of it a cycle and
//   issues 128 FFMA, so each float a thread loads must feed 4 FMAs. Every
//   product keeps an 8 x 8 block a thread in registers, as flash_rt_item
//   does: the score products (S, dP) over a share of D (SPL shares, 16-byte
//   chunks interleaved so a warp's loads fall in distinct banks), the
//   shares added by shuffles; the accumulating products (dV, dK, dQ) over a
//   share of the tile's rows, added once at the end through shared memory
//   in share order. That ratio is where the score products stay: a warp's
//   16-byte load costs 4.3 cycles when each quarter-warp reads 4 or more
//   distinct addresses and 2.55 at 2 or fewer (measured on an H100), and
//   an 8 x 8 block needs 8 distinct (row, share) pairs a quarter in one of
//   its operands, so shared memory and the FMA pipes are near equally busy
//   there (about half the FMA rate), while the accumulating products, whose
//   P operand is nearly uniform across a warp, reach about 80%.
//   Tiles are T rows (the build's -D defines from geometry.py: RT_BWD_TILE
//   at D = 64 and 128, RT_BWD_TILE_WIDE at D = 256, where one 64-row tile
//   is 64 KB; Geo's asserts take 64 or 32), held [row][D] with each row's
//   16-byte chunks xor-swizzled by (row & 7), P and dS [row][T] swizzled
//   the same way. They arrive by 16-byte cp.async (rows past the end
//   zero-filled) into two buffers, the next tile's while this one computes
//   (Q, dO, lse2 and delta in the dK/dV items, K and V in the dQ items):
//   225 KB of shared memory at D = 128, 201 KB at D = 256, 254-255
//   registers, one CTA an SM, no spill. A tile pair that the mask clears is
//   skipped whole (uniform per CTA); only a pair crossing the diagonal, the
//   window's edge or the end of the queries or keys is masked element-wise.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <cstdint>

#include "attention.cuh"

using bullet::cp_async16_zfill;
using bullet::cp_async_commit;
using bullet::cp_async_wait;
using bullet::smem_u32;

#if !defined(RT_BWD_TILE) || !defined(RT_BWD_TILE_WIDE)
#error "RT_BWD_TILE, RT_BWD_TILE_WIDE come from the build (geometry.py)"
#endif

namespace {

constexpr int THREADS = 256;  // two groups of 4 warps
constexpr int GROUP = 128;
constexpr float LOG2E = 1.4426950408889634f;

// The geometry at head dim D: T rows (queries or keys) a tile; the score
// products' SPL shares of D (each lane an 8 x 8 block over one, SPL lanes
// added, KEEP of its 8 rows kept); the dK/dV items' KVSH shares of a query
// tile and the dQ items' QSH shares of a key tile (each thread an 8 x 8
// block of the accumulator over one)
template <int D> struct Geo {
  static constexpr int T = D == 256 ? RT_BWD_TILE_WIDE : RT_BWD_TILE;
  static constexpr int NB = T / 8;                   // 8-row blocks a tile
  static constexpr int SPL = 64 * GROUP / (T * T);
  static constexpr int KEEP = 8 / SPL;
  static constexpr int MS = D / 4 / SPL;             // chunks a share
  static constexpr int AW = NB / KEEP;               // warps along A rows
  static constexpr int KVSH = 64 * GROUP / (T * D);
  static constexpr int QSH = 64 * THREADS / (T * D);
  // the dQ items' dS = P (dP - delta) over both groups (group B hands
  // dP - delta over with P), not group B alone: at D = 64 a key tile's
  // products are short, so a serial step there weighs
  static constexpr bool DS_BOTH = D == 64;
  // key tiles a dK/dV CTA walks at most: at T = 32 (D = 256, long windows)
  // a key tile holds many items, and the walk compiles out
  static constexpr int MAX_KPC = T == 64 ? 8 : 1;
  static_assert(SPL * T * T == 64 * GROUP && KEEP * SPL == 8 &&
                    AW * (NB / 4) == GROUP / 32 && NB % 4 == 0,
                "score blocks: 8 x 8 a lane, 4 warps a group");
  static_assert(KVSH * T * D == 64 * GROUP && QSH * T * D == 64 * THREADS &&
                    (D / 8) * NB * KVSH == GROUP && D % 64 == 0,
                "accumulator blocks: 8 x 8 a thread");
};

struct BwdArgs {
  const float *q, *k, *v, *o, *dout;
  const float *lse2;  // (bh, sq): log2 sum_j exp2(S_ij scale log2e)
  float *dq, *dk, *dv;
  float *delta;  // (bh, sq): rowsum(dO * o)
  float *part;   // (2, split, bh / G, sk, D): partial dK, dV (split > 1)
  int bh, sq, sk, group, causal, window, split;
  float scale;
};

__host__ __device__ __forceinline__ int cdiv(int x, int y) {
  return (x + y - 1) / y;
}

// query row i sees key j (q_offset 0)
__device__ __forceinline__ bool seen(const BwdArgs &a, int i, int j) {
  if (i >= a.sq || j >= a.sk) return false;
  if (a.causal && j > i) return false;
  if (a.window > 0 && j <= i - a.window) return false;
  return true;
}

// whether the T x T tile pair at (q0, k0) holds a pair the mask clears
template <int T>
__device__ __forceinline__ bool tile_edge(const BwdArgs &a, int q0, int k0) {
  return (a.causal && k0 + T - 1 > q0) || k0 + T > a.sk || q0 + T > a.sq ||
         (a.window > 0 && k0 <= q0 + T - 1 - a.window);
}

// 4 bytes global -> shared, zero when !in
__device__ __forceinline__ void cp_async4_zfill(void *dst, const void *src,
                                                bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// the barrier of group B's 128 threads (warps 4-7)
__device__ __forceinline__ void group_b_sync() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

// 2^x by the hardware's approximation (ex2.approx: relative error below
// 2^-22; results under 2^-126 flush to zero), one instruction where exp2f
// adds a range fix-up
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float *p) {
  return *reinterpret_cast<const float4 *>(p);
}

// where element (r, c) of a [rows][T] tile (P, dS) lies: 16-byte chunks
// xor-swizzled by (r & 7)
template <int T> __device__ __forceinline__ int pidx(int r, int c) {
  return r * T + 4 * ((c >> 2) ^ (r & 7)) + (c & 3);
}

// rows [r0, r0 + T) of an (n, D) matrix into a [T][D] tile, chunk c of row
// r at chunk c ^ (r & 7), zeros past row n (the caller commits)
template <int D, int T>
__device__ __forceinline__ void load_tile(float *dst, const float *src, int r0,
                                          int n) {
  constexpr int C4 = D / 4;
  for (int e = threadIdx.x; e < T * C4; e += THREADS) {
    const int r = e / C4, c = e % C4, row = r0 + r;
    const bool in = row < n;
    cp_async16_zfill(smem_u32(dst + r * D + 4 * (c ^ (r & 7))),
                     src + (in ? (size_t)row * D + 4 * c : 0), in);
  }
}

// one step of the shares' sum: slots [0, K) add the partner's (lane xor
// BIT) slots [K, 2K), then the next step, down to BIT 1
template <int K, int BIT>
__device__ __forceinline__ void fold_shares(float (&s)[8][8]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      s[i][j] = __fadd_rn(s[i][j],
                          __shfl_xor_sync(0xffffffffu, s[K + i][j], BIT));
  if constexpr (BIT > 1) fold_shares<K / 2, BIT / 2>(s);
}

// One score block: s[r][j] = A row (ab + NB (r ^ KEEP h)) . B row (bb + NB
// j) over this lane's share h of D (chunks KEEP h + m % KEEP + 8 (m / KEEP),
// so the 8 (row, share) pairs of a warp's load fall in 8 distinct banks),
// then the SPL shares added by shuffles: each step keeps the lower half of
// the slots and hands the partner (lane xor bit) the upper half, so lane h
// ends with s[i][j], i < KEEP, = A row ab + NB (KEEP h + i) x B row bb + NB
// j, summed in a fixed order. A and B are swizzled [T][D] tiles. At NB = 8
// a slot's chunk lies at c ^ (ab & 7) whatever its row, and slot r's row
// is ab + NB r + NB KEEP h (r < KEEP) or ab + NB r - NB KEEP h (r >= KEEP),
// so every slot lies at a fixed offset from one of two pointers.
template <int D>
__device__ __forceinline__ void score_block(float (&s)[8][8], const float *A,
                                            const float *B, int ab, int bb,
                                            int h) {
  using G = Geo<D>;
  constexpr int NB = G::NB, KEEP = G::KEEP;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[r][j] = 0.f;
  const float *a_lo = A + (ab + NB * KEEP * h) * D;
  const float *a_hi = A + (ab - NB * KEEP * h) * D;
#pragma unroll 1
  for (int m = 0; m < G::MS; ++m) {
    const int c = KEEP * h + m % KEEP + 8 * (m / KEEP);
    float4 af[8];
    if constexpr (G::SPL == 2) {
      static_assert(NB % 8 == 0, "one swizzle for every slot");
      const int ca = 4 * (c ^ (ab & 7));
#pragma unroll
      for (int r = 0; r < 8; ++r)
        af[r] = ld4((r < KEEP ? a_lo : a_hi) + NB * D * r + ca);
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = ab + NB * (r ^ (KEEP * h));
        af[r] = ld4(A + row * D + 4 * (c ^ (row & 7)));
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // B row bb + NB j: swizzled by bb & 7, or at NB = 4 by (bb + 4 j) & 7
      const int row = bb + NB * j;
      const float4 bf = ld4(B + row * D + 4 * (c ^ (row & 7)));
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        s[r][j] = __fmaf_rn(af[r].x, bf.x, s[r][j]);
        s[r][j] = __fmaf_rn(af[r].y, bf.y, s[r][j]);
        s[r][j] = __fmaf_rn(af[r].z, bf.z, s[r][j]);
        s[r][j] = __fmaf_rn(af[r].w, bf.w, s[r][j]);
      }
    }
  }
  fold_shares<4, G::SPL / 2>(s);
}

// One accumulator block: acc[r][c] += sum over t in [t0, t1) of P(t, r0 + r)
// B(t, col c), P a [T][T] tile (pidx), B a swizzled [T][D] tile, columns
// 4 cb .. 4 cb + 3 and D/2 + 4 cb .. D/2 + 4 cb + 3, t in order
template <int D>
__device__ __forceinline__ void acc_block(float (&acc)[8][8], const float *P,
                                          const float *B, int r0, int cb,
                                          int t0, int t1) {
  constexpr int T = Geo<D>::T;
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    const int sw = t & 7;
    const float4 pa = ld4(P + t * T + 4 * ((r0 >> 2) ^ sw));
    const float4 pb = ld4(P + t * T + 4 * (((r0 >> 2) + 1) ^ sw));
    const float4 va = ld4(B + t * D + 4 * (cb ^ sw));
    const float4 vb = ld4(B + t * D + 4 * ((cb + D / 8) ^ sw));
    const float p[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
    const float v[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = __fmaf_rn(p[r], v[c], acc[r][c]);
  }
}

// the shares' blocks summed in share order through the scratch (nsh - 1
// share-sized [rows][D] regions): share sh > 0 writes its block, share 0
// adds them; returns whether this thread holds the sum
template <int D>
__device__ __forceinline__ bool sum_shares(float (&acc)[8][8], float *scratch,
                                           int nsh, int sh, int r0, int cb,
                                           int rows) {
  if (nsh == 1) return true;
  __syncthreads();  // every thread is done with the tiles the scratch reuses
  if (sh > 0) {
    float *out = scratch + (size_t)(sh - 1) * rows * D;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float *row = out + (r0 + r) * D;
      *reinterpret_cast<float4 *>(row + 4 * cb) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      *reinterpret_cast<float4 *>(row + D / 2 + 4 * cb) =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  }
  __syncthreads();
  if (sh > 0) return false;
  for (int s = 1; s < nsh; ++s) {
    const float *in = scratch + (size_t)(s - 1) * rows * D;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float4 x = ld4(in + (r0 + r) * D + 4 * cb);
      const float4 y = ld4(in + (r0 + r) * D + D / 2 + 4 * cb);
      const float v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = __fadd_rn(acc[r][c], v[c]);
    }
  }
  return true;
}

// rows r0 .. r0 + 7 (those below n) of acc times mul into dst (n, D)
__device__ __forceinline__ void store_block(float *dst, const float (&acc)[8][8],
                                            int r0, int n, int cb, int d,
                                            float mul) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (r0 + r >= n) continue;
    float *row = dst + (size_t)(r0 + r) * d;
    *reinterpret_cast<float4 *>(row + 4 * cb) =
        make_float4(acc[r][0] * mul, acc[r][1] * mul, acc[r][2] * mul,
                    acc[r][3] * mul);
    *reinterpret_cast<float4 *>(row + d / 2 + 4 * cb) =
        make_float4(acc[r][4] * mul, acc[r][5] * mul, acc[r][6] * mul,
                    acc[r][7] * mul);
  }
}

template <int D> constexpr size_t dkdv_smem() {
  constexpr int T = Geo<D>::T;
  return sizeof(float) * (6 * T * D + 2 * T * T + 4 * T);
}
template <int D> constexpr size_t dq_smem() {
  constexpr int T = Geo<D>::T;
  return sizeof(float) * (6 * T * D + 2 * T * T);
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * o), a warp a row
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) flash_bwd_rt_delta(const BwdArgs a,
                                                              int d) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= a.bh * a.sq) return;
  const float *o = a.o + (size_t)row * d, *g = a.dout + (size_t)row * d;
  float s = 0.f;
  for (int c = 4 * lane; c < d; c += 128) {
    const float4 x = ld4(o + c), y = ld4(g + c);
    s = __fmaf_rn(x.x, y.x, s);
    s = __fmaf_rn(x.y, y.y, s);
    s = __fmaf_rn(x.z, y.z, s);
    s = __fmaf_rn(x.w, y.w, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  if (lane == 0) a.delta[row] = s;
}

// ---------------------------------------------------------------------------
// 2a. dK and dV of kpc key tiles of one kv head, one share of each
// ---------------------------------------------------------------------------

// the items of key tile kt in share sp: the query tiles that meet its keys
// are contiguous, [qt0, qt0 + nq), and share sp takes items [lo, hi) of the
// G x nq (head, query tile) items, in head order
struct KeyTile {
  int kt, qt0, nq, lo, hi;
};
template <int T>
__host__ __device__ __forceinline__ KeyTile key_tile(const BwdArgs &a, int kt,
                                                     int sp) {
  const int n_qt = cdiv(a.sq, T);
  const int k1 = (kt * T + T < a.sk ? kt * T + T : a.sk) - 1;
  const int lo = a.causal ? (a.sq > kt * T ? kt : n_qt) : 0;
  int hi = n_qt - 1;
  if (a.window > 0 && (k1 + a.window - 1) / T < hi)
    hi = (k1 + a.window - 1) / T;
  const int nq = hi >= lo ? hi - lo + 1 : 0;
  return KeyTile{kt, lo, nq, sp * a.group * nq / a.split,
                 (sp + 1) * a.group * nq / a.split};
}

// the key tiles [lo, hi) some row of query tile qt sees
template <int T>
__host__ __device__ __forceinline__ void key_range(const BwdArgs &a, int qt,
                                                   int &lo, int &hi) {
  const int q0 = qt * T, q_hi = (q0 + T < a.sq ? q0 + T : a.sq) - 1;
  const int n_kt = cdiv(a.sk, T);
  lo = a.window > 0 && q0 - a.window + 1 > 0 ? (q0 - a.window + 1) / T : 0;
  hi = a.causal && q_hi / T + 1 < n_kt ? q_hi / T + 1 : n_kt;
}

// CTA idx = (key tiles [kg kpc, kg kpc + kpc), kv head, share), heavy key
// tiles first. Each key tile's items run in turn; the Q, dO, lse2 and delta
// tiles of the next item, in this key tile or the next, load into the
// other buffer while one computes, and the next key tile's K and V once the
// last item of this one is past its score products
template <int D>
__device__ __forceinline__ void dkdv_item(const BwdArgs &a, int idx, int kpc,
                                          float *smem) {
  using G = Geo<D>;
  constexpr int T = G::T, NB = G::NB;
  float *Ks = smem;               // [T][D], swizzled
  float *Vs = Ks + T * D;         // [T][D]
  float *Qb = Vs + T * D;         // [2][T][D]
  float *dOb = Qb + 2 * T * D;    // [2][T][D]
  float *Ps = dOb + 2 * T * D;    // [T query][T key] (pidx)
  float *dSs = Ps + T * T;        // [T query][T key] (pidx)
  float *Lb = dSs + T * T;        // [2][T] lse2 of the query tile
  float *Db = Lb + 2 * T;         // [2][T] delta of the query tile
  const int n_kvh = a.bh / a.group;
  const int sp = idx % a.split;
  idx /= a.split;
  const int kvh = idx % n_kvh, kg = idx / n_kvh;
  kpc = G::MAX_KPC == 1 ? 1 : kpc;
  const int kt_end = min(cdiv(a.sk, T), (kg + 1) * kpc);
  const int tid = threadIdx.x, grp = tid / GROUP, t = tid % GROUP;
  const int lane = tid % 32, w = t / 32;
  // score lanes: share h of D, A rows (keys) block ab, B rows (queries) bb
  const int h = lane % G::SPL;
  const int ab = (lane / G::SPL) % G::KEEP + G::KEEP * (w % G::AW);
  const int bb = lane / G::SPL / G::KEEP + 4 * (w / G::AW);
  // accumulator threads: keys 8 rb .., columns block cb, query share sh
  const int cb = t % (D / 8), rb = t / (D / 8) % NB, sh = t / (D / 8) / NB;
  const size_t kvo = (size_t)kvh * a.sk * D;

  auto load_kv = [&](int kt) {
    load_tile<D, T>(Ks, a.k + kvo, kt * T, a.sk);
    load_tile<D, T>(Vs, a.v + kvo, kt * T, a.sk);
  };
  auto load_item = [&](const KeyTile &w, int it, int buf) {
    const size_t base = (size_t)(kvh * a.group + it / w.nq) * a.sq;
    const int q0 = (w.qt0 + it % w.nq) * T;
    load_tile<D, T>(Qb + buf * T * D, a.q + base * D, q0, a.sq);
    load_tile<D, T>(dOb + buf * T * D, a.dout + base * D, q0, a.sq);
    for (int e = tid; e < T; e += THREADS) {
      const bool in = q0 + e < a.sq;
      const size_t r = base + (in ? q0 + e : 0);
      cp_async4_zfill(Lb + buf * T + e, a.lse2 + r, in);
      cp_async4_zfill(Db + buf * T + e, a.delta + r, in);
    }
  };
  {
    const KeyTile w = key_tile<T>(a, kg * kpc, sp);
    load_kv(w.kt);
    if (w.lo < w.hi) load_item(w, w.lo, 0);
    cp_async_commit();
  }
  const float sl2 = a.scale * LOG2E;
  int buf = 0;

#pragma unroll 1
  for (int kt = kg * kpc; kt < kt_end; ++kt) {
    const int k0 = kt * T;
    const bool more = G::MAX_KPC > 1 && kt + 1 < kt_end;
    const KeyTile cur = key_tile<T>(a, kt, sp);
    float acc[8][8];  // group A dV, group B dK (unscaled)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    for (int it = cur.lo; it < cur.hi; ++it, buf ^= 1) {
      cp_async_wait<0>();  // this item's tiles have landed
      __syncthreads();     // ... for all; the previous item is consumed
      if (it + 1 < cur.hi) {
        load_item(cur, it + 1, buf ^ 1);
      } else if (more) {
        const KeyTile w = key_tile<T>(a, kt + 1, sp);
        if (w.lo < w.hi) load_item(w, w.lo, buf ^ 1);
      }
      cp_async_commit();
      const int q0 = (cur.qt0 + it % cur.nq) * T;
      const float *Qs = Qb + buf * T * D, *dOs = dOb + buf * T * D;
      const float *Ls = Lb + buf * T, *Ds = Db + buf * T;
      const bool edge = tile_edge<T>(a, q0, k0);
      // group A: S^T = K Q^T into P^T; group B: dP^T = V dO^T
      float s[8][8];
      score_block<D>(s, grp ? Vs : Ks, grp ? dOs : Qs, ab, bb, h);
      if (grp == 0) {
#pragma unroll
        for (int i = 0; i < G::KEEP; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int kl = ab + NB * (G::KEEP * h + i), ql = bb + NB * j;
            const float p = !edge || seen(a, q0 + ql, k0 + kl)
                                ? exp2_approx(__fmaf_rn(s[i][j], sl2, -Ls[ql]))
                                : 0.f;
            Ps[pidx<T>(ql, kl)] = p;
          }
      }
      __syncthreads();  // P is in place; K and V are read
      if (it + 1 == cur.hi && more) {
        load_kv(kt + 1);
        cp_async_commit();
      }
      if (grp == 1) {
#pragma unroll
        for (int i = 0; i < G::KEEP; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int kl = ab + NB * (G::KEEP * h + i), ql = bb + NB * j;
            const int e = pidx<T>(ql, kl);
            dSs[e] = __fmul_rn(Ps[e], __fsub_rn(s[i][j], Ds[ql]));
          }
        group_b_sync();  // dS is in place for group B
      }
      // group A: dV += P^T dO; group B: dK += dS^T Q
      acc_block<D>(acc, grp ? dSs : Ps, grp ? Qs : dOs, 8 * rb, cb,
                   sh * T / G::KVSH, (sh + 1) * T / G::KVSH);
    }
    if (cur.lo == cur.hi && more) {
      // no item here, so nothing loaded the next key tile's tiles yet
      cp_async_wait<0>();
      __syncthreads();
      const KeyTile w = key_tile<T>(a, kt + 1, sp);
      load_kv(w.kt);
      if (w.lo < w.hi) load_item(w, w.lo, buf);
      cp_async_commit();
    }
    // the query shares added (group A in the P tile, group B in the dS
    // tile), dK scaled; a key tile with no item writes zeros
    if (sum_shares<D>(acc, grp ? dSs : Ps, G::KVSH, sh, 8 * rb, cb, T)) {
      const float mul = grp ? a.scale : 1.f;
      const size_t n = (size_t)n_kvh * a.sk * D;  // one partial
      float *out = a.split == 1
                       ? (grp ? a.dk : a.dv) + kvo
                       : a.part + (grp ? 0 : (size_t)a.split * n) + sp * n +
                             kvo;
      store_block(out, acc, k0 + 8 * rb, a.sk, cb, D, mul);
    }
  }
  cp_async_wait<0>();  // no copy in flight at exit
}

// ---------------------------------------------------------------------------
// 2b. dQ of one (bh, query tile)
// ---------------------------------------------------------------------------

template <int D>
__device__ __forceinline__ void dq_item(const BwdArgs &a, int idx,
                                        float *smem) {
  using G = Geo<D>;
  constexpr int T = G::T, NB = G::NB;
  float *Qs = smem;               // [T][D], swizzled
  float *dOs = Qs + T * D;        // [T][D]
  float *Kb = dOs + T * D;        // [2][T][D]
  float *Vb = Kb + 2 * T * D;     // [2][T][D]
  float *Ps = Vb + 2 * T * D;     // [T query][T key] (pidx)
  float *dSt = Ps + T * T;        // [T key][T query] (pidx)
  const int n_qt = cdiv(a.sq, T);
  const int bh = idx % a.bh, r = idx / a.bh;
  const int qt = a.causal ? n_qt - 1 - r : r;  // longest causal tiles first
  const int kvh = bh / a.group;
  const int q0 = qt * T;
  int kt_lo, kt_hi;  // the key tiles this tile's rows see (uniform per CTA)
  key_range<T>(a, qt, kt_lo, kt_hi);
  const int tid = threadIdx.x, grp = tid / GROUP, t = tid % GROUP;
  const int lane = tid % 32, w = t / 32;
  const int h = lane % G::SPL;
  const int ab = (lane / G::SPL) % G::KEEP + G::KEEP * (w % G::AW);
  const int bb = lane / G::SPL / G::KEEP + 4 * (w / G::AW);
  // accumulator threads over all 8 warps: queries 8 rb .., columns block
  // cb, key share sh
  const int cb = tid % (D / 8), rb = tid / (D / 8) % NB;
  const int sh = tid / (D / 8) / NB;
  const size_t base = (size_t)bh * a.sq, kvo = (size_t)kvh * a.sk * D;

  load_tile<D, T>(Qs, a.q + base * D, q0, a.sq);
  load_tile<D, T>(dOs, a.dout + base * D, q0, a.sq);
  if (kt_lo < kt_hi) {
    load_tile<D, T>(Kb, a.k + kvo, kt_lo * T, a.sk);
    load_tile<D, T>(Vb, a.v + kvo, kt_lo * T, a.sk);
  }
  cp_async_commit();
  // this lane's query rows in the score blocks: group A reads their lse2,
  // group B their delta
  float rowv[G::KEEP];
#pragma unroll
  for (int i = 0; i < G::KEEP; ++i) {
    const int qi = q0 + ab + NB * (G::KEEP * h + i);
    rowv[i] = qi < a.sq ? (grp ? a.delta : a.lse2)[base + qi] : 0.f;
  }
  const float sl2 = a.scale * LOG2E;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1, k0 = kt * T;
    cp_async_wait<0>();  // K(kt), V(kt) have landed
    __syncthreads();     // ... for all; tile kt - 1 is consumed
    if (kt + 1 < kt_hi) {
      load_tile<D, T>(Kb + (buf ^ 1) * T * D, a.k + kvo, k0 + T, a.sk);
      load_tile<D, T>(Vb + (buf ^ 1) * T * D, a.v + kvo, k0 + T, a.sk);
    }
    cp_async_commit();
    const float *Ks = Kb + buf * T * D, *Vs = Vb + buf * T * D;
    const bool edge = tile_edge<T>(a, q0, k0);
    // group A: S = Q K^T into P; group B: dP = dO V^T
    float s[8][8];
    score_block<D>(s, grp ? dOs : Qs, grp ? Vs : Ks, ab, bb, h);
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < G::KEEP; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ql = ab + NB * (G::KEEP * h + i), kl = bb + NB * j;
          const float p = !edge || seen(a, q0 + ql, k0 + kl)
                              ? exp2_approx(__fmaf_rn(s[i][j], sl2, -rowv[i]))
                              : 0.f;
          Ps[pidx<T>(ql, kl)] = p;
        }
    }
    if constexpr (G::DS_BOTH) {
      if (grp == 1) {
#pragma unroll
        for (int i = 0; i < G::KEEP; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int ql = ab + NB * (G::KEEP * h + i), kl = bb + NB * j;
            dSt[pidx<T>(kl, ql)] = __fsub_rn(s[i][j], rowv[i]);
          }
      }
      __syncthreads();  // P and dP - delta are in place
      // group g: the lane's columns 4 g .. 4 g + 3
#pragma unroll
      for (int i = 0; i < G::KEEP; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ql = ab + NB * (G::KEEP * h + i);
          const int kl = bb + NB * (4 * grp + j), e = pidx<T>(kl, ql);
          dSt[e] = __fmul_rn(Ps[pidx<T>(ql, kl)], dSt[e]);
        }
    } else {
      __syncthreads();  // P is in place
      if (grp == 1) {
#pragma unroll
        for (int i = 0; i < G::KEEP; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int ql = ab + NB * (G::KEEP * h + i), kl = bb + NB * j;
            dSt[pidx<T>(kl, ql)] = __fmul_rn(Ps[pidx<T>(ql, kl)],
                                             __fsub_rn(s[i][j], rowv[i]));
          }
      }
    }
    __syncthreads();  // dS is in place
    // dQ += dS K over this thread's share of the keys
    acc_block<D>(acc, dSt, Ks, 8 * rb, cb, sh * T / G::QSH,
                 (sh + 1) * T / G::QSH);
  }
  cp_async_wait<0>();

  // the key shares added in the K/V tiles, then dQ = scale * (dS K)
  if (!sum_shares<D>(acc, Kb, G::QSH, sh, 8 * rb, cb, T)) return;
  store_block(a.dq + base * D, acc, q0 + 8 * rb, a.sq, cb, D, a.scale);
}

// the n_dkdv dK/dV CTAs (kpc key tiles each) and the dQ CTAs, the kind
// whose longest CTA is the longer first (dq_first), so the card starts it
// first; one CTA an SM (each 8 x 8 block of a score and an accumulator
// product takes more than 128 registers a thread, and the tiles up to 225
// KB of shared memory)
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_rt_kernel(const BwdArgs a, int n_dkdv, int kpc, int dq_first) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float *smem = reinterpret_cast<float *>(smem_raw);
  const int n_dq = a.bh * cdiv(a.sq, Geo<D>::T);
  const int b = blockIdx.x;
  if (dq_first ? b >= n_dq : b < n_dkdv)
    dkdv_item<D>(a, dq_first ? b - n_dq : b, kpc, smem);
  else
    dq_item<D>(a, dq_first ? b : b - n_dkdv, smem);
}

// ---------------------------------------------------------------------------
// 3. the split heads' partial dK and dV summed in share order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) flash_bwd_rt_sum(const BwdArgs a,
                                                            int d) {
  const size_t n = (size_t)(a.bh / a.group) * a.sk * d;
  const size_t e = ((size_t)blockIdx.x * THREADS + threadIdx.x) * 4;
  if (e >= n) return;
  const size_t pn = (size_t)a.split * n;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int s = 0; s < a.split; ++s) {
    const float4 x = ld4(a.part + s * n + e);
    const float4 y = ld4(a.part + pn + s * n + e);
    sk = make_float4(__fadd_rn(sk.x, x.x), __fadd_rn(sk.y, x.y),
                     __fadd_rn(sk.z, x.z), __fadd_rn(sk.w, x.w));
    sv = make_float4(__fadd_rn(sv.x, y.x), __fadd_rn(sv.y, y.y),
                     __fadd_rn(sv.z, y.z), __fadd_rn(sv.w, y.w));
  }
  *reinterpret_cast<float4 *>(a.dk + e) = sk;
  *reinterpret_cast<float4 *>(a.dv + e) = sv;
}

template <typename K, typename... Args>
cudaError_t launch_one(K kern, int grid, size_t smem, cudaStream_t s,
                       Args... args) {
  if (smem > 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, THREADS, smem, s>>>(args...);
  return cudaGetLastError();
}

// The shape of the main launch: the most items a key tile's share holds
// (G x the query tiles meeting its keys, over split) and the most key tiles
// a query tile sees, from the tile ranges the items walk; then key tiles a
// dK/dV CTA (kpc: where the key tiles' shares are many, over 4 a CTA slot,
// and short, as many as make up to 16 items, at most max_kpc, so fewer CTAs
// start and end and the next key tile's loads overlap this one's work) and
// which kind goes first (its longest CTA the longer: dK/dV 4 products an
// item, dQ 3 a key tile)
struct Plan {
  int kpc, dq_first;
};
template <int T> Plan plan(const BwdArgs &a, int slots, int max_kpc) {
  const int n_qt = cdiv(a.sq, T), n_kt = cdiv(a.sk, T);
  int items = 1, most_k = 0;
  for (int kt = 0; kt < n_kt; ++kt)
    items = std::max(items, cdiv(a.group * key_tile<T>(a, kt, 0).nq, a.split));
  for (int qt = 0; qt < n_qt; ++qt) {
    int lo, hi;
    key_range<T>(a, qt, lo, hi);
    most_k = std::max(most_k, hi - lo);
  }
  const int shares = a.bh / a.group * n_kt * a.split;
  const int kpc = shares > 4 * slots
                      ? std::max(1, std::min(max_kpc, 16 / items))
                      : 1;
  return Plan{kpc, 3 * most_k > 4 * kpc * items};
}

template <int D>
int launch_rt(const BwdArgs &a, cudaStream_t s) {
  constexpr int T = Geo<D>::T;
  const int n_qt = cdiv(a.sq, T), n_kt = cdiv(a.sk, T);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = launch_one(flash_bwd_rt_delta, cdiv(a.bh * a.sq, THREADS / 32), 0, s,
                 a, D);
  if (e != cudaSuccess) return (int)e;
  const Plan p = plan<T>(a, sms, Geo<D>::MAX_KPC);
  const int n_dkdv = a.bh / a.group * cdiv(n_kt, p.kpc) * a.split;
  const size_t smem = dkdv_smem<D>() > dq_smem<D>() ? dkdv_smem<D>()
                                                    : dq_smem<D>();
  e = launch_one(flash_bwd_rt_kernel<D>, n_dkdv + a.bh * n_qt, smem, s, a,
                 n_dkdv, p.kpc, p.dq_first);
  if (e != cudaSuccess) return (int)e;
  if (a.split > 1) {
    const size_t quads = (size_t)(a.bh / a.group) * a.sk * D / 4;
    e = launch_one(flash_bwd_rt_sum, (int)((quads + THREADS - 1) / THREADS),
                   0, s, a, D);
  }
  return (int)e;
}

}  // namespace

extern "C" {

// fp32 at D = 64, 128 or 256, q_offset 0. lse2 (bh, sq) fp32 as
// flash_attention_fwd_lse wrote it. Workspaces the wrapper allocates: delta
// (bh, sq) fp32; with split > 1 (a key tile's (head, query tile) items
// over split CTAs), part (2, split, bh / G, sk, D) fp32
int flash_attention_bwd(const void *q, const void *k, const void *v,
                        const void *o, const void *dout, void *dq, void *dk,
                        void *dv, const float *lse2, float *delta,
                        float *part, int bh, int sq, int sk, int d, int group,
                        int causal, int window, int split, void *stream) {
  if (bh < 1 || sq < 1 || sk < 1 || group < 1 || bh % group != 0 ||
      split < 1 || (split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  BwdArgs a{static_cast<const float *>(q),    static_cast<const float *>(k),
            static_cast<const float *>(v),    static_cast<const float *>(o),
            static_cast<const float *>(dout), lse2,
            static_cast<float *>(dq),         static_cast<float *>(dk),
            static_cast<float *>(dv),         delta,
            part,                             bh,
            sq,                               sk,
            group,                            causal,
            window,                           split,
            1.0f / sqrtf((float)d)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_rt<64>(a, s);
  if (d == 128) return launch_rt<128>(a, s);
  if (d == 256) return launch_rt<256>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
