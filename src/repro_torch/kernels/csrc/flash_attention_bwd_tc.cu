// Hand-written Hopper (sm_90a) backward of the flash prefill attention
// (kernel 1) in bf16, on the tensor cores, behind the same plain C interface
// as attention.cu (loaded with ctypes by repro_torch/kernels/build.py). It
// launches on the stream it is given, allocates nothing (the wrapper
// allocates the outputs and the workspaces), and returns cudaGetLastError()
// after its launches, or cudaErrorInvalidValue for what it is not built for.
//
// flash_attention_bwd_tc
//   Replaces no TPU kernel: the JAX package takes attention's gradient
//   through XLA. It is the gradient of flash_attention_fwd's bf16 body
//   (flash_tc_item), as flash_attention_bwd.cu is of its fp32 body: q, the
//   forward's output o and the output's gradient dO (BH, Sq, D), k and v
//   (BH/G, Sk, D), all bf16, kv head = bh / G, scale D^-0.5 applied to the
//   fp32 logits, query row i at position i (q_offset 0), key j seen by query
//   i iff j < Sk and (non-causal or j <= i) and (no window or j > i -
//   window). Writes dq (BH, Sq, D) and dk, dv (BH/G, Sk, D) in bf16 at D =
//   64, 128 and 256; every sum is kept in fp32.
//
//   Design: flash_attention_bwd.cu's split (FlashAttention-2's, no atomics,
//   so two runs give the same bits), every product on the tensor cores
//   (mma.sync m16n8k16, bf16 operands from shared memory through ldmatrix,
//   fp32 accumulators), 64-row query tiles and 64-key tiles at every D:
//   0. the forward (flash_attention_fwd_lse, attention.cu's bf16 body in
//      an instantiation of its own) writes each row's log2-sum-exp2 of its
//      scaled logits, lse2 (BH, Sq) fp32, so no pass recomputes it;
//   1. delta = rowsum(dO * o) in fp32 into a (BH, Sq) workspace, one CTA
//      per (bh, 64-row query tile);
//   2. dK/dV, one CTA of 8 warps per (kv head, key tile, share): for each
//      (query head, query tile) item of its share, in head order, of the
//      G heads x the query tiles that see one of its keys, S^T = K Q^T and
//      dP^T = V dO^T (warp w: 16 keys x 32 queries),
//      P^T = exp2(S^T scale log2e - lse2) and dS^T = P^T (dP^T - delta) in
//      fp32 registers, rounded to bf16 into shared memory (as the forward
//      rounds P before its PV product), then dV += P^T dO and dK += dS^T Q
//      (warp w: 16 keys x D/2 columns, dO and Q read through ldmatrix.trans
//      as the B operand held [k][n]). The pass lasts as long as its longest
//      CTA, and a causal prompt's first key tiles, or any inside a long
//      window, hold many items; so the wrapper may share each key tile's
//      items out over `split` CTAs (flash_attention.bwd_split): each writes
//      its fp32 partial dK, dV, and a last launch sums the shares in share
//      order and rounds to bf16;
//   3. dQ, one CTA of 8 warps per (bh, query tile): S = Q K^T, dP = dO V^T,
//      dS through shared memory in bf16, dQ += dS K (K through
//      ldmatrix.trans), the next key tile's K and V loading meanwhile.
//   A tile pair is skipped whole when the mask keeps none of its pairs
//   (uniform per CTA), as in the fp32 body. Tiles arrive by 16-byte
//   cp.async copies (rows past S zero-filled) into rows padded by 16 bytes,
//   so the 8 row addresses of an ldmatrix fall in distinct banks.
//
//   Why mma.sync and not wgmma: three of the five products take an operand
//   transposed from the layout the tile arrives in (P^T dO, dS^T Q, dS K),
//   and the products' A operands P^T and dS^T are written by other warps
//   than the ones that read them; ldmatrix.trans serves both from one
//   padded shared layout, where wgmma would need a second swizzled copy of
//   each of Q, dO and K or a transposing TMA layout. wgmma is ROADMAP §2
//   R18's next step.
//
//   Bound on an H100: operations at the bf16 tensor-core peak (989 TFLOP/s).
//   The backward does 2.5 times the forward's products (kernels/cost.py);
//   this body does 4 of the forward's products again (S and dP in both the
//   dK/dV and the dQ pass) beside the 3 gradient ones, 7 against the 5 the
//   bound counts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention.cuh"

using bullet::cp_async_commit;
using bullet::cp_async_wait;
using bullet::ldsm_x4;
using bullet::ldsm_x4_t;
using bullet::mma_16816;
using bullet::pack_bf16;
using bullet::smem_u32;

namespace {

using bf16 = __nv_bfloat16;
constexpr int TB = 64;            // query rows, and keys, of a tile
constexpr int PLD = TB + 8;       // padded bf16 row of a P or dS tile
constexpr int THREADS = 256;      // dK/dV and dQ: 8 warps
constexpr int PRE_THREADS = 128;  // the delta pass: two threads a row
constexpr float LOG2E = 1.4426950408889634f;

struct TcArgs {
  const bf16 *q, *k, *v, *o, *dout;
  bf16 *dq, *dk, *dv;
  const float *lse2;  // (bh, sq): log2 sum_j exp2(S_ij scale log2e)
  float *delta;  // (bh, sq): rowsum(dO * o)
  float *part;   // (2, split, bh / G, sk, D): partial dK, dV (split > 1)
  int bh, sq, sk, group, causal, window, split;
  float scale;
};

__device__ __forceinline__ int cdiv(int x, int y) { return (x + y - 1) / y; }

// query row i sees key j (q_offset 0)
__device__ __forceinline__ bool seen(const TcArgs &a, int i, int j) {
  if (i >= a.sq || j >= a.sk) return false;
  if (a.causal && j > i) return false;
  if (a.window > 0 && j <= i - a.window) return false;
  return true;
}

// whether the query rows [q0, q1] and the keys [k0, k1] hold a seen pair
__device__ __forceinline__ bool tiles_meet(const TcArgs &a, int q0, int q1,
                                           int k0, int k1) {
  if (a.causal && q1 < k0) return false;
  if (a.window > 0 && q0 - k1 >= a.window) return false;
  return true;
}

// 16 bytes global -> shared, zeros when !in (src must still be mapped)
__device__ __forceinline__ void cp16(void *dst, const void *src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// rows [r0, r0 + TB) of an (n, D) bf16 matrix into dst[TB][D + 8], zeros
// past row n, by the NT threads of the CTA (the caller commits)
template <int D, int NT>
__device__ __forceinline__ void load_tile(bf16 *dst, const bf16 *src, int r0,
                                          int n) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < TB * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * 8;
    const bool in = r0 + r < n;
    cp16(dst + r * (D + 8) + c, src + (size_t)(in ? r0 + r : 0) * D + c, in);
  }
}

// this lane's ldmatrix x4 row address, as an offset, of:
// an A operand held [m][k]: rows m0 .. m0 + 15, columns k0 .. k0 + 15
__device__ __forceinline__ int a_off(int m0, int k0, int ld, int lane) {
  return (m0 + lane % 16) * ld + k0 + 8 * (lane / 16);
}
// a B operand held [n][k]: rows n0 .. n0 + 15 (two n8 blocks), columns k0 ..
// k0 + 15
__device__ __forceinline__ int bn_off(int n0, int k0, int ld, int lane) {
  return (n0 + 8 * (lane / 16) + lane % 8) * ld + k0 + 8 * ((lane / 8) % 2);
}
// a B operand held [k][n] (.trans): rows k0 .. k0 + 15, columns n0 .. n0 +
// 15 (two n8 blocks)
__device__ __forceinline__ int bk_off(int k0, int n0, int ld, int lane) {
  return (k0 + lane % 8 + 8 * ((lane / 8) % 2)) * ld + n0 + 8 * (lane / 16);
}

// acc (16 rows from m0, NB n8 blocks from n0) += A B^T over KD: A held
// [m][k] (row stride lda), B held [n][k] (ldb)
template <int NB, int KD>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4], const bf16 *A,
                                        int lda, int m0, const bf16 *B,
                                        int ldb, int n0, int lane) {
#pragma unroll
  for (int kk = 0; kk < KD; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, smem_u32(A + a_off(m0, kk, lda, lane)));
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, smem_u32(B + bn_off(n0 + 8 * nb, kk, ldb, lane)));
      mma_16816(acc[nb], af, bf[0], bf[1]);
      mma_16816(acc[nb + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 rows from m0, NB n8 blocks from n0) += A B over KD: A held [m][k]
// (lda), B held [k][n] (ldb), read transposed
template <int NB, int KD>
__device__ __forceinline__ void mma_ab(float (&acc)[NB][4], const bf16 *A,
                                       int lda, int m0, const bf16 *B,
                                       int ldb, int n0, int lane) {
#pragma unroll
  for (int kk = 0; kk < KD; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, smem_u32(A + a_off(m0, kk, lda, lane)));
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      uint32_t bf[4];
      ldsm_x4_t(bf, smem_u32(B + bk_off(kk, n0 + 8 * nb, ldb, lane)));
      mma_16816(acc[nb], af, bf[0], bf[1]);
      mma_16816(acc[nb + 1], af, bf[2], bf[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. delta of one (bh, 64-row query tile), two threads a row
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(PRE_THREADS) flash_bwd_tc_delta(
    const TcArgs a) {
  const int n_qt = cdiv(a.sq, TB);
  const int bh = blockIdx.x / n_qt, q0 = (blockIdx.x % n_qt) * TB;
  const int tid = threadIdx.x;
  const int r = q0 + tid / 2;
  float dsum = 0.f;
  if (r < a.sq) {
    const size_t row = ((size_t)bh * a.sq + r) * D + (tid % 2) * (D / 2);
    const __nv_bfloat162 *dp =
        reinterpret_cast<const __nv_bfloat162 *>(a.dout + row);
    const __nv_bfloat162 *op =
        reinterpret_cast<const __nv_bfloat162 *>(a.o + row);
#pragma unroll 8
    for (int c = 0; c < D / 4; ++c) {
      const float2 x = __bfloat1622float2(dp[c]);
      const float2 y = __bfloat1622float2(op[c]);
      dsum += x.x * y.x + x.y * y.y;
    }
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  if (tid % 2 == 0 && r < a.sq) a.delta[(size_t)bh * a.sq + r] = dsum;
}

// ---------------------------------------------------------------------------
// 2. dK and dV of one (kv head, key tile, share of its items)
// ---------------------------------------------------------------------------

template <int D>
constexpr int dkdv_smem() {
  return 4 * TB * (D + 8) * 2 + 2 * TB * PLD * 2 + 2 * TB * 4;
}

template <int D>
__global__ void __launch_bounds__(THREADS, D == 256 ? 1 : 2)
    flash_bwd_tc_dkdv(const TcArgs a) {
  constexpr int LD = D + 8;
  constexpr int NB = D / 16;  // n8 blocks of a warp's D / 2 columns
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 *Ks = reinterpret_cast<bf16 *>(smem);
  bf16 *Vs = Ks + TB * LD;
  bf16 *Qs = Vs + TB * LD;
  bf16 *dOs = Qs + TB * LD;
  bf16 *Pt = dOs + TB * LD;   // [key][query]
  bf16 *dSt = Pt + TB * PLD;  // [key][query]
  float *Ls = reinterpret_cast<float *>(dSt + TB * PLD);
  float *Ds = Ls + TB;
  const int n_kvh = a.bh / a.group;
  int idx = blockIdx.x;
  const int sp = idx % a.split;
  idx /= a.split;
  const int kvh = idx % n_kvh, kt = idx / n_kvh;  // heavy key tiles first
  const int k0 = kt * TB, k1 = min(k0 + TB, a.sk) - 1;
  // the query tiles that meet this key tile are contiguous: [qt0, qt0 +
  // nq); this CTA takes share sp of the G x nq (head, query tile) items,
  // in head order
  const int n_qt = cdiv(a.sq, TB);
  int qt0 = n_qt, nq = 0;
  for (int qt = 0; qt < n_qt; ++qt)
    if (tiles_meet(a, qt * TB, min(qt * TB + TB, a.sq) - 1, k0, k1)) {
      qt0 = min(qt0, qt);
      ++nq;
    }
  const int it_lo = sp * a.group * nq / a.split;
  const int it_hi = (sp + 1) * a.group * nq / a.split;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);
  const int kr = 16 * (warp % 4);         // this warp's keys, both phases
  const int qc = 32 * (warp / 4);         // its queries in phase 1
  const int dc = (D / 2) * (warp / 4);    // its columns in phase 2
  load_tile<D, THREADS>(Ks, a.k + (size_t)kvh * a.sk * D, k0, a.sk);
  load_tile<D, THREADS>(Vs, a.v + (size_t)kvh * a.sk * D, k0, a.sk);
  cp_async_commit();
  const float sl2 = a.scale * LOG2E;

  float dk[NB][4] = {}, dv[NB][4] = {};
  for (int it = it_lo; it < it_hi; ++it) {
    const int bhq = kvh * a.group + it / nq;
    const size_t base = (size_t)bhq * a.sq;
    const int q0 = (qt0 + it % nq) * TB;
    __syncthreads();  // the previous query tile is consumed
    load_tile<D, THREADS>(Qs, a.q + base * D, q0, a.sq);
    load_tile<D, THREADS>(dOs, a.dout + base * D, q0, a.sq);
    cp_async_commit();
    for (int c = tid; c < TB; c += THREADS) {
      const bool in = q0 + c < a.sq;
      Ls[c] = in ? a.lse2[base + q0 + c] : 0.f;
      Ds[c] = in ? a.delta[base + q0 + c] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mma_abt<4, D>(s, Ks, LD, kr, Qs, LD, qc, lane);
    mma_abt<4, D>(dp, Vs, LD, kr, dOs, LD, qc, lane);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = kr + g + 8 * h, key = k0 + row;
        const int col = qc + 8 * nb + t2, qi = q0 + col;
        const float p0 = seen(a, qi, key)
                             ? exp2f(s[nb][2 * h] * sl2 - Ls[col])
                             : 0.f;
        const float p1 = seen(a, qi + 1, key)
                             ? exp2f(s[nb][2 * h + 1] * sl2 - Ls[col + 1])
                             : 0.f;
        const float d0 = p0 * (dp[nb][2 * h] - Ds[col]);
        const float d1 = p1 * (dp[nb][2 * h + 1] - Ds[col + 1]);
        *reinterpret_cast<uint32_t *>(Pt + row * PLD + col) =
            pack_bf16(p0, p1);
        *reinterpret_cast<uint32_t *>(dSt + row * PLD + col) =
            pack_bf16(d0, d1);
      }
    __syncthreads();  // a key row's P^T and dS^T come from two warps
    mma_ab<NB, TB>(dv, Pt, PLD, kr, dOs, LD, dc, lane);
    mma_ab<NB, TB>(dk, dSt, PLD, kr, Qs, LD, dc, lane);
  }
  cp_async_wait<0>();  // no copy in flight at exit (a CTA that met no tile)

  const size_t pn = (size_t)a.split * n_kvh * a.sk * D;  // one partial
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + kr + g + 8 * h;
      if (key >= a.sk) continue;
      const int col = dc + 8 * nb + t2;
      const float k0v = dk[nb][2 * h] * a.scale;
      const float k1v = dk[nb][2 * h + 1] * a.scale;
      const size_t o = ((size_t)kvh * a.sk + key) * D + col;
      if (a.split == 1) {
        *reinterpret_cast<__nv_bfloat162 *>(a.dk + o) =
            __floats2bfloat162_rn(k0v, k1v);
        *reinterpret_cast<__nv_bfloat162 *>(a.dv + o) =
            __floats2bfloat162_rn(dv[nb][2 * h], dv[nb][2 * h + 1]);
      } else {
        const size_t po = (size_t)sp * n_kvh * a.sk * D + o;
        *reinterpret_cast<float2 *>(a.part + po) = make_float2(k0v, k1v);
        *reinterpret_cast<float2 *>(a.part + pn + po) =
            make_float2(dv[nb][2 * h], dv[nb][2 * h + 1]);
      }
    }
}

// the split heads' partial dK and dV summed in share order, in bf16
__global__ void __launch_bounds__(THREADS) flash_bwd_tc_sum(const TcArgs a,
                                                            int d) {
  const size_t n = (size_t)(a.bh / a.group) * a.sk * d;
  const size_t e = ((size_t)blockIdx.x * THREADS + threadIdx.x) * 2;
  if (e >= n) return;
  const size_t pn = (size_t)a.split * n;
  float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
  for (int s = 0; s < a.split; ++s) {
    const float2 x = *reinterpret_cast<const float2 *>(a.part + s * n + e);
    const float2 y =
        *reinterpret_cast<const float2 *>(a.part + pn + s * n + e);
    sk.x += x.x;
    sk.y += x.y;
    sv.x += y.x;
    sv.y += y.y;
  }
  *reinterpret_cast<__nv_bfloat162 *>(a.dk + e) =
      __floats2bfloat162_rn(sk.x, sk.y);
  *reinterpret_cast<__nv_bfloat162 *>(a.dv + e) =
      __floats2bfloat162_rn(sv.x, sv.y);
}

// ---------------------------------------------------------------------------
// 3. dQ of one (bh, query tile)
// ---------------------------------------------------------------------------

template <int D>
constexpr int dq_smem() {
  return 6 * TB * (D + 8) * 2 + TB * PLD * 2;  // q, dO, 2 x (k, v), dS
}

template <int D>
__global__ void __launch_bounds__(THREADS, D == 256 ? 1 : 2)
    flash_bwd_tc_dq(const TcArgs a) {
  constexpr int LD = D + 8;
  constexpr int NB = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 *Qs = reinterpret_cast<bf16 *>(smem);
  bf16 *dOs = Qs + TB * LD;
  bf16 *KV = dOs + TB * LD;  // two buffers of [K tile, V tile]
  bf16 *dSs = KV + 4 * TB * LD;  // [query][key]
  const int n_qt = cdiv(a.sq, TB);
  const int bh = blockIdx.x % a.bh;
  const int qt = n_qt - 1 - blockIdx.x / a.bh;  // the longest rows first
  const int kvh = bh / a.group;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);
  const int qr = 16 * (warp % 4);         // this warp's rows, both phases
  const int kc = 32 * (warp / 4);         // its keys in phase 1
  const int dc = (D / 2) * (warp / 4);    // its columns in phase 2
  const int q0 = qt * TB, q1 = min(q0 + TB, a.sq) - 1;
  const size_t base = (size_t)bh * a.sq;
  load_tile<D, THREADS>(Qs, a.q + base * D, q0, a.sq);
  load_tile<D, THREADS>(dOs, a.dout + base * D, q0, a.sq);
  cp_async_commit();
  const int i0 = q0 + qr + g, i1 = i0 + 8;
  const float L0 = i0 < a.sq ? a.lse2[base + i0] : 0.f;
  const float L1 = i1 < a.sq ? a.lse2[base + i1] : 0.f;
  const float D0 = i0 < a.sq ? a.delta[base + i0] : 0.f;
  const float D1 = i1 < a.sq ? a.delta[base + i1] : 0.f;
  const bf16 *k = a.k + (size_t)kvh * a.sk * D;
  const bf16 *v = a.v + (size_t)kvh * a.sk * D;
  const float sl2 = a.scale * LOG2E;

  // the key tiles that meet this query tile are contiguous, [kt0, kt0 +
  // nk); the next one's K and V arrive while this one's products run
  const int n_kt = cdiv(a.sk, TB);
  int kt0 = n_kt, nk = 0;
  for (int kt = 0; kt < n_kt; ++kt)
    if (tiles_meet(a, q0, q1, kt * TB, min(kt * TB + TB, a.sk) - 1)) {
      kt0 = min(kt0, kt);
      ++nk;
    }
  auto load_kv = [&](int buf, int kt) {
    load_tile<D, THREADS>(KV + 2 * buf * TB * LD, k, kt * TB, a.sk);
    load_tile<D, THREADS>(KV + (2 * buf + 1) * TB * LD, v, kt * TB, a.sk);
    cp_async_commit();
  };
  if (nk > 0) load_kv(0, kt0);

  float dq[NB][4] = {};
  for (int i = 0; i < nk; ++i) {
    const int k0 = (kt0 + i) * TB, buf = i & 1;
    const bf16 *Ks = KV + 2 * buf * TB * LD, *Vs = Ks + TB * LD;
    __syncthreads();  // the other buffer's key tile is consumed
    if (i + 1 < nk) {
      load_kv(buf ^ 1, kt0 + i + 1);
      cp_async_wait<1>();  // q, dO and this key tile have arrived
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mma_abt<4, D>(s, Qs, LD, qr, Ks, LD, kc, lane);
    mma_abt<4, D>(dp, dOs, LD, qr, Vs, LD, kc, lane);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = qr + g + 8 * h, qi = q0 + row;
        const float L = h ? L1 : L0, dl = h ? D1 : D0;
        const int col = kc + 8 * nb + t2, key = k0 + col;
        const float p0 =
            seen(a, qi, key) ? exp2f(s[nb][2 * h] * sl2 - L) : 0.f;
        const float p1 =
            seen(a, qi, key + 1) ? exp2f(s[nb][2 * h + 1] * sl2 - L) : 0.f;
        *reinterpret_cast<uint32_t *>(dSs + row * PLD + col) =
            pack_bf16(p0 * (dp[nb][2 * h] - dl),
                      p1 * (dp[nb][2 * h + 1] - dl));
      }
    __syncthreads();  // a query row's dS comes from two warps
    mma_ab<NB, TB>(dq, dSs, PLD, qr, Ks, LD, dc, lane);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + qr + g + 8 * h;
      if (row >= a.sq) continue;
      *reinterpret_cast<__nv_bfloat162 *>(
          a.dq + (base + row) * D + dc + 8 * nb + t2) =
          __floats2bfloat162_rn(dq[nb][2 * h] * a.scale,
                                dq[nb][2 * h + 1] * a.scale);
    }
}

template <typename K>
cudaError_t launch_one(K kern, int grid, int threads, size_t smem,
                       const TcArgs &a, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int D>
int launch_tc(const TcArgs &a, cudaStream_t s) {
  const int n_qt = (a.sq + TB - 1) / TB, n_kt = (a.sk + TB - 1) / TB;
  cudaError_t e = launch_one(flash_bwd_tc_delta<D>, a.bh * n_qt,
                             PRE_THREADS, 0, a, s);
  if (e != cudaSuccess) return (int)e;
  e = launch_one(flash_bwd_tc_dkdv<D>, a.bh / a.group * n_kt * a.split,
                 THREADS, dkdv_smem<D>(), a, s);
  if (e != cudaSuccess) return (int)e;
  if (a.split > 1) {
    const size_t pairs = (size_t)(a.bh / a.group) * a.sk * D / 2;
    flash_bwd_tc_sum<<<(unsigned)((pairs + THREADS - 1) / THREADS), THREADS,
                       0, s>>>(a, D);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)launch_one(flash_bwd_tc_dq<D>, a.bh * n_qt, THREADS,
                         dq_smem<D>(), a, s);
}

}  // namespace

extern "C" {

// bf16 at D = 64, 128 or 256, q_offset 0. lse2 (bh, sq) fp32 as
// flash_attention_fwd_lse wrote it. Workspaces the wrapper allocates: delta
// (bh, sq) fp32; with split > 1 (a key tile's (head, query tile) items
// over split CTAs), part (2, split, bh / G, sk, D) fp32
int flash_attention_bwd_tc(const void *q, const void *k, const void *v,
                           const void *o, const void *dout, void *dq,
                           void *dk, void *dv, const float *lse2,
                           float *delta, float *part, int bh, int sq, int sk,
                           int d, int group, int causal, int window,
                           int split, void *stream) {
  if (bh < 1 || sq < 1 || sk < 1 || group < 1 || bh % group != 0 ||
      split < 1 || (split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  TcArgs a{static_cast<const bf16 *>(q),    static_cast<const bf16 *>(k),
           static_cast<const bf16 *>(v),    static_cast<const bf16 *>(o),
           static_cast<const bf16 *>(dout), static_cast<bf16 *>(dq),
           static_cast<bf16 *>(dk),         static_cast<bf16 *>(dv),
           lse2,                            delta,
           part,                            bh,
           sq,                              sk,
           group,                           causal,
           window,                          split,
           1.0f / sqrtf((float)d)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_tc<64>(a, s);
  if (d == 128) return launch_tc<128>(a, s);
  if (d == 256) return launch_tc<256>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
