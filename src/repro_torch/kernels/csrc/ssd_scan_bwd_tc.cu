// Hand-written Hopper (sm_90a) backward of the Mamba-2 SSD chunk scan
// (kernel 6) in bf16, on the tensor cores, behind the same plain C interface
// as attention.cu (loaded with ctypes by repro_torch/kernels/build.py). It
// launches on the stream it is given, allocates nothing (the wrapper
// allocates the outputs and the workspaces), and returns cudaGetLastError()
// after its launches, or cudaErrorInvalidValue for sizes it does not hold.
//
// ssd_scan_bwd_tc
//   Replaces no TPU kernel: the JAX package takes the scan's gradient
//   through XLA. It is the gradient of ssd_scan_fwd's bf16 body, the algebra
//   of ssd_scan_bwd.cu's header (kernels/ref.py ssd_scan_bwd_ref states it
//   plainly): xw, B, C and dy in bf16, cum, state0 and dstate in fp32;
//   writes dxw, dB, dC in bf16 and dcum, dstate0 in fp32. Q <= 256, N <=
//   128 and P <= 64, N and P multiples of 8.
//
//   Design: ssd_scan_bwd.cu's four launches, every tile product on the
//   tensor cores (mma.sync m16n8k16, bf16 operands, fp32 accumulators):
//   1. ssd_bwd_tc_local: C B^T in 64 x 64 tiles of the lower triangle, once
//      per (b, chunk, tile pair), fp32 into the workspace cb (B, NC, Qp,
//      Qp) as the bf16 forward's ssd_state_kernel makes it; beside them, in
//      the same grid, per (b, chunk, head) the chunk's own state sum_j
//      e^{total - cum_j} xw_j B_j^T and its own gradient term sum_i
//      e^{cum_i} dy_i C_i^T, P x N in fp32 into states[b, c + 1] and
//      grads[b, c]: the weighted rows split as V_hi + V_lo in bf16 (as the
//      forward's chunk states), so these sums keep about 2^-17 of their
//      scale.
//   2. ssd_bwd_tc_pass: per element of each (b, h) state, the sequential
//      passes in fp32, S forward from state0 and G backward from dstate,
//      as ssd_bwd_pass_kernel; the first chunk's G is dstate0.
//   3. ssd_bwd_tc_chunk: one CTA of 4 warps per (b, chunk, 64-row tile t,
//      role, group of hg heads), those with the most tile pairs launched
//      first. Role "rows" owns rows i of tile t (C_i,
//      dy_i) and walks the column tiles at or before it; role "columns"
//      owns rows j (B_j, xw_j) and walks the row tiles at or after it. The
//      CTA walks its heads in order over the same tiles: per head and tile
//      pair, warp w computes 16 own rows x 64 other rows of Y = dy xw^T
//      (rows) or Y^T (columns) on the tensor cores, reads its C B^T
//      fragment from the workspace (never recomputed), forms M = L Y in
//      fp32 registers, adds its dcum terms, and feeds M (rounded to bf16)
//      straight from its accumulator registers as the A operand of dC_i +=
//      M B_j, or M^T of dB_j += M^T C_i and (C B^T L)^T of dxw_j += (C B^T
//      L)^T dy_i. dC and dB sum over the CTA's heads in fp32 registers, so
//      the per-head workspaces of the fp32 body shrink to one per head
//      group, dbg and dcg (B, NC, groups, Q, N). The state terms (e^{cum_i}
//      dy_i S, e^{total - cum_j} B_j G^T, e^{total - cum_j} xw_j G and
//      dcum's C_i S^T dy_i) run on the tensor cores too, with S and G
//      rounded to bf16 (the forward rounds S so for its inter term).
//   4. ssd_bwd_tc_reduce: dB and dC sum their group parts in group order
//      (no atomics: two runs give the same bits) and round to bf16; dcum
//      adds its two halves.
//
//   Bound on an H100: operations at the bf16 tensor-core peak
//   (kernels/cost.py ssd_bwd_cost); at Mamba-2-2.7B's shapes (H = 80, P =
//   64, N = 128, Q = 256) about 0.015 ms per 1000-token prompt.

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
constexpr int TQ = 64;           // rows of a chunk per tile
constexpr int P_MAX = 64;        // head dim the shared tiles hold
constexpr int N_MAX = 128;       // state size the shared tiles hold
constexpr int Q_MAX = 256;       // chunk length the cum buffer holds
constexpr int PW = P_MAX + 8;    // padded bf16 row of a P-wide tile
constexpr int NW = N_MAX + 8;    // padded bf16 row of an N-wide tile
constexpr int THREADS = 128;     // 4 warps of 16 rows
constexpr int PASS_THREADS = 256;

struct TcArgs {
  const bf16 *xw, *b, *c, *dy;
  const float *cum, *state0, *dstate;
  bf16 *dxw, *db, *dc;
  float *dcum, *dstate0;
  float *states;  // (B, NC + 1, H, P, N)
  float *grads;   // (B, NC, H, P, N)
  float *cb;      // (B, NC, Qp, Qp)
  float *dbg, *dcg;  // (B, NC, groups, Q, N) the head groups' parts
  float *dcum2;      // (2, B, NC, Q, H) the rows' and the columns' halves
  int batch, nc, q, h, p, n, hg, groups;
};

__device__ __forceinline__ long state_at(const TcArgs &a, int bb, int c,
                                         int nstates, int hh) {
  return (((long)bb * nstates + c) * a.h + hh) * a.p * a.n;
}

__device__ __forceinline__ void cp16(void *dst, const void *src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// rows [r0, r0 + TQ) of a row-major bf16 matrix (row stride ld, `w`
// columns from src, a multiple of 8) into dst[TQ][ds], zeros for columns
// [w, wp) and for rows at or past `rows` (the caller commits)
__device__ __forceinline__ void stage(bf16 *dst, int ds, const bf16 *src,
                                      long ld, int r0, int rows, int w,
                                      int wp) {
  const int groups = wp / 8;
  for (int i = threadIdx.x; i < TQ * groups; i += THREADS) {
    const int r = i / groups, c = (i % groups) * 8;
    const bool in = r0 + r < rows && c < w;
    cp16(dst + r * ds + c, src + (in ? (long)(r0 + r) * ld + c : 0), in);
  }
}

// this lane's ldmatrix x4 row address, as an offset, of:
// an A operand held [m][k]: rows m0 .. m0 + 15, columns k0 .. k0 + 15
__device__ __forceinline__ int a_off(int m0, int k0, int ld, int lane) {
  return (m0 + lane % 16) * ld + k0 + 8 * (lane / 16);
}
// an A operand held [k][m] (.trans): rows k0 .. k0 + 15, columns m0 .. +15
__device__ __forceinline__ int at_off(int k0, int m0, int ld, int lane) {
  return (k0 + 8 * (lane / 16) + lane % 8) * ld + m0 + 8 * ((lane / 8) % 2);
}
// a B operand held [n][k]: rows n0 .. n0 + 15, columns k0 .. k0 + 15
__device__ __forceinline__ int bn_off(int n0, int k0, int ld, int lane) {
  return (n0 + 8 * (lane / 16) + lane % 8) * ld + k0 + 8 * ((lane / 8) % 2);
}
// a B operand held [k][n] (.trans): rows k0 .. k0 + 15, columns n0 .. +15
__device__ __forceinline__ int bk_off(int k0, int n0, int ld, int lane) {
  return (k0 + lane % 8 + 8 * ((lane / 8) % 2)) * ld + n0 + 8 * (lane / 16);
}

// acc (16 rows from m0, NB n8 blocks) += A B^T over KD: A [m][k], B [n][k]
template <int NB, int KD>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4], const bf16 *A,
                                        int lda, int m0, const bf16 *B,
                                        int ldb, int lane) {
#pragma unroll
  for (int kk = 0; kk < KD; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, smem_u32(A + a_off(m0, kk, lda, lane)));
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, smem_u32(B + bn_off(8 * nb, kk, ldb, lane)));
      mma_16816(acc[nb], af, bf[0], bf[1]);
      mma_16816(acc[nb + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 rows from m0, NB n8 blocks) += A B over KD: A [m][k], B [k][n]
template <int NB, int KD>
__device__ __forceinline__ void mma_ab(float (&acc)[NB][4], const bf16 *A,
                                       int lda, int m0, const bf16 *B,
                                       int ldb, int lane) {
#pragma unroll
  for (int kk = 0; kk < KD; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, smem_u32(A + a_off(m0, kk, lda, lane)));
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      uint32_t bf[4];
      ldsm_x4_t(bf, smem_u32(B + bk_off(kk, 8 * nb, ldb, lane)));
      mma_16816(acc[nb], af, bf[0], bf[1]);
      mma_16816(acc[nb + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (NB n8 blocks) += R B over 64: R a warp's 16 x 64 accumulator tile
// rounded to bf16 pairs in registers (r[nb][0] the pair of row g, r[nb][1]
// of row g + 8, n8 block nb), the A operand as it stands; B [k][n]
template <int NB>
__device__ __forceinline__ void mma_rb(float (&acc)[NB][4],
                                       const uint32_t (&r)[8][2],
                                       const bf16 *B, int ldb, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t af[4] = {r[2 * kk][0], r[2 * kk][1], r[2 * kk + 1][0],
                            r[2 * kk + 1][1]};
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      uint32_t bf[4];
      ldsm_x4_t(bf, smem_u32(B + bk_off(16 * kk, 8 * nb, ldb, lane)));
      mma_16816(acc[nb], af, bf[0], bf[1]);
      mma_16816(acc[nb + 1], af, bf[2], bf[3]);
    }
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float ld_bf(const bf16 *p) {
  return __bfloat162float(*p);
}

// ---------------------------------------------------------------------------
// 1. C B^T tiles; each chunk's own state and its own gradient term
// ---------------------------------------------------------------------------

// shared bf16: the C and B rows of a tile [TQ][NW] each; or the weighted
// P-wide rows V_hi, V_lo [TQ][PW] and the N-wide rows [TQ][NW]
constexpr int LOCAL_SMEM = 2 * (2 * TQ * PW + TQ * NW);
static_assert(2 * TQ * NW <= 2 * TQ * PW + TQ * NW, "cb tiles fit");

// C B^T tile t (of the lower triangle, in row order) of chunk bc
__device__ void cb_tile(const TcArgs &a, long bc, int t, bf16 *smem) {
  bf16 *cs = smem, *bs = smem + TQ * NW;
  const int nt = (a.q + TQ - 1) / TQ, qp = nt * TQ;
  int tj = t, ti = 0;
  while (tj > ti) tj -= ++ti;
  stage(cs, NW, a.c + bc * a.q * a.n, a.n, ti * TQ, a.q, a.n, N_MAX);
  stage(bs, NW, a.b + bc * a.q * a.n, a.n, tj * TQ, a.q, a.n, N_MAX);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[8][4] = {};
  mma_abt<8, N_MAX>(acc, cs, NW, 16 * warp, bs, NW, lane);
  const int g = lane / 4, t2 = 2 * (lane % 4);
  float *out = a.cb + (bc * qp + ti * TQ + 16 * warp + g) * qp + tj * TQ + t2;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    *reinterpret_cast<float2 *>(out + 8 * nb) =
        make_float2(acc[nb][0], acc[nb][1]);
    *reinterpret_cast<float2 *>(out + 8 * qp + 8 * nb) =
        make_float2(acc[nb][2], acc[nb][3]);
  }
}

// (b, chunk, head, which): out[p][n] = sum_j w_j X_j[p] Y_j[n], with X = xw,
// Y = B, w = e^{total - cum_j} (which 0, the chunk's own state) or X = dy,
// Y = C, w = e^{cum_j} (which 1, its own gradient term); w X rides as
// V_hi + V_lo in bf16, each through ldmatrix.trans as the A operand
__device__ void chunk_local(const TcArgs &a, int item, bf16 *smem) {
  bf16 *vhi = smem, *vlo = vhi + TQ * PW, *ys = vlo + TQ * PW;
  const bool own_state = item % 2 == 0;
  item /= 2;
  const int hh = item % a.h, bc = item / a.h;
  const int bb = bc / a.nc, ch = bc % a.nc;
  const long row0 = (long)bc * a.q;
  const float total = a.cum[(row0 + a.q - 1) * a.h + hh];
  const bf16 *xv = own_state ? a.xw : a.dy;
  const bf16 *yv = own_state ? a.b : a.c;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[16][4] = {};
  for (int j0 = 0; j0 < a.q; j0 += TQ) {
    __syncthreads();  // the previous rows are consumed
    stage(ys, NW, yv + row0 * a.n, a.n, j0, a.q, a.n, N_MAX);
    cp_async_commit();
    for (int e = threadIdx.x; e < TQ * P_MAX; e += THREADS) {
      const int r = e / P_MAX, k = e % P_MAX;
      float v = 0.f;
      if (j0 + r < a.q && k < a.p) {
        const long row = row0 + j0 + r;
        const float cj = a.cum[row * a.h + hh];
        v = ld_bf(xv + (row * a.h + hh) * a.p + k) *
            (own_state ? expf(total - cj) : expf(cj));
      }
      const bf16 hi = __float2bfloat16(v);
      vhi[r * PW + k] = hi;
      vlo[r * PW + k] = __float2bfloat16(v - __bfloat162float(hi));
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TQ; kk += 16) {
      uint32_t ah[4], al[4];
      ldsm_x4_t(ah, smem_u32(vhi + at_off(kk, 16 * warp, PW, lane)));
      ldsm_x4_t(al, smem_u32(vlo + at_off(kk, 16 * warp, PW, lane)));
#pragma unroll
      for (int nb = 0; nb < 16; nb += 2) {
        uint32_t bq[4];
        ldsm_x4_t(bq, smem_u32(ys + bk_off(kk, 8 * nb, NW, lane)));
        mma_16816(acc[nb], ah, bq[0], bq[1]);
        mma_16816(acc[nb + 1], ah, bq[2], bq[3]);
        mma_16816(acc[nb], al, bq[0], bq[1]);
        mma_16816(acc[nb + 1], al, bq[2], bq[3]);
      }
    }
  }
  float *out = own_state ? a.states + state_at(a, bb, ch + 1, a.nc + 1, hh)
                         : a.grads + state_at(a, bb, ch, a.nc, hh);
  const int g = lane / 4, t2 = 2 * (lane % 4);
#pragma unroll
  for (int nb = 0; nb < 16; ++nb)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int pp = 16 * warp + g + 8 * hf, nn = 8 * nb + t2;
      if (pp < a.p && nn < a.n)
        *reinterpret_cast<float2 *>(out + (long)pp * a.n + nn) =
            make_float2(acc[nb][2 * hf], acc[nb][2 * hf + 1]);
    }
}

__global__ void __launch_bounds__(THREADS, 3) ssd_bwd_tc_local(TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16 *smem = reinterpret_cast<bf16 *>(smem_raw);
  const int nt = (a.q + TQ - 1) / TQ;
  const int ntri = nt * (nt + 1) / 2;
  const int n_cb = a.batch * a.nc * ntri;
  if ((int)blockIdx.x < n_cb)
    cb_tile(a, blockIdx.x / ntri, blockIdx.x % ntri, smem);
  else
    chunk_local(a, blockIdx.x - n_cb, smem);
}

// ---------------------------------------------------------------------------
// 2. the passes over the chunks, forward for S and backward for G (fp32)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(PASS_THREADS) ssd_bwd_tc_pass(TcArgs a) {
  const long pn = (long)a.p * a.n;
  const long e = (long)blockIdx.x * PASS_THREADS + threadIdx.x;
  if (e >= pn) return;
  const int bb = blockIdx.y / a.h, hh = blockIdx.y % a.h;
  const long bh = (long)blockIdx.y * pn + e;  // (B, H, P, N) element
  float s = a.state0 != nullptr ? a.state0[bh] : 0.f;
  for (int c = 0; c < a.nc; ++c) {
    const long bc = (long)bb * a.nc + c;
    const float dec = expf(a.cum[((bc + 1) * a.q - 1) * a.h + hh]);
    float *slot = a.states + state_at(a, bb, c + 1, a.nc + 1, hh) + e;
    const float own = *slot;  // (1.)'s own state of chunk c
    a.states[state_at(a, bb, c, a.nc + 1, hh) + e] = s;
    s = dec * s + own;
  }
  a.states[state_at(a, bb, a.nc, a.nc + 1, hh) + e] = s;
  float g = a.dstate != nullptr ? a.dstate[bh] : 0.f;
  for (int c = a.nc - 1; c >= 0; --c) {
    const long bc = (long)bb * a.nc + c;
    const float dec = expf(a.cum[((bc + 1) * a.q - 1) * a.h + hh]);
    float *slot = a.grads + state_at(a, bb, c, a.nc, hh) + e;
    const float own = *slot;  // (1.)'s gradient term of chunk c
    *slot = g;
    g = dec * g + own;
  }
  if (a.dstate0 != nullptr) a.dstate0[bh] = g;
}

// ---------------------------------------------------------------------------
// 3. the tile pairs of each chunk, by rows and by columns, over a head group
// ---------------------------------------------------------------------------

// shared bf16: own N-wide rows [TQ][NW] (C_i or B_j), own P-wide rows
// [TQ][PW] (dy_i or xw_j) and their weighted copy (e^{cum_i} dy_i or
// e^{total - cum_j} xw_j), two buffers of the other tile's N-wide and
// P-wide rows (the next pair's arrive while this one's products run), the
// state S or G [P_MAX][NW] (rows of P); then fp32 cum [Q_MAX], the own
// rows' dcum [TQ] and a reduction buffer
constexpr int CHUNK_SMEM = 2 * (3 * TQ * NW + 4 * TQ * PW + P_MAX * NW) +
                           4 * (Q_MAX + TQ + THREADS / 32);

__global__ void __launch_bounds__(THREADS, 2) ssd_bwd_tc_chunk(TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16 *own_n = reinterpret_cast<bf16 *>(smem_raw);
  bf16 *own_p = own_n + TQ * NW;
  bf16 *own_w = own_p + TQ * PW;
  bf16 *oth = own_w + TQ * PW;  // 2 x ([TQ][NW] N-wide, [TQ][PW] P-wide)
  bf16 *st = oth + 2 * TQ * (NW + PW);
  float *cum = reinterpret_cast<float *>(st + P_MAX * NW);
  float *dcum_s = cum + Q_MAX;
  float *red = dcum_s + TQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);
  const int nt = (a.q + TQ - 1) / TQ, qp = nt * TQ;
  // the CTAs with the most tile pairs first (rows: the last tile,
  // columns: the first), then every (b, chunk) and head group
  int idx = blockIdx.x;
  const bool by_rows = (idx & 1) == 0;
  idx >>= 1;
  const int bcg = a.batch * a.nc * a.groups;
  const int rank = idx / bcg;
  idx %= bcg;
  const int t = by_rows ? nt - 1 - rank : rank;
  const int grp = idx % a.groups;
  const int bc = idx / a.groups;  // b * nc + chunk
  const int bb = bc / a.nc, ch = bc % a.nc;
  const long row0 = (long)bc * a.q;
  const int r0 = t * TQ;
  const long hp = (long)a.h * a.p;
  const int h_lo = grp * a.hg, h_hi = min(a.h, h_lo + a.hg);
  const float *cbm = a.cb + (long)bc * qp * qp;
  // this thread's own rows in the chunk (rows i, or columns j)
  const int lr0 = 16 * warp + g, lr1 = lr0 + 8;
  const int gr0 = r0 + lr0, gr1 = r0 + lr1;

  stage(own_n, NW, (by_rows ? a.c : a.b) + row0 * a.n, a.n, r0, a.q, a.n,
        N_MAX);
  cp_async_commit();

  float accn[16][4] = {};  // dC_i (rows) or dB_j (columns), over the heads
  const int o_lo = by_rows ? 0 : t, o_hi = by_rows ? t : nt - 1;
  // the other tile ot of head hh into buffer buf (the caller commits)
  auto stage_other = [&](int buf, int hh, int ot) {
    bf16 *on = oth + buf * TQ * (NW + PW);
    stage(on, NW, (by_rows ? a.b : a.c) + row0 * a.n, a.n, ot * TQ, a.q,
          a.n, N_MAX);
    stage(on + TQ * NW, PW,
          (by_rows ? a.xw : a.dy) + row0 * hp + (long)hh * a.p, hp,
          ot * TQ, a.q, a.p, P_MAX);
  };
  for (int hh = h_lo; hh < h_hi; ++hh) {
    __syncthreads();  // the previous head's tiles and state are consumed
    stage(own_p, PW, (by_rows ? a.dy : a.xw) + row0 * hp + (long)hh * a.p,
          hp, r0, a.q, a.p, P_MAX);
    cp_async_commit();
    stage_other(0, hh, o_lo);  // the first pair's, behind the state terms
    cp_async_commit();
    for (int i = tid; i < Q_MAX; i += THREADS)
      cum[i] = i < a.q ? a.cum[(row0 + i) * a.h + hh] : 0.f;
    {
      // S entering the chunk (rows) or G of the state it leaves (columns)
      const float *src = by_rows
                             ? a.states + state_at(a, bb, ch, a.nc + 1, hh)
                             : a.grads + state_at(a, bb, ch, a.nc, hh);
      for (int e = tid; e < P_MAX * N_MAX; e += THREADS) {
        const int pp = e / N_MAX, k = e % N_MAX;
        st[pp * NW + k] = __float2bfloat16(
            pp < a.p && k < a.n ? src[(long)pp * a.n + k] : 0.f);
      }
    }
    cp_async_wait<1>();  // own_p has arrived
    __syncthreads();
    const float total = cum[a.q - 1];
    for (int e = tid; e < TQ * P_MAX; e += THREADS) {
      const int r = e / P_MAX, k = e % P_MAX, gr = r0 + r;
      const float w = gr < a.q ? (by_rows ? expf(cum[gr])
                                          : expf(total - cum[gr]))
                               : 0.f;
      own_w[r * PW + k] = __float2bfloat16(ld_bf(own_p + r * PW + k) * w);
    }
    if (tid < TQ) dcum_s[tid] = 0.f;
    __syncthreads();

    float dc0 = 0.f, dc1 = 0.f;  // dcum partials of rows lr0, lr1
    float accp[8][4] = {};       // dxw_j of this head (columns)
    const float w0 = gr0 < a.q ? (by_rows ? expf(cum[gr0])
                                          : expf(total - cum[gr0]))
                               : 0.f;
    const float w1 = gr1 < a.q ? (by_rows ? expf(cum[gr1])
                                          : expf(total - cum[gr1]))
                               : 0.f;
    {
      // the state terms: rows, z = C_i S^T and dcum_i's e^{cum_i} dy_i .
      // z_i; columns, u = B_j G^T, dxw_j's e^{total - cum_j} u_j and
      // dcum_j's -xw_j . that
      float z[8][4] = {};
      mma_abt<8, N_MAX>(z, own_n, NW, 16 * warp, st, NW, lane);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lr = e < 2 ? lr0 : lr1, col = 8 * nb + t2 + (e & 1);
          const float w = e < 2 ? w0 : w1;
          const float x = ld_bf(own_p + lr * PW + col);
          if (by_rows) {
            (e < 2 ? dc0 : dc1) += w * z[nb][e] * x;
          } else {
            accp[nb][e] = w * z[nb][e];
            (e < 2 ? dc0 : dc1) -= x * accp[nb][e];
          }
        }
      // dC_i += (e^{cum_i} dy_i) S, or dB_j += (e^{total - cum_j} xw_j) G
      mma_ab<16, P_MAX>(accn, own_w, PW, 16 * warp, st, NW, lane);
    }

    for (int ot = o_lo; ot <= o_hi; ++ot) {
      const int o0 = ot * TQ, buf = (ot - o_lo) & 1;
      const bf16 *oth_n = oth + buf * TQ * (NW + PW);
      const bf16 *oth_p = oth_n + TQ * NW;
      __syncthreads();  // the other buffer's last pair is consumed
      if (ot < o_hi) {
        stage_other(buf ^ 1, hh, ot + 1);
        cp_async_commit();
        cp_async_wait<1>();  // this pair's tiles have arrived
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      // Y = dy_i xw_j^T (rows) or xw_j dy_i^T (columns): own x other, then
      // M = L Y and (columns) C B^T L as bf16 pairs, the A operands
      float y[8][4] = {};
      uint32_t mp[8][2], clp[8][2];
      mma_abt<8, P_MAX>(y, own_p, PW, 16 * warp, oth_p, PW, lane);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float m[2] = {0.f, 0.f}, xl[2] = {0.f, 0.f};
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int go = o0 + 8 * nb + t2 + c;
            const int gown = hf ? gr1 : gr0;
            const int gi = by_rows ? gown : go, gj = by_rows ? go : gown;
            if (gj <= gi && gi < a.q) {
              const float cbv = cbm[(long)gi * qp + gj];
              const float l = expf(cum[gi] - cum[gj]);
              m[c] = l * y[nb][2 * hf + c];
              xl[c] = cbv * l;
              (hf ? dc1 : dc0) += by_rows ? cbv * m[c] : -cbv * m[c];
            }
          }
          mp[nb][hf] = pack_bf16(m[0], m[1]);
          clp[nb][hf] = pack_bf16(xl[0], xl[1]);
        }
      // dC_i += M B_j (rows); dB_j += M^T C_i, dxw_j += (C B^T L)^T dy_i
      mma_rb<16>(accn, mp, oth_n, NW, lane);
      if (!by_rows) mma_rb<8>(accp, clp, oth_p, PW, lane);
    }

    // this head's dcum half (and, for the last tile's columns, e^{total}'s
    // <G, S'> at row Q - 1), and its dxw_j
    dc0 = quad_sum(dc0);
    dc1 = quad_sum(dc1);
    if (lane % 4 == 0) {
      dcum_s[lr0] = dc0;
      dcum_s[lr1] = dc1;
    }
    if (!by_rows && t == nt - 1) {
      const float *gm = a.grads + state_at(a, bb, ch, a.nc, hh);
      const float *so = a.states + state_at(a, bb, ch + 1, a.nc + 1, hh);
      float part = 0.f;
      for (int e = tid; e < a.p * a.n; e += THREADS) part += gm[e] * so[e];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) red[warp] = part;
    }
    __syncthreads();
    if (!by_rows && t == nt - 1 && tid == 0) {
      float sum = 0.f;
      for (int i = 0; i < THREADS / 32; ++i) sum += red[i];
      dcum_s[a.q - 1 - r0] += sum;
    }
    __syncthreads();
    float *half = a.dcum2 + (by_rows ? 0 : (long)a.batch * a.nc * a.q * a.h);
    if (tid < TQ && r0 + tid < a.q)
      half[(row0 + r0 + tid) * a.h + hh] = dcum_s[tid];
    if (!by_rows) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int gr = hf ? gr1 : gr0, pp = 8 * nb + t2;
          if (gr < a.q && pp < a.p)
            *reinterpret_cast<uint32_t *>(
                a.dxw + ((row0 + gr) * a.h + hh) * a.p + pp) =
                pack_bf16(accp[nb][2 * hf], accp[nb][2 * hf + 1]);
        }
    }
  }
  cp_async_wait<0>();  // a CTA without heads leaves no copy in flight

  // this head group's part of dC (rows) or dB (columns)
  float *part = (by_rows ? a.dcg : a.dbg) +
                ((long)bc * a.groups + grp) * a.q * a.n;
#pragma unroll
  for (int nb = 0; nb < 16; ++nb)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int gr = hf ? gr1 : gr0, nn = 8 * nb + t2;
      if (gr < a.q && nn < a.n)
        *reinterpret_cast<float2 *>(part + (long)gr * a.n + nn) =
            make_float2(accn[nb][2 * hf], accn[nb][2 * hf + 1]);
    }
}

// ---------------------------------------------------------------------------
// 4. dB and dC over the head groups in order, dcum's halves
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(PASS_THREADS) ssd_bwd_tc_reduce(TcArgs a) {
  const long qn = (long)a.q * a.n, qh = (long)a.q * a.h;
  const long e = (long)blockIdx.x * PASS_THREADS + threadIdx.x;
  const long bc = blockIdx.y;
  if (e < qn) {
    const float *pb = a.dbg + bc * a.groups * qn + e;
    const float *pc = a.dcg + bc * a.groups * qn + e;
    float sb = 0.f, sc = 0.f;
    for (int gg = 0; gg < a.groups; ++gg) {
      sb += pb[gg * qn];
      sc += pc[gg * qn];
    }
    a.db[bc * qn + e] = __float2bfloat16(sb);
    a.dc[bc * qn + e] = __float2bfloat16(sc);
  }
  if (e < qh) {
    const long half = (long)a.batch * a.nc * qh;
    a.dcum[bc * qh + e] = a.dcum2[bc * qh + e] + a.dcum2[half + bc * qh + e];
  }
}

template <typename K>
cudaError_t launch(K kern, dim3 grid, int threads, size_t smem,
                   const TcArgs &a, cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 xw, B, C, dy (every row start 16-byte aligned); fp32 cum, state0,
// dstate (the last two may be null: zeros) and dstate0 (null: skipped).
// Workspaces the wrapper allocates: states (B, NC + 1, H, P, N), grads
// (B, NC, H, P, N), cb (B, NC, Qp, Qp) with Qp = Q rounded up to 64, dbg and
// dcg (B, NC, groups, Q, N), dcum2 (2, B, NC, Q, H), all fp32; hg heads a
// group, groups = ceil(H / hg).
int ssd_scan_bwd_tc(const void *xw, const float *cum, const void *b,
                    const void *c, const float *state0, const void *dy,
                    const float *dstate, void *dxw, float *dcum, void *db,
                    void *dc, float *dstate0, float *states, float *grads,
                    float *cb, float *dbg, float *dcg, float *dcum2,
                    int batch, int nc, int q, int h, int p, int n, int hg,
                    void *stream) {
  if (batch < 1 || nc < 1 || q < 1 || q > Q_MAX || h < 1 || p < 8 ||
      p > P_MAX || p % 8 != 0 || n < 8 || n > N_MAX || n % 8 != 0 ||
      hg < 1)
    return (int)cudaErrorInvalidValue;
  const int groups = (h + hg - 1) / hg;
  TcArgs a{static_cast<const bf16 *>(xw), static_cast<const bf16 *>(b),
           static_cast<const bf16 *>(c),  static_cast<const bf16 *>(dy),
           cum,                           state0,
           dstate,                        static_cast<bf16 *>(dxw),
           static_cast<bf16 *>(db),       static_cast<bf16 *>(dc),
           dcum,                          dstate0,
           states,                        grads,
           cb,                            dbg,
           dcg,                           dcum2,
           batch,                         nc,
           q,                             h,
           p,                             n,
           hg,                            groups};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = (q + TQ - 1) / TQ;
  const unsigned n_cb = (unsigned)(batch * nc * (nt * (nt + 1) / 2));
  cudaError_t e = launch(ssd_bwd_tc_local, dim3(n_cb + batch * nc * h * 2),
                         THREADS, LOCAL_SMEM, a, s);
  if (e != cudaSuccess) return (int)e;
  const long pn = (long)p * n;
  e = launch(ssd_bwd_tc_pass,
             dim3((unsigned)((pn + PASS_THREADS - 1) / PASS_THREADS),
                  (unsigned)(batch * h)),
             PASS_THREADS, 0, a, s);
  if (e != cudaSuccess) return (int)e;
  e = launch(ssd_bwd_tc_chunk, dim3((unsigned)(batch * nc * groups * nt * 2)),
             THREADS, CHUNK_SMEM, a, s);
  if (e != cudaSuccess) return (int)e;
  const long wide = (long)q * (n > h ? n : h);
  return (int)launch(ssd_bwd_tc_reduce,
                     dim3((unsigned)((wide + PASS_THREADS - 1) / PASS_THREADS),
                          (unsigned)(batch * nc)),
                     PASS_THREADS, 0, a, s);
}

}  // extern "C"
