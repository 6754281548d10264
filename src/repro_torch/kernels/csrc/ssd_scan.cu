// Hand-written Hopper (sm_90a) kernels of the Mamba-2 SSD chunk scan, behind
// the same plain C interface as attention.cu (loaded with ctypes by
// repro_torch/kernels/build.py). They launch on the stream they are given,
// allocate nothing, and ssd_scan_fwd returns cudaGetLastError() after its
// launches, or cudaErrorInvalidValue for sizes it does not hold (Q > 256,
// N > 128, a P slice other than 16, 32 or 64).
//
// ssd_scan_fwd
//   Replaces src/repro/kernels/ssd_scan.py:66 `ssd_scan` (pl.pallas_call at
//   :79). Per (batch row b, head h) the scan walks the chunks in order and
//   carries the state S (N x P, fp32); per chunk of Q rows, with cum the
//   within-chunk cumulative log decay and total = cum[Q-1]:
//     y_i   = sum_{j<=i} (C_i . B_j) e^{cum_i - cum_j} xw_j   (intra)
//           + e^{cum_i} C_i S                                 (inter)
//     S    <- e^{total} S + sum_j B_j^T e^{total - cum_j} xw_j
//   Inputs xw (B, NC, Q, H, P), B and C (B, NC, Q, N) in fp32 or bf16, cum
//   (B, NC, Q, H) fp32, and optionally the state entering the first chunk,
//   state0 (B, H, P, N) fp32 (zeros without it: a chunk of a prompt
//   continues from the state the chunks before it left); outputs y in xw's
//   layout and dtype and the final state (B, H, P, N) fp32, written from
//   shared memory. The dtype picks the body.
//
//   Bound on an H100: bytes, narrowly. Per row and chunk C B^T is 2 Q^2 N
//   operations, shared by the heads, and each head adds 2 Q^2 P + 4 Q N P;
//   at Mamba-2-2.7B's shapes (H = 80, P = 64, N = 128, Q = 256) that is
//   about 5.4 GFLOP per 1000-token prompt against 24 MB moved (xw and y,
//   B, C, cum, the state), 5.5 us at the bf16 tensor-core rate and 7.3 us
//   at 3.35 TB/s.
//
//   fp32 body (ssd_scan_kernel): one CTA of 256 threads per (b, h, slice of
//   PC = 32 columns of P). The CTA keeps its N x PC state slice in shared
//   memory (16 KB) across the chunk loop. The Q x Q decay-masked score
//   matrix does not fit (256 KB in fp32 at Q = 256), so it is tiled as
//   flash attention tiles its scores, without a softmax: for each tile of
//   TQ = 64 output rows, the inter term is read from the old state first,
//   then the column tiles up to the diagonal add their decayed scores times
//   xw. Only after every row tile has read the old state (a
//   __syncthreads()) does a second pass over the chunk's rows add
//   B^T (e^{total - cum} xw) to the decayed state. Every product runs on the
//   CUDA cores in fp32, each thread a small register tile over padded
//   shared-memory rows. It is limited by that arithmetic, and by C B^T
//   recomputed in every CTA; it stays so the fp32 results stay exact.
//
//   bf16 body: three launches, every product on the tensor cores
//   (mma.sync m16n8k16, bf16 operands, fp32 accumulators), chunk-parallel as
//   the Mamba-2 paper's SSD (arXiv:2405.21060, section 6) and as the JAX
//   op's recovery of the final state (src/repro/kernels/ops.py:191-201):
//   1. ssd_state_kernel: C B^T once per (row, chunk), since it depends on
//      neither the head nor P: SSD_TILE x SSD_TILE tiles of the lower
//      triangle, fp32, into the caller's workspace cb (B, NC, Qp, Qp), Qp
//      = Q rounded up to SSD_TILE, zero past Q (C and B are exact in bf16,
//      so this is C B^T up to fp32 summation order). Beside those tiles, in
//      the same grid, the chunk states: per (b, chunk, head, 64 columns of
//      P), the state the chunk alone leaves, dS = B^T V with V = xw
//      e^{total - cum} split into V_hi = bf16(V) and V_lo = bf16(V - V_hi)
//      (one bf16 rounding of V would cost about 2^-9 of the state, the
//      pair about 2^-17), fp32 into the workspace ws (B, NC, H, P, N).
//   2. ssd_pass_kernel: per element of each (b, h) state, the sequential
//      pass S <- e^{total} S + dS over the chunks; the state entering each
//      chunk goes to the workspace ws16 in bf16, and the last is the final
//      state.
//   3. ssd_out_kernel<PSL>: per (b, chunk, head, PSL columns of P), the
//      inter term e^{cum_i} C_i S16 (S16 the entering state in bf16) and
//      the intra term: the cb blocks read from L2, times e^{cum_i - cum_j}
//      (zero above the diagonal) in registers, rounded to bf16 as the A
//      operand, times xw. Rounding C B^T (.) L and S to bf16 are the only
//      roundings the y path adds (y is written in bf16).
//   The recurrence left to run in order is an elementwise pass over NC
//   states, so every chunk's products run at once on the whole card, where
//   a walk over the chunks in one CTA per (b, h, slice of P) keeps 80 CTAs
//   busy at B = 1 and waits on each chunk's loads in turn (PERF.md).
//   repro_torch/kernels/ref.py:ssd_scan_tc_ref is this arithmetic, plainly.
//   PSL (16, 32 or 64) and SSD_TILE come from the build (geometry.py); the
//   caller may pick another of the three PSL.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention.cuh"

#if !defined(SSD_TILE) || !defined(SSD_P_SLICE)
#error "SSD_TILE, SSD_P_SLICE come from the build (geometry.py)"
#endif

using bullet::from_f;
using bullet::to_f;

namespace {

constexpr int SSD_THREADS = 256;
constexpr int TQ = 64;          // rows of a chunk per row / column tile
constexpr int PC = 32;          // columns of P per CTA
constexpr int N_MAX = 128;      // state size the shared buffers hold
constexpr int Q_MAX = 256;      // chunk length the cum buffer holds
constexpr int NS = N_MAX + 1;   // padded row stride of the B and C tiles
constexpr int SS = TQ + 1;      // padded row stride of the score tile

// shared floats: state slice [N_MAX][PC], cum [Q_MAX], C tile [TQ][NS],
// B tile [TQ][NS], xw tile [TQ][PC], score tile [TQ][SS]
constexpr int SSD_SMEM_FLOATS =
    N_MAX * PC + Q_MAX + 2 * TQ * NS + TQ * PC + TQ * SS;

struct SsdArgs {
  const void *xw, *b, *c;
  const float *cum;
  void *y;
  float *state;
  const float *state0;  // the state entering chunk 0 (B, H, P, N), or null
  int batch, nc, q, h, p, n;
};

// rows [row, row + rows) of a (.., N) matrix into a [TQ][NS] tile as fp32,
// zeros past `rows` and past n
template <typename T>
__device__ void load_bc(float *dst, const T *src, long row, int rows,
                        int n) {
  for (int i = threadIdx.x; i < TQ * N_MAX; i += SSD_THREADS) {
    const int r = i / N_MAX, k = i % N_MAX;
    dst[r * NS + k] =
        (r < rows && k < n) ? to_f(src[(row + r) * n + k]) : 0.f;
  }
}

// rows [j0, j0 + rows) of this chunk's xw, columns [p0, p0 + pc) of head
// hh, into a [TQ][PC] tile as fp32; with `decay`, row j is scaled by
// e^{total - cum[j0 + j]} (the state pass)
template <typename T>
__device__ void load_xw(float *dst, const T *xw, long row0, int j0, int rows,
                        int hh, int p0, int pc, const SsdArgs &a,
                        const float *cum, bool decay, float total) {
  for (int i = threadIdx.x; i < TQ * PC; i += SSD_THREADS) {
    const int j = i / PC, c = i % PC;
    float v = 0.f;
    if (j < rows && c < pc) {
      v = to_f(xw[(row0 + j0 + j) * a.h * a.p + (long)hh * a.p + p0 + c]);
      if (decay) v *= expf(total - cum[j0 + j]);
    }
    dst[j * PC + c] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(SSD_THREADS, 2)
    ssd_scan_kernel(SsdArgs a) {
  extern __shared__ float smem[];
  float *st = smem;                   // [N_MAX][PC] state slice, S^T
  float *cum = st + N_MAX * PC;       // [Q_MAX]
  float *ct = cum + Q_MAX;            // [TQ][NS] C rows of the row tile
  float *bt = ct + TQ * NS;           // [TQ][NS] B rows of the column tile
  float *xt = bt + TQ * NS;           // [TQ][PC] xw rows of the column tile
  float *sc = xt + TQ * PC;           // [TQ][SS] decayed scores

  const int tid = threadIdx.x;
  const int n_split = (a.p + PC - 1) / PC;
  const int split = blockIdx.x % n_split;
  const int hh = (blockIdx.x / n_split) % a.h;
  const int bb = blockIdx.x / (n_split * a.h);
  const int p0 = split * PC;
  const int pc = min(PC, a.p - p0);
  const int q = a.q, n = a.n;
  const T *xw = static_cast<const T *>(a.xw);
  const T *bm = static_cast<const T *>(a.b);
  const T *cm = static_cast<const T *>(a.c);
  T *y = static_cast<T *>(a.y);

  // register tiles: y rows ar + {0,1} x cols ac + {0..3}; scores rows
  // sr + {0..3} x cols sj + 16 {0..3}; state rows sn + {0..3} x ac + {0..3}
  const int ar = (tid >> 3) * 2, ac = (tid & 7) * 4;
  const int sr = (tid >> 4) * 4, sj = tid & 15;
  const int sn = (tid >> 3) * 4;

  // the starting state's slice (zeros without one, and past n and pc)
  for (int i = tid; i < N_MAX * PC; i += SSD_THREADS) {
    const int k = i / PC, c = i % PC;
    st[i] = a.state0 != nullptr && k < n && c < pc
                ? a.state0[(((long)bb * a.h + hh) * a.p + p0 + c) * n + k]
                : 0.f;
  }
  const int n_tiles = (q + TQ - 1) / TQ;

  for (int ch = 0; ch < a.nc; ++ch) {
    const long row0 = ((long)bb * a.nc + ch) * q;   // chunk's first row
    __syncthreads();                  // the last chunk's readers are done
    for (int i = tid; i < q; i += SSD_THREADS)
      cum[i] = a.cum[(row0 + i) * a.h + hh];
    __syncthreads();
    const float total = cum[q - 1];

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * TQ;
      load_bc(ct, cm, row0 + i0, min(TQ, q - i0), n);
      __syncthreads();
      // inter: e^{cum_i} C_i S, from the state of the previous chunks
      float acc[2][4] = {};
      for (int k = 0; k < n; ++k) {
        const float c0 = ct[ar * NS + k], c1 = ct[(ar + 1) * NS + k];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float s = st[k * PC + ac + x];
          acc[0][x] += c0 * s;
          acc[1][x] += c1 * s;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int gi = i0 + ar + r;
        const float d = gi < q ? expf(cum[gi]) : 0.f;
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[r][x] *= d;
      }
      // intra: column tiles up to the diagonal
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TQ, jn = min(TQ, q - j0);
        __syncthreads();              // the last pair's readers are done
        load_bc(bt, bm, row0 + j0, jn, n);
        load_xw(xt, xw, row0, j0, jn, hh, p0, pc, a, cum, false, 0.f);
        __syncthreads();
        float s[4][4] = {};
        for (int k = 0; k < n; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) cv[u] = ct[(sr + u) * NS + k];
#pragma unroll
          for (int v = 0; v < 4; ++v) bv[v] = bt[(sj + 16 * v) * NS + k];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) s[u][v] += cv[u] * bv[v];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int gi = i0 + sr + u, gj = j0 + sj + 16 * v;
            sc[(sr + u) * SS + sj + 16 * v] =
                (gj <= gi && gi < q) ? s[u][v] * expf(cum[gi] - cum[gj])
                                     : 0.f;
          }
        __syncthreads();
        for (int j = 0; j < jn; ++j) {
          const float s0 = sc[ar * SS + j], s1 = sc[(ar + 1) * SS + j];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float xv = xt[j * PC + ac + x];
            acc[0][x] += s0 * xv;
            acc[1][x] += s1 * xv;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int gi = i0 + ar + r;
        if (gi >= q) continue;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int c = ac + x;
          if (c < pc)
            y[(row0 + gi) * a.h * a.p + (long)hh * a.p + p0 + c] =
                from_f<T>(acc[r][x]);
        }
      }
      __syncthreads();                // before the next tile overwrites ct
    }

    // state pass: sum_j B_j^T (e^{total - cum_j} xw_j) over the chunk
    float up[4][4] = {};
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * TQ, jn = min(TQ, q - j0);
      __syncthreads();
      load_bc(bt, bm, row0 + j0, jn, n);
      load_xw(xt, xw, row0, j0, jn, hh, p0, pc, a, cum, true, total);
      __syncthreads();
      for (int j = 0; j < jn; ++j) {
        float bv[4], xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) bv[u] = bt[j * NS + sn + u];
#pragma unroll
        for (int x = 0; x < 4; ++x) xv[x] = xt[j * PC + ac + x];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int x = 0; x < 4; ++x) up[u][x] += bv[u] * xv[x];
      }
    }
    // every row of the chunk has read the old state: update it
    __syncthreads();
    const float decay = expf(total);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float &s = st[(sn + u) * PC + ac + x];
        s = decay * s + up[u][x];
      }
  }
  __syncthreads();
  // final state (B, H, P, N) fp32, straight from shared memory
  for (int i = tid; i < pc * n; i += SSD_THREADS) {
    const int c = i / n, k = i % n;
    a.state[(((long)bb * a.h + hh) * a.p + p0 + c) * n + k] = st[k * PC + c];
  }
}

template <typename T>
int launch_ssd(const SsdArgs &a, cudaStream_t s) {
  const size_t smem = sizeof(float) * SSD_SMEM_FLOATS;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = a.batch * a.h * ((a.p + PC - 1) / PC);
  ssd_scan_kernel<T><<<blocks, SSD_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 body: C B^T and the chunk states, the pass, the outputs
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using bullet::cp_async16;
using bullet::cp_async_commit;
using bullet::cp_async_wait;
using bullet::ldsm_x4;
using bullet::ldsm_x4_t;
using bullet::mma_16816;
using bullet::pack_bf16;
using bullet::smem_u32;

static_assert(SSD_TILE % 16 == 0 && SSD_TILE <= 128, "SSD_TILE");
static_assert(SSD_P_SLICE == 16 || SSD_P_SLICE == 32 || SSD_P_SLICE == 64,
              "SSD_P_SLICE");

constexpr int BCS = N_MAX + 8;  // padded bf16 row of B, C or the state: the
                                // 8 row addresses of an ldmatrix in
                                // distinct banks

__device__ __forceinline__ bool aligned(const void *p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// this lane's row address, as an offset, for an ldmatrix x4 of:
// a B operand held [k][n] (row stride ld; .trans): rows k0 .. k0 + 15,
// column blocks nb and nb + 1
__device__ __forceinline__ int trans_b_off(int k0, int nb, int ld, int lane) {
  return (k0 + lane % 8 + 8 * ((lane / 8) % 2)) * ld + 8 * (nb + lane / 16);
}
// a B operand held [n][k] (no .trans): row blocks nb and nb + 1, columns
// k0 .. k0 + 15
__device__ __forceinline__ int nontrans_b_off(int k0, int nb, int ld,
                                              int lane) {
  return (8 * (nb + lane / 16) + lane % 8) * ld + k0 + 8 * ((lane / 8) % 2);
}
// an A operand held [k][m] (.trans): rows k0 .. k0 + 15, columns m0 .. +15
__device__ __forceinline__ int trans_a_off(int k0, int m0, int ld, int lane) {
  return (k0 + 8 * (lane / 16) + lane % 8) * ld + m0 + 8 * ((lane / 8) % 2);
}

// rows [r0, r0 + R) of a row-major bf16 matrix (leading dimension ld) into
// dst [R][ds]: columns [0, w) from src, zeros for columns [w, wp) and for
// rows at or past `rows`, by the NT threads numbered tid. 16-byte cp.async
// copies where `vec` (every row start 16-byte aligned, w a multiple of 8;
// the caller commits), else element by element.
template <int NT>
__device__ void stage_rows(bf16 *dst, int ds, const bf16 *src, long ld,
                           int r0, int R, int rows, int w, int wp, bool vec,
                           int tid) {
  if (vec) {
    const int groups = wp / 8;
    for (int i = tid; i < R * groups; i += NT) {
      const int r = i / groups, c = (i % groups) * 8;
      bf16 *d = dst + r * ds + c;
      if (r0 + r < rows && c < w)
        cp_async16(smem_u32(d), src + (long)(r0 + r) * ld + c);
      else
        *reinterpret_cast<uint4 *>(d) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = tid; i < R * wp; i += NT) {
      const int r = i / wp, c = i % wp;
      dst[r * ds + c] = (r0 + r < rows && c < w)
                            ? src[(long)(r0 + r) * ld + c]
                            : __float2bfloat16(0.f);
    }
  }
}

// Every bf16 kernel runs 4 warps; a C B^T tile is 16 rows a warp
constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
static_assert(SSD_TILE == 16 * TC_WARPS, "a warp per 16 rows of a tile");
constexpr int KT = 64;       // chunk rows per stage of a chunk-state CTA
constexpr int PB = 64;       // columns of P per chunk-state CTA
constexpr int XB = PB + 8;   // its padded bf16 row of xw

// C B^T tile t (of the lower triangle, in row order) of chunk bc = b NC + c:
// cb[bc, i, j] = C_i . B_j; rows and columns past Q are zero
__device__ void cb_tile(const SsdArgs &a, float *cb, long bc, int t,
                        bf16 *smem) {
  bf16 *cs = smem, *bs = smem + SSD_TILE * BCS;
  const int nt = (a.q + SSD_TILE - 1) / SSD_TILE, qp = nt * SSD_TILE;
  int tj = t, ti = 0;
  while (tj > ti) tj -= ++ti;
  const int n = a.n, nk = (n + 15) & ~15;
  const bf16 *cm = static_cast<const bf16 *>(a.c) + bc * a.q * n;
  const bf16 *bm = static_cast<const bf16 *>(a.b) + bc * a.q * n;
  const bool vec = n % 8 == 0 && aligned(a.b, 16) && aligned(a.c, 16);
  stage_rows<TC_THREADS>(cs, BCS, cm, n, ti * SSD_TILE, SSD_TILE, a.q, n, nk,
                         vec, threadIdx.x);
  stage_rows<TC_THREADS>(bs, BCS, bm, n, tj * SSD_TILE, SSD_TILE, a.q, n, nk,
                         vec, threadIdx.x);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int NB = SSD_TILE / 8;
  float acc[NB][4] = {};
  for (int kk = 0; kk < nk; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, smem_u32(cs + (16 * warp + lane % 16) * BCS + kk +
                         8 * (lane / 16)));
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, smem_u32(bs + nontrans_b_off(kk, nb, BCS, lane)));
      mma_16816(acc[nb], af, bf[0], bf[1]);
      mma_16816(acc[nb + 1], af, bf[2], bf[3]);
    }
  }
  const int g = lane / 4, t2 = 2 * (lane % 4);
  float *out = cb + (bc * qp + ti * SSD_TILE + 16 * warp + g) * qp +
               tj * SSD_TILE + t2;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    *reinterpret_cast<float2 *>(out + 8 * nb) =
        make_float2(acc[nb][0], acc[nb][1]);
    *reinterpret_cast<float2 *>(out + 8 * qp + 8 * nb) =
        make_float2(acc[nb][2], acc[nb][3]);
  }
}

// dynamic shared memory of ssd_state_kernel: two stages of B [KT][BCS] and
// xw [KT][XB], then the fp32 decays e^{total - cum} [Q_MAX]; a C B^T
// tile's C and B rows [SSD_TILE][BCS] fit in it
constexpr size_t STATE_SMEM = 2 * 2 * KT * (BCS + XB) + 4 * Q_MAX;
static_assert(2 * 2 * SSD_TILE * BCS <= STATE_SMEM, "cb tile fits");

// hi and lo bf16 pairs of (x0 d0, x1 d1), x a bf16 pair
__device__ __forceinline__ void split_pair(uint32_t x, float d0, float d1,
                                          uint32_t &hi, uint32_t &lo) {
  const float2 v = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162 *>(&x));
  const float v0 = v.x * d0, v1 = v.y * d1;
  hi = pack_bf16(v0, v1);
  const float2 h =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(&hi));
  lo = pack_bf16(v0 - h.x, v1 - h.y);
}

// The chunk state of (b, c, h, 64 columns of P), the state that chunk
// alone would leave: dS = B^T (xw e^{total - cum}) over its rows, with
// V = xw e^{total - cum} carried as V_hi + V_lo, written fp32 (P, N) to
// ws[b, c, h]. The product runs transposed, dS^T = V^T B: each warp takes
// its V^T fragments from xw through ldmatrix.trans and splits them in
// registers (the decays are per row of the chunk, so per k of the
// product); B comes through ldmatrix.trans. The accumulators are rows of
// P.
__device__ void chunk_state(const SsdArgs &a, float *ws, int item,
                            bf16 *smem) {
  const int npb = (a.p + PB - 1) / PB;
  const int pblk = item % npb, hh = (item / npb) % a.h;
  const long bc = item / (npb * a.h);
  const int p0 = pblk * PB, pc = min(PB, a.p - p0);
  const int q = a.q, n = a.n, nk = (n + 15) & ~15;
  const int nkt = (q + KT - 1) / KT;
  const long hp = (long)a.h * a.p, row0 = bc * q;
  const bf16 *xw = static_cast<const bf16 *>(a.xw);
  const bf16 *bm = static_cast<const bf16 *>(a.b);
  const bool vec_x = a.p % 8 == 0 && aligned(xw, 16);
  const bool vec_b = n % 8 == 0 && aligned(bm, 16);
  float *dec = reinterpret_cast<float *>(smem + 2 * KT * (BCS + XB));
  auto bsm = [&](int s) { return smem + s * KT * (BCS + XB); };
  auto xsm = [&](int s) { return bsm(s) + KT * BCS; };
  auto stage = [&](int kt) {
    const int s = kt % 2;
    stage_rows<TC_THREADS>(bsm(s), BCS, bm + row0 * n, n, kt * KT, KT, q, n,
                           nk, vec_b, threadIdx.x);
    stage_rows<TC_THREADS>(xsm(s), XB, xw + row0 * hp + (long)hh * a.p + p0,
                           hp, kt * KT, KT, q, pc, PB, vec_x, threadIdx.x);
  };
  stage(0);
  cp_async_commit();
  if (nkt > 1) stage(1);
  cp_async_commit();
  // the decays e^{total - cum_j} of the chunk's rows (1 past Q, where xw
  // is 0), once per row, their loads issued together
  {
    const float total = a.cum[(row0 + q - 1) * a.h + hh];
    float c[Q_MAX / TC_THREADS];
#pragma unroll
    for (int u = 0; u < Q_MAX / TC_THREADS; ++u) {
      const int i = threadIdx.x + u * TC_THREADS;
      c[u] = i < q ? a.cum[(row0 + i) * a.h + hh] : total;
    }
#pragma unroll
    for (int u = 0; u < Q_MAX / TC_THREADS; ++u)
      dec[threadIdx.x + u * TC_THREADS] = expf(total - c[u]);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);
  constexpr int NB = N_MAX / 8;
  float acc[NB][4] = {};
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<1>();  // stage kt has landed
    __syncthreads();
    const bf16 *xs = xsm(kt % 2), *bs = bsm(kt % 2);
    if (16 * warp < pc) {  // rows 16 warp .. + 15 of P
#pragma unroll
      for (int k0 = 0; k0 < KT; k0 += 16) {
        // V^T rows 16 warp + g (+ 8), columns (rows of the chunk) k0 + t2
        // (+ 1) and k0 + t2 + 8 (+ 9)
        uint32_t x[4], ah[4], al[4];
        ldsm_x4_t(x, smem_u32(xs + trans_a_off(k0, 16 * warp, XB, lane)));
        const float *d = dec + kt * KT + k0 + t2;
        split_pair(x[0], d[0], d[1], ah[0], al[0]);
        split_pair(x[1], d[0], d[1], ah[1], al[1]);
        split_pair(x[2], d[8], d[9], ah[2], al[2]);
        split_pair(x[3], d[8], d[9], ah[3], al[3]);
#pragma unroll
        for (int nb = 0; nb < NB; nb += 2) {
          if (8 * nb >= nk) break;
          uint32_t bf[4];
          ldsm_x4_t(bf, smem_u32(bs + trans_b_off(k0, nb, BCS, lane)));
          mma_16816(acc[nb], ah, bf[0], bf[1]);
          mma_16816(acc[nb + 1], ah, bf[2], bf[3]);
          mma_16816(acc[nb], al, bf[0], bf[1]);
          mma_16816(acc[nb + 1], al, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // every warp has read stage kt
    if (kt + 2 < nkt) stage(kt + 2);
    cp_async_commit();
  }
  // dS rows p0 + 16 warp + g (+ 8), columns 8 nb + t2 (+ 1)
  float *w = ws + ((bc * a.h + hh) * a.p + p0 + 16 * warp + g) * n;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int k = 8 * nb + t2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + g + 8 * (e / 2), kc = k + e % 2;
      if (r < pc && kc < n) w[8 * (e / 2) * n + kc] = acc[nb][e];
    }
  }
}

// Launch 1: the C B^T tiles of every (b, chunk), then the chunk states of
// every (b, chunk, head, 64 columns of P); neither reads the other
__global__ void __launch_bounds__(TC_THREADS, 3)
    ssd_state_kernel(SsdArgs a, float *cb, float *ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16 *smem = reinterpret_cast<bf16 *>(smem_raw);
  const int nt = (a.q + SSD_TILE - 1) / SSD_TILE;
  const int ntri = nt * (nt + 1) / 2;
  const int n_cb = a.batch * a.nc * ntri;
  if ((int)blockIdx.x < n_cb)
    cb_tile(a, cb, blockIdx.x / ntri, blockIdx.x % ntri, smem);
  else
    chunk_state(a, ws, blockIdx.x - n_cb, smem);
}

// Launch 2: the pass over the chunks, PASS_ELEMS elements of a (b, h)
// state a thread: S_0 = state0 (zeros without one), S_{c+1} = e^{total_c}
// S_c + dS_c, four chunks' dS and totals read ahead of their use. The
// state entering chunk c goes to ws16 in bf16 (B, NC, H, P, N), so chunk
// 0's inter term reads bf16(state0); the last is the final state (B, H,
// P, N).
constexpr int PASS_THREADS = 256, PASS_ELEMS = 4;
__global__ void __launch_bounds__(PASS_THREADS)
    ssd_pass_kernel(SsdArgs a, const float *__restrict__ ws,
                    bf16 *__restrict__ ws16) {
  const long pn = (long)a.p * a.n;
  const long e0 =
      ((long)blockIdx.x * PASS_THREADS + threadIdx.x) * PASS_ELEMS;
  if (e0 >= pn) return;
  const int bb = blockIdx.y / a.h, hh = blockIdx.y % a.h;
  const int ne = (int)min((long)PASS_ELEMS, pn - e0);
  float s[PASS_ELEMS];
#pragma unroll
  for (int k = 0; k < PASS_ELEMS; ++k)
    s[k] = a.state0 != nullptr && k < ne ? a.state0[blockIdx.y * pn + e0 + k]
                                         : 0.f;
  for (int c0 = 0; c0 < a.nc; c0 += 4) {
    float d[4][PASS_ELEMS], t[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long bc = (long)bb * a.nc + c0 + u;
      const bool in = c0 + u < a.nc;
      t[u] = in ? a.cum[((bc + 1) * a.q - 1) * a.h + hh] : 0.f;
#pragma unroll
      for (int k = 0; k < PASS_ELEMS; ++k)
        d[u][k] = in && k < ne ? ws[(bc * a.h + hh) * pn + e0 + k] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u >= a.nc) break;
      const long bc = (long)bb * a.nc + c0 + u;
      const float dec = expf(t[u]);
#pragma unroll
      for (int k = 0; k < PASS_ELEMS; ++k) {
        if (k < ne)
          ws16[(bc * a.h + hh) * pn + e0 + k] = __float2bfloat16(s[k]);
        s[k] = dec * s[k] + d[u][k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PASS_ELEMS; ++k)
    if (k < ne) a.state[blockIdx.y * pn + e0 + k] = s[k];
}

// y pair (columns c, c + 1 of the slice, pc of them live) in bf16
__device__ __forceinline__ void y_pair(bf16 *dst, float v0, float v1, int c,
                                       int pc, bool pairs) {
  if (c + 1 < pc && pairs) {
    *reinterpret_cast<uint32_t *>(dst) = pack_bf16(v0, v1);
  } else {
    if (c < pc) dst[0] = __float2bfloat16(v0);
    if (c + 1 < pc) dst[1] = __float2bfloat16(v1);
  }
}

// shared memory of ssd_out_kernel<PSL>: xw [Q_MAX][PSL + 8], the state
// entering the chunk in bf16 [PSL][BCS] (rows of P) and each warp's C rows
// of its strip [16][BCS], then fp32 cum [Q_MAX]
template <int PSL> struct OutSmem {
  static constexpr int XS = PSL + 8;
  static constexpr size_t bytes =
      2 * (Q_MAX * XS + (PSL + 16 * TC_WARPS) * BCS) + 4 * Q_MAX;
};

// Launch 3: the outputs of (b, chunk, head, PSL columns of P). Warp w owns
// the 16-row strips w, 7 - w, 8 + w and 15 - w of the chunk (equal work
// under the triangle); for each, the inter term C_strip S16 (the strip's C
// rows copied into the warp's buffer while it works on the strip before,
// S16 the state entering the chunk in bf16), each row scaled by e^{cum_i},
// then the intra term: per 16 columns up to the diagonal the cb block read
// from L2 two steps ahead, times e^{cum_i - cum_j} (zero above the
// diagonal), rounded to bf16, times xw.
template <int PSL>
__global__ void __launch_bounds__(TC_THREADS, PSL == 64 ? 3 : 4)
    ssd_out_kernel(SsdArgs a, const float *cb, const bf16 *ws16) {
  using O = OutSmem<PSL>;
  constexpr int XS = O::XS, NB = PSL / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16 *xs = reinterpret_cast<bf16 *>(smem_raw);
  bf16 *ss = xs + Q_MAX * XS;
  float *cum = reinterpret_cast<float *>(ss + (PSL + 16 * TC_WARPS) * BCS);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t2 = 2 * (lane % 4);
  const int n_split = (a.p + PSL - 1) / PSL;
  const int split = blockIdx.x % n_split;
  const int hh = (blockIdx.x / n_split) % a.h;
  const long bc = blockIdx.x / (n_split * a.h);  // b * NC + chunk
  const int p0 = split * PSL, pc = min(PSL, a.p - p0);
  const int q = a.q, n = a.n, nk = (n + 15) & ~15, qk = (q + 15) & ~15;
  const int qp = (q + SSD_TILE - 1) / SSD_TILE * SSD_TILE;
  const long hp = (long)a.h * a.p, row0 = bc * q;
  const bf16 *xw = static_cast<const bf16 *>(a.xw);
  const bf16 *cm = static_cast<const bf16 *>(a.c) + row0 * n;
  bf16 *y = static_cast<bf16 *>(a.y);
  bf16 *cw = ss + (PSL + 16 * warp) * BCS;  // this warp's C rows
  const bool vec_x = a.p % 8 == 0 && aligned(xw, 16);
  const bool vec_c = n % 8 == 0 && aligned(a.c, 16);
  const bool y_pairs = a.p % 2 == 0 && aligned(y, 4);
  // warp w's strips: w, 7 - w, 8 + w, 15 - w
  auto strip = [&](int si) {
    return (si % 2 == 0 ? warp : 2 * TC_WARPS - 1 - warp) +
           2 * TC_WARPS * (si / 2);
  };

  // xw rows up to a whole strip (zero past Q), the entering state in bf16
  // (zero past pc rows and n columns), cum (rows past Q repeat the last)
  stage_rows<TC_THREADS>(xs, XS, xw + row0 * hp + (long)hh * a.p + p0, hp, 0,
                         qk, q, pc, PSL, vec_x, tid);
  stage_rows<TC_THREADS>(ss, BCS, ws16 + ((bc * a.h + hh) * a.p + p0) * n, n,
                         0, PSL, pc, n, nk, n % 8 == 0 && aligned(ws16, 16),
                         tid);
  stage_rows<32>(cw, BCS, cm, n, 16 * strip(0), 16, q, n, nk, vec_c, lane);
  cp_async_commit();
  {
    float c[Q_MAX / TC_THREADS];
#pragma unroll
    for (int u = 0; u < Q_MAX / TC_THREADS; ++u)
      c[u] = a.cum[(row0 + min(tid + u * TC_THREADS, q - 1)) * a.h + hh];
#pragma unroll
    for (int u = 0; u < Q_MAX / TC_THREADS; ++u)
      cum[tid + u * TC_THREADS] = c[u];
  }
  cp_async_wait<0>();
  __syncthreads();

  const float *cbc = cb + bc * qp * qp;
#pragma unroll 1
  for (int si = 0; si < 4; ++si) {
    const int s = strip(si);
    if (16 * s >= q) continue;
    const int i0 = 16 * s + g, i1 = i0 + 8;
    float acc[NB][4] = {};
    // inter: C rows i0, i1 times S16 over the state index, then e^{cum_i}
    {
      cp_async_wait<0>();  // this strip's C rows
      __syncwarp();
#pragma unroll
      for (int kb = 0; kb < N_MAX / 16; ++kb) {
        if (16 * kb >= nk) break;
        uint32_t af[4];
        ldsm_x4(af, smem_u32(cw + (lane % 16) * BCS + 16 * kb +
                             8 * (lane / 16)));
#pragma unroll
        for (int nb = 0; nb < NB; nb += 2) {
          uint32_t sb[4];
          ldsm_x4(sb, smem_u32(ss + nontrans_b_off(16 * kb, nb, BCS, lane)));
          mma_16816(acc[nb], af, sb[0], sb[1]);
          mma_16816(acc[nb + 1], af, sb[2], sb[3]);
        }
      }
      __syncwarp();  // every lane has read the C rows: copy the next strip's
      if (si < 3 && 16 * strip(si + 1) < q)
        stage_rows<32>(cw, BCS, cm, n, 16 * strip(si + 1), 16, q, n, nk,
                       vec_c, lane);
      cp_async_commit();
      const float e0 = expf(cum[i0]), e1 = expf(cum[i1]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        acc[nb][0] *= e0;
        acc[nb][1] *= e0;
        acc[nb][2] *= e1;
        acc[nb][3] *= e1;
      }
    }
    // intra: 16 columns at a time up to the diagonal; the cb blocks are
    // read two steps ahead of their use (f0 even steps, f1 odd)
    const float ci0 = cum[i0], ci1 = cum[i1];
    const float *r0 = cbc + (long)i0 * qp, *r1 = r0 + 8 * qp;
    float2 f0[4], f1[4];
    auto fetch = [&](float2(&f)[4], int kb) {
      const int j = 16 * kb + t2;
      f[0] = __ldg(reinterpret_cast<const float2 *>(r0 + j));
      f[1] = __ldg(reinterpret_cast<const float2 *>(r1 + j));
      f[2] = __ldg(reinterpret_cast<const float2 *>(r0 + j + 8));
      f[3] = __ldg(reinterpret_cast<const float2 *>(r1 + j + 8));
    };
    auto step = [&](const float2(&f)[4], int kb) {
      const int j = 16 * kb + t2;
      const float cj0 = cum[j], cj1 = cum[j + 1], cj8 = cum[j + 8],
                  cj9 = cum[j + 9];
      uint32_t af[4];
      af[0] = pack_bf16(j <= i0 ? f[0].x * __expf(ci0 - cj0) : 0.f,
                        j + 1 <= i0 ? f[0].y * __expf(ci0 - cj1) : 0.f);
      af[1] = pack_bf16(j <= i1 ? f[1].x * __expf(ci1 - cj0) : 0.f,
                        j + 1 <= i1 ? f[1].y * __expf(ci1 - cj1) : 0.f);
      af[2] = pack_bf16(j + 8 <= i0 ? f[2].x * __expf(ci0 - cj8) : 0.f,
                        j + 9 <= i0 ? f[2].y * __expf(ci0 - cj9) : 0.f);
      af[3] = pack_bf16(j + 8 <= i1 ? f[3].x * __expf(ci1 - cj8) : 0.f,
                        j + 9 <= i1 ? f[3].y * __expf(ci1 - cj9) : 0.f);
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t xf[4];
        ldsm_x4_t(xf, smem_u32(xs + trans_b_off(16 * kb, nb, XS, lane)));
        mma_16816(acc[nb], af, xf[0], xf[1]);
        mma_16816(acc[nb + 1], af, xf[2], xf[3]);
      }
    };
    fetch(f0, 0);
    if (s >= 1) fetch(f1, 1);
#pragma unroll 1
    for (int kb = 0; kb <= s; kb += 2) {
      float2 c[4] = {f0[0], f0[1], f0[2], f0[3]};
      if (kb + 2 <= s) fetch(f0, kb + 2);
      step(c, kb);
      if (kb + 1 <= s) {
        float2 d[4] = {f1[0], f1[1], f1[2], f1[3]};
        if (kb + 3 <= s) fetch(f1, kb + 3);
        step(d, kb + 1);
      }
    }
    // rows i0, i1 of y, columns p0 + 8 nb + t2, + 1
    bf16 *y0 = y + (row0 + i0) * hp + (long)hh * a.p + p0, *y1 = y0 + 8 * hp;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int c = 8 * nb + t2;
      if (i0 < q) y_pair(y0 + c, acc[nb][0], acc[nb][1], c, pc, y_pairs);
      if (i1 < q) y_pair(y1 + c, acc[nb][2], acc[nb][3], c, pc, y_pairs);
    }
  }
}

template <int PSL>
int launch_out(const SsdArgs &a, const float *cb, const bf16 *ws16,
               cudaStream_t s) {
  const size_t smem = OutSmem<PSL>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_out_kernel<PSL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = a.batch * a.nc * a.h * ((a.p + PSL - 1) / PSL);
  ssd_out_kernel<PSL><<<blocks, TC_THREADS, smem, s>>>(a, cb, ws16);
  return (int)cudaGetLastError();
}

int launch_tc(const SsdArgs &a, float *cb, float *ws, bf16 *ws16,
              int p_slice, cudaStream_t s) {
  const int nt = (a.q + SSD_TILE - 1) / SSD_TILE;
  const int blocks = a.batch * a.nc * (nt * (nt + 1) / 2 +
                                       a.h * ((a.p + PB - 1) / PB));
  cudaError_t e = cudaFuncSetAttribute(
      ssd_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)STATE_SMEM);
  if (e != cudaSuccess) return (int)e;
  ssd_state_kernel<<<blocks, TC_THREADS, STATE_SMEM, s>>>(a, cb, ws);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long per = (long)PASS_THREADS * PASS_ELEMS;
  ssd_pass_kernel<<<dim3((unsigned)(((long)a.p * a.n + per - 1) / per),
                         a.batch * a.h),
                    PASS_THREADS, 0, s>>>(a, ws, ws16);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  switch (p_slice) {
    case 16: return launch_out<16>(a, cb, ws16, s);
    case 32: return launch_out<32>(a, cb, ws16, s);
    case 64: return launch_out<64>(a, cb, ws16, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// state0: the state entering the first chunk (B, H, P, N) fp32, or null
// for zeros (a chunk of a prompt continues from the state the chunks
// before it left: chunked prefill). dtype 0 (fp32): ssd_scan_kernel; the
// workspaces are unused (may be null). dtype 1 (bf16): the workspaces cb
// (B, NC, Qp, Qp) fp32, Qp = Q rounded up to SSD_TILE, ws (B, NC, H, P, N)
// fp32 and ws16 (B, NC, H, P, N) bf16; ssd_out_kernel takes p_slice
// columns of P a CTA (16, 32 or 64; 0 takes the build's SSD_P_SLICE).
int ssd_scan_fwd(const void *xw, const float *cum, const void *b,
                 const void *c, void *y, float *state, const float *state0,
                 float *cb, float *ws, void *ws16, int batch, int nc, int q,
                 int h, int p, int n, int p_slice, int dtype, void *stream) {
  if (batch < 1 || nc < 1 || q < 1 || q > Q_MAX || h < 1 || p < 1 ||
      n < 1 || n > N_MAX)
    return (int)cudaErrorInvalidValue;
  SsdArgs a{xw, b, c, cum, y, state, state0, batch, nc, q, h, p, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_ssd<float>(a, s);
  if (dtype == 1 && cb != nullptr && ws != nullptr && ws16 != nullptr)
    return launch_tc(a, cb, ws, static_cast<bf16 *>(ws16),
                     p_slice == 0 ? SSD_P_SLICE : p_slice, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
