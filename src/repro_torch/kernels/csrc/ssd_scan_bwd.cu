// Hand-written Hopper (sm_90a) backward of the Mamba-2 SSD chunk scan
// (kernel 6), behind the same plain C interface as attention.cu (loaded with
// ctypes by repro_torch/kernels/build.py). It launches on the stream it is
// given, allocates nothing (the wrapper allocates the outputs and the
// workspaces), and returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue for sizes it does not hold (Q > 256, N > 128,
// P > 64).
//
// ssd_scan_bwd
//   Replaces no TPU kernel: the JAX package takes the scan's gradient
//   through XLA (jax.grad of ssd_chunked's lax.scan; jax.grad through the
//   Pallas ssd_scan fails, ROADMAP §3). It is the gradient of ssd_scan_fwd's
//   fp32 body. Per (b, h) and chunk, with S the state entering the chunk,
//   S' the state it leaves, G = dL/dS', total = cum[Q-1], L_ij =
//   e^{cum_i - cum_j} (j <= i), cb_ij = C_i . B_j, M_ij = L_ij (dy_i . xw_j):
//     dxw_j = sum_{i>=j} cb_ij L_ij dy_i + e^{total - cum_j} G B_j
//     dC_i  = sum_h [sum_{j<=i} M_ij B_j + e^{cum_i} S^T dy_i]
//     dB_j  = sum_h [sum_{i>=j} M_ij C_i + e^{total - cum_j} G^T xw_j]
//     dcum_i = sum_j cb_ij M_ij - sum_j cb_ji M_ji + dy_i . e^{cum_i} S C_i
//            - xw_i . e^{total - cum_i} G B_i + [i = Q-1] <G, S'>
//     dL/dS = e^{total} G + sum_i e^{cum_i} dy_i C_i^T
//   (kernels/ref.py ssd_scan_bwd_ref is this algebra, plainly). Inputs as
//   ssd_scan_fwd's (fp32) plus dy (B, NC, Q, H, P) and the final state's
//   gradient dstate (B, H, P, N, null for zeros); outputs dxw, dcum, dB, dC
//   in the inputs' layouts and dstate0 (B, H, P, N, skipped when null).
//
//   Design: the forward's three phases run in reverse, in four launches.
//   1. ssd_bwd_local_kernel, chunk-parallel, one CTA per (b, chunk, head,
//      which): the chunk's own state sum_j e^{total - cum_j} xw_j B_j^T
//      (which 0) and its own gradient term sum_i e^{cum_i} dy_i C_i^T (which
//      1), P x N each, into the workspaces states[b, c + 1] and grads[b, c].
//   2. ssd_bwd_pass_kernel, per element of each (b, h) state: forward,
//      S_{c+1} = e^{total_c} S_c + (1.) from state0, every state entering a
//      chunk and the last kept in states (B, NC + 1, H, P, N); then
//      backwards, G_{c-1} = e^{total_c} G_c + (1.) from dstate, each G_c
//      kept in grads (B, NC, H, P, N), the first chunk's giving dstate0.
//   3. ssd_bwd_chunk_kernel, chunk-parallel, one CTA per (b, chunk, head,
//      64-row tile t, role). The Q x Q tiles do not fit in shared memory
//      (256 KB at Q = 256 in fp32), so every product is tiled by 64 rows as
//      the forward tiles its scores. Role "rows" owns rows i of tile t (C_i,
//      dy_i) and walks the column tiles at or before it (B_j, xw_j): dC_i
//      for this head and dcum_i's row half. Role "columns" owns rows j of
//      tile t (B_j, xw_j) and walks the row tiles at or after it (C_i,
//      dy_i): dxw_j, dB_j for this head and dcum_j's column half. Both roles
//      compute their tile pair's cb and dy . xw tiles; each role starts with
//      its state terms (S, or G and <G, S'>), read from (2.). A tile t's two
//      roles walk nt + 1 tile pairs together, so the grid is balanced.
//   4. ssd_bwd_reduce_kernel: dB and dC sum their per-head parts over H in
//      head order, and dcum adds its two halves: B and C are shared by the
//      heads (n_groups = 1), and a fixed order (no atomics) gives the same
//      bits on every run.
//   Every product runs on the CUDA cores in fp32, each thread a small
//   register tile over padded shared-memory rows.
//
//   Bound on an H100: operations. Per (row, chunk) cb is Q^2 N multiply-adds
//   under the triangle, shared by the heads; per head the tiles add dy . xw,
//   the dxw, dB and dC products (Q^2 P + Q^2 P + 2 Q^2 N over the triangle)
//   and six P x N state products per row; at Mamba-2-2.7B's shapes (H = 80,
//   P = 64, N = 128, Q = 256) that is about 16 GFLOP per 1000-token prompt
//   against 60 MB moved, 0.24 ms at the fp32 peak of 67 TFLOP/s. This first
//   body recomputes cb in every CTA of both roles and keeps H per-head
//   copies of dB and dC; tensor cores and bf16 are ROADMAP §2 R18.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int TQ = 64;         // rows of a chunk per tile
constexpr int P_MAX = 64;      // head dim the shared buffers hold
constexpr int N_MAX = 128;     // state size the shared buffers hold
constexpr int Q_MAX = 256;     // chunk length the cum buffer holds
constexpr int NS = N_MAX + 1;  // padded row stride of N-wide tiles
constexpr int PS = P_MAX + 1;  // padded row stride of P-wide tiles
constexpr int SS = TQ + 1;     // padded row stride of the pair tiles

struct BwdArgs {
  const float *xw, *cum, *b, *c, *state0, *dy, *dstate;
  float *dxw, *dcum, *db, *dc, *dstate0;
  float *states;  // (B, NC + 1, H, P, N)
  float *grads;   // (B, NC, H, P, N)
  float *dbh, *dch;  // (B, NC, H, Q, N) per-head parts
  float *dcum2;      // (2, B, NC, Q, H) the rows' and the columns' halves
  int batch, nc, q, h, p, n;
};

__device__ __forceinline__ long state_at(const BwdArgs &a, int bb, int c,
                                         int nstates, int hh) {
  return (((long)bb * nstates + c) * a.h + hh) * a.p * a.n;
}

// ---------------------------------------------------------------------------
// 1. each chunk's own state and its own gradient term
// ---------------------------------------------------------------------------

// shared floats: the weighted P-wide rows [TQ][P_MAX], the N-wide rows
// [TQ][N_MAX]
constexpr int LOCAL_SMEM = sizeof(float) * TQ * (P_MAX + N_MAX);

__global__ void __launch_bounds__(THREADS) ssd_bwd_local_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float *vp = smem;                 // [TQ][P_MAX]
  float *vn = vp + TQ * P_MAX;      // [TQ][N_MAX]
  const int tid = threadIdx.x;
  const int hh = blockIdx.x % a.h;
  const int bc = blockIdx.x / a.h;  // b * nc + chunk
  const int bb = bc / a.nc, ch = bc % a.nc;
  const bool own_state = blockIdx.y == 0;
  const long row0 = (long)bc * a.q;
  const float total = a.cum[(row0 + a.q - 1) * a.h + hh];
  // which 0: w_j = e^{total - cum_j}, rows xw_j and B_j;
  // which 1: w_i = e^{cum_i}, rows dy_i and C_i
  const float *pv = own_state ? a.xw : a.dy;
  const float *nv = own_state ? a.b : a.c;
  // out rows p = pr + u, columns n = nc0 + 16 v
  const int pr = (tid >> 4) * 4, nc0 = tid & 15;
  float acc[4][8] = {};
  for (int j0 = 0; j0 < a.q; j0 += TQ) {
    const int rows = min(TQ, a.q - j0);
    __syncthreads();
    for (int e = tid; e < TQ * P_MAX; e += THREADS) {
      const int j = e / P_MAX, k = e % P_MAX;
      float v = 0.f;
      if (j < rows && k < a.p) {
        const long row = row0 + j0 + j;
        const float cj = a.cum[row * a.h + hh];
        v = pv[(row * a.h + hh) * a.p + k] *
            (own_state ? expf(total - cj) : expf(cj));
      }
      vp[e] = v;
    }
    for (int e = tid; e < TQ * N_MAX; e += THREADS) {
      const int j = e / N_MAX, k = e % N_MAX;
      vn[e] = (j < rows && k < a.n) ? nv[(row0 + j0 + j) * a.n + k] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      float x[4], y[8];
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = vp[j * P_MAX + pr + u];
#pragma unroll
      for (int v = 0; v < 8; ++v) y[v] = vn[j * N_MAX + nc0 + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] += x[u] * y[v];
    }
  }
  float *out = own_state ? a.states + state_at(a, bb, ch + 1, a.nc + 1, hh)
                         : a.grads + state_at(a, bb, ch, a.nc, hh);
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int pp = pr + u, nn = nc0 + 16 * v;
      if (pp < a.p && nn < a.n) out[(long)pp * a.n + nn] = acc[u][v];
    }
}

// ---------------------------------------------------------------------------
// 2. the passes over the chunks, forward for S and backward for G
// ---------------------------------------------------------------------------

constexpr int PASS_THREADS = 256;

__global__ void __launch_bounds__(PASS_THREADS) ssd_bwd_pass_kernel(BwdArgs a) {
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
// 3. the tiles of each chunk, by rows and by columns
// ---------------------------------------------------------------------------

// shared floats: own N-wide rows [TQ][NS], own P-wide rows [TQ][PS], the
// other tile's N-wide rows [TQ][NS] (first the state, [P_MAX][NS]) and
// P-wide rows [TQ][PS], the pair tiles M and cb L [TQ][SS] each, cum
// [Q_MAX], the own rows' dcum [TQ], a reduction buffer [THREADS / 32]
constexpr int CHUNK_SMEM_FLOATS =
    2 * TQ * NS + 2 * TQ * PS + 2 * TQ * SS + Q_MAX + TQ + THREADS / 32;
static_assert(P_MAX <= TQ, "the state buffer reuses the other N-wide tile");

// sum over the 2^k lanes of a group of consecutive lanes
template <int LANES>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < LANES; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [r0, r0 + TQ) of a (rows, width) row-major matrix (row stride `ld`,
// column offset `col0`) into dst[TQ][stride], zeros past q and width
__device__ __forceinline__ void load_rows(float *dst, int stride,
                                          const float *src, long ld,
                                          long base_row, int r0, int q,
                                          int width, long col0) {
  for (int e = threadIdx.x; e < TQ * stride; e += THREADS) {
    const int r = e / stride, k = e % stride;
    const int gr = r0 + r;
    dst[e] = (gr < q && k < width) ? src[(base_row + gr) * ld + col0 + k]
                                   : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_chunk_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float *own_n = smem;               // [TQ][NS]: C (rows) or B (columns)
  float *own_p = own_n + TQ * NS;    // [TQ][PS]: dy (rows) or xw (columns)
  float *oth_n = own_p + TQ * PS;    // [TQ][NS]: B (rows) or C (columns)
  float *oth_p = oth_n + TQ * NS;    // [TQ][PS]: xw (rows) or dy (columns)
  float *mt = oth_p + TQ * PS;       // [TQ][SS]: M (own row, other row)
  float *xlt = mt + TQ * SS;         // [TQ][SS]: cb L (columns)
  float *cum = xlt + TQ * SS;        // [Q_MAX]
  float *dcum_own = cum + Q_MAX;     // [TQ]
  float *red = dcum_own + TQ;        // [THREADS / 32]
  float *st = oth_n;                 // [P_MAX][NS]: S (rows) or G (columns)

  const int tid = threadIdx.x;
  const int nt = (a.q + TQ - 1) / TQ;
  long idx = blockIdx.x;
  const bool by_rows = (idx & 1) == 0;
  idx >>= 1;
  const int t = (int)(idx % nt);
  idx /= nt;
  const int hh = (int)(idx % a.h);
  const int bc = (int)(idx / a.h);   // b * nc + chunk
  const int bb = bc / a.nc, ch = bc % a.nc;
  const long row0 = (long)bc * a.q;  // the chunk's first row
  const int r0 = t * TQ;             // the own tile's first row
  const long hp = (long)a.h * a.p;
  const float *own_nsrc = by_rows ? a.c : a.b;
  const float *own_psrc = by_rows ? a.dy : a.xw;
  const float *oth_nsrc = by_rows ? a.b : a.c;
  const float *oth_psrc = by_rows ? a.xw : a.dy;

  for (int i = tid; i < Q_MAX; i += THREADS)
    cum[i] = i < a.q ? a.cum[(row0 + i) * a.h + hh] : 0.f;
  load_rows(own_n, NS, own_nsrc, a.n, row0, r0, a.q, a.n, 0);
  load_rows(own_p, PS, own_psrc, hp, row0, r0, a.q, a.p, (long)hh * a.p);
  {
    // the state term's matrix: S entering the chunk (rows), G of the state
    // it leaves (columns), [p][n]
    const float *src =
        by_rows ? a.states + state_at(a, bb, ch, a.nc + 1, hh)
                : a.grads + state_at(a, bb, ch, a.nc, hh);
    for (int e = tid; e < P_MAX * NS; e += THREADS) {
      const int pp = e / NS, k = e % NS;
      st[e] = (pp < a.p && k < a.n) ? src[(long)pp * a.n + k] : 0.f;
    }
  }
  __syncthreads();
  const float total = cum[a.q - 1];

  // accumulator tiles: own rows ar + {0, 1}; N-wide columns ac + 8 x (16),
  // P-wide columns ac + 8 x (8)
  const int ar = (tid >> 3) * 2, ac = tid & 7;
  float acc_n[2][16], acc_p[2][8];
  // per-row weights of the state terms: e^{cum_i} (rows), e^{total -
  // cum_j} (columns), zero past q
  float w[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gr = r0 + ar + r;
    w[r] = gr < a.q ? (by_rows ? expf(cum[gr]) : expf(total - cum[gr])) : 0.f;
  }

  if (by_rows) {
    // dC_i's state term e^{cum_i} S^T dy_i, then dcum_i's inter term
    // C_i . (that term) = dy_i . y_inter_i
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int x = 0; x < 16; ++x) acc_n[r][x] = 0.f;
    for (int pp = 0; pp < a.p; ++pp) {
      const float d0 = own_p[ar * PS + pp], d1 = own_p[(ar + 1) * PS + pp];
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const float s = st[pp * NS + ac + 8 * x];
        acc_n[0][x] += d0 * s;
        acc_n[1][x] += d1 * s;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float part = 0.f;
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        acc_n[r][x] *= w[r];
        part += own_n[(ar + r) * NS + ac + 8 * x] * acc_n[r][x];
      }
      part = group_sum<8>(part);
      if (ac == 0) dcum_own[ar + r] = part;
    }
  } else {
    // u_j = e^{total - cum_j} G B_j into dxw_j, dcum_j's -xw_j . u_j, then
    // dB_j's state term e^{total - cum_j} G^T xw_j
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int x = 0; x < 8; ++x) acc_p[r][x] = 0.f;
    for (int k = 0; k < a.n; ++k) {
      const float b0 = own_n[ar * NS + k], b1 = own_n[(ar + 1) * NS + k];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const float g = st[(ac + 8 * x) * NS + k];
        acc_p[0][x] += b0 * g;
        acc_p[1][x] += b1 * g;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float part = 0.f;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        acc_p[r][x] *= w[r];
        part += own_p[(ar + r) * PS + ac + 8 * x] * acc_p[r][x];
      }
      part = group_sum<8>(part);
      if (ac == 0) dcum_own[ar + r] = -part;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int x = 0; x < 16; ++x) acc_n[r][x] = 0.f;
    for (int pp = 0; pp < a.p; ++pp) {
      const float x0 = own_p[ar * PS + pp], x1 = own_p[(ar + 1) * PS + pp];
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const float g = st[pp * NS + ac + 8 * x];
        acc_n[0][x] += x0 * g;
        acc_n[1][x] += x1 * g;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int x = 0; x < 16; ++x) acc_n[r][x] *= w[r];
    if (t == nt - 1) {
      // e^{total}'s term of cum[Q - 1]: <G, S'>, S' from the workspace
      const float *s_out = a.states + state_at(a, bb, ch + 1, a.nc + 1, hh);
      float part = 0.f;
      for (int e = tid; e < a.p * a.n; e += THREADS)
        part += st[(e / a.n) * NS + e % a.n] * s_out[e];
      part = group_sum<32>(part);
      if ((tid & 31) == 0) red[tid >> 5] = part;
    }
  }
  __syncthreads();  // dcum_own and red are written; st is read
  if (!by_rows && t == nt - 1 && tid == 0) {
    float sum = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) sum += red[i];
    dcum_own[a.q - 1 - r0] += sum;
  }

  // the tile pairs: rows walk the column tiles 0..t, columns the row tiles
  // t..nt-1; pair tiles: own rows sr + {0..3}, other rows so + 16 {0..3}
  const int sr = (tid >> 4) * 4, so = tid & 15;
  const int o_lo = by_rows ? 0 : t, o_hi = by_rows ? t : nt - 1;
  for (int ot = o_lo; ot <= o_hi; ++ot) {
    const int o0 = ot * TQ;
    __syncthreads();  // the last pair's tiles (or st) are consumed
    load_rows(oth_n, NS, oth_nsrc, a.n, row0, o0, a.q, a.n, 0);
    load_rows(oth_p, PS, oth_psrc, hp, row0, o0, a.q, a.p, (long)hh * a.p);
    __syncthreads();
    float xs[4][4] = {}, ys[4][4] = {};
    for (int k = 0; k < a.n; ++k) {
      float u_[4], v_[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) u_[u] = own_n[(sr + u) * NS + k];
#pragma unroll
      for (int v = 0; v < 4; ++v) v_[v] = oth_n[(so + 16 * v) * NS + k];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) xs[u][v] += u_[u] * v_[v];
    }
    for (int k = 0; k < a.p; ++k) {
      float u_[4], v_[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) u_[u] = own_p[(sr + u) * PS + k];
#pragma unroll
      for (int v = 0; v < 4; ++v) v_[v] = oth_p[(so + 16 * v) * PS + k];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) ys[u][v] += u_[u] * v_[v];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int gr = r0 + sr + u;
      float rowsum = 0.f;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int go = o0 + so + 16 * v;
        // i = the row index, j = the column index of the pair
        const int gi = by_rows ? gr : go, gj = by_rows ? go : gr;
        float m = 0.f, xl = 0.f;
        if (gj <= gi && gi < a.q) {
          const float l = expf(cum[gi] - cum[gj]);
          m = l * ys[u][v];
          xl = xs[u][v] * l;
          rowsum += xs[u][v] * m;
        }
        mt[(sr + u) * SS + so + 16 * v] = m;
        xlt[(sr + u) * SS + so + 16 * v] = xl;
      }
      rowsum = group_sum<16>(rowsum);
      if (so == 0) dcum_own[sr + u] += by_rows ? rowsum : -rowsum;
    }
    __syncthreads();
    // dC_i += M B (rows) or dB_j += M^T C (columns); dxw_j += (cb L)^T dy
    for (int o = 0; o < TQ; ++o) {
      const float m0 = mt[ar * SS + o], m1 = mt[(ar + 1) * SS + o];
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const float v = oth_n[o * NS + ac + 8 * x];
        acc_n[0][x] += m0 * v;
        acc_n[1][x] += m1 * v;
      }
      if (!by_rows) {
        const float l0 = xlt[ar * SS + o], l1 = xlt[(ar + 1) * SS + o];
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const float d = oth_p[o * PS + ac + 8 * x];
          acc_p[0][x] += l0 * d;
          acc_p[1][x] += l1 * d;
        }
      }
    }
  }
  __syncthreads();  // dcum_own is complete

  // this head's part of dC (rows) or dB (columns), dxw (columns), dcum's
  // half
  float *part = (by_rows ? a.dch : a.dbh) +
                ((long)bc * a.h + hh) * a.q * a.n;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gr = r0 + ar + r;
    if (gr >= a.q) continue;
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int k = ac + 8 * x;
      if (k < a.n) part[(long)gr * a.n + k] = acc_n[r][x];
    }
    if (!by_rows) {
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int pp = ac + 8 * x;
        if (pp < a.p)
          a.dxw[((row0 + gr) * a.h + hh) * a.p + pp] = acc_p[r][x];
      }
    }
  }
  float *half = a.dcum2 + (by_rows ? 0 : (long)a.batch * a.nc * a.q * a.h);
  for (int r = tid; r < TQ; r += THREADS) {
    const int gr = r0 + r;
    if (gr < a.q) half[(row0 + gr) * a.h + hh] = dcum_own[r];
  }
}

// ---------------------------------------------------------------------------
// 4. dB and dC over the heads in order, dcum's halves
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) ssd_bwd_reduce_kernel(BwdArgs a) {
  const long qn = (long)a.q * a.n, qh = (long)a.q * a.h;
  const long e = (long)blockIdx.x * THREADS + threadIdx.x;
  const long bc = blockIdx.y;
  if (e < qn) {
    const float *pb = a.dbh + bc * a.h * qn + e;
    const float *pc = a.dch + bc * a.h * qn + e;
    float sb = 0.f, sc = 0.f;
    for (int hh = 0; hh < a.h; ++hh) {
      sb += pb[hh * qn];
      sc += pc[hh * qn];
    }
    a.db[bc * qn + e] = sb;
    a.dc[bc * qn + e] = sc;
  }
  if (e < qh) {
    const long half = (long)a.batch * a.nc * qh;
    a.dcum[bc * qh + e] = a.dcum2[bc * qh + e] + a.dcum2[half + bc * qh + e];
  }
}

template <typename K>
cudaError_t launch(K kern, dim3 grid, int threads, size_t smem,
                   const BwdArgs &a, cudaStream_t s) {
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

// fp32 only. state0, dstate and dstate0 may be null (zeros; dstate0
// skipped). Workspaces the wrapper allocates: states (B, NC + 1, H, P, N),
// grads (B, NC, H, P, N), dbh and dch (B, NC, H, Q, N), dcum2 (2, B, NC,
// Q, H), all fp32.
int ssd_scan_bwd(const float *xw, const float *cum, const float *b,
                 const float *c, const float *state0, const float *dy,
                 const float *dstate, float *dxw, float *dcum, float *db,
                 float *dc, float *dstate0, float *states, float *grads,
                 float *dbh, float *dch, float *dcum2, int batch, int nc,
                 int q, int h, int p, int n, void *stream) {
  if (batch < 1 || nc < 1 || q < 1 || q > Q_MAX || h < 1 || p < 1 ||
      p > P_MAX || n < 1 || n > N_MAX)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{xw,   cum,   b,      c,  state0, dy,    dstate, dxw,
            dcum, db,    dc,     dstate0,   states, grads, dbh,
            dch,  dcum2, batch,  nc, q,      h,     p,      n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned bch = (unsigned)(batch * nc * h);
  cudaError_t e = launch(ssd_bwd_local_kernel, dim3(bch, 2), THREADS,
                         LOCAL_SMEM, a, s);
  if (e != cudaSuccess) return (int)e;
  const long pn = (long)p * n;
  e = launch(ssd_bwd_pass_kernel,
             dim3((unsigned)((pn + PASS_THREADS - 1) / PASS_THREADS),
                  (unsigned)(batch * h)),
             PASS_THREADS, 0, a, s);
  if (e != cudaSuccess) return (int)e;
  const int nt = (q + TQ - 1) / TQ;
  e = launch(ssd_bwd_chunk_kernel, dim3(bch * nt * 2), THREADS,
             sizeof(float) * CHUNK_SMEM_FLOATS, a, s);
  if (e != cudaSuccess) return (int)e;
  const long wide = (long)q * (n > h ? n : h);
  return (int)launch(ssd_bwd_reduce_kernel,
                     dim3((unsigned)((wide + THREADS - 1) / THREADS),
                          (unsigned)(batch * nc)),
                     THREADS, 0, a, s);
}

}  // extern "C"
