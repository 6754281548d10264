// Hand-written Hopper (sm_90a) kernel of the Mamba-2 SSD chunk scan, behind
// the same plain C interface as attention.cu (loaded with ctypes by
// repro_torch/kernels/build.py). It launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for sizes it does not hold (Q > 256, N > 128).
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
//   (B, NC, Q, H) fp32; outputs y in xw's layout and dtype and the final
//   state (B, H, P, N) fp32, written from shared memory.
//
//   Design: one CTA of 256 threads per (b, h, slice of PC = 32 columns of
//   P), so Mamba-2-2.7B's P = 64 gives two CTAs per head and one prompt
//   (B = 1, H = 80) fills 160 CTAs instead of 80. The CTA keeps its N x PC
//   state slice in shared memory (16 KB) across the chunk loop. The Q x Q
//   decay-masked score matrix does not fit (256 KB in fp32 at Q = 256), so
//   it is tiled as flash attention tiles its scores, without a softmax:
//   for each tile of TQ = 64 output rows, the inter term is read from the
//   old state first, then the column tiles up to the diagonal add their
//   decayed scores times xw. Only after every row tile has read the old
//   state (a __syncthreads()) does a second pass over the chunk's rows add
//   B^T (e^{total - cum} xw) to the decayed state. Every product runs on
//   the CUDA cores in fp32 (no wgmma yet), each thread a small register
//   tile over padded shared-memory rows (no bank conflicts on the inner
//   loops). Q, N, H and P are runtime sizes, so a prompt shorter than the
//   chunk (Q = S) and the reduced test shapes run the same code.
//
//   Bound on an H100: bytes, narrowly. Per row and chunk C B^T is 2 Q^2 N
//   operations, shared by the heads, and each head adds 2 Q^2 P + 4 Q N P;
//   at Mamba-2-2.7B's shapes (H = 80, P = 64, N = 128, Q = 256) that is
//   about 5.4 GFLOP per 1000-token prompt against 24 MB moved (xw and y,
//   B, C, cum, the state), 5.5 us at the bf16 tensor-core rate and 7.3 us
//   at 3.35 TB/s. This first version is limited by its arithmetic instead:
//   fp32 on the CUDA cores (no wgmma yet), and C B^T recomputed in every
//   CTA rather than once per row and chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention.cuh"

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

  for (int i = tid; i < N_MAX * PC; i += SSD_THREADS) st[i] = 0.f;
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

}  // namespace

extern "C" {

int ssd_scan_fwd(const void *xw, const float *cum, const void *b,
                 const void *c, void *y, float *state, int batch, int nc,
                 int q, int h, int p, int n, int dtype, void *stream) {
  if (batch < 1 || nc < 1 || q < 1 || q > Q_MAX || h < 1 || p < 1 ||
      n < 1 || n > N_MAX)
    return (int)cudaErrorInvalidValue;
  SsdArgs a{xw, b, c, cum, y, state, batch, nc, q, h, p, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_ssd<float>(a, s);
  if (dtype == 1) return launch_ssd<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
