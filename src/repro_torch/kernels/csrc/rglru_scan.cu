// Hand-written Hopper (sm_90a) kernel of the RG-LRU linear recurrence, behind
// the same plain C interface as attention.cu (loaded with ctypes by
// repro_torch/kernels/build.py). It launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an empty size or an unknown dtype.
//
// rglru_scan_fwd
//   Replaces src/repro/kernels/rglru_scan.py:37 `rglru_scan` (pl.pallas_call
//   at :50). Per channel (b, w), along the sequence:
//     h_t = a_t * h_{t-1} + b_t,   h_{-1} = h0 (zeros when h0 is null),
//   with the state in fp32 and y_t = h_t written in the inputs' dtype (fp32
//   or bf16). Inputs a, b (B, S, W), h0 (B, W) fp32; outputs y (B, S, W)
//   and h_T (B, W) in fp32, from the register that carried the state. (The
//   TPU op recovered h_T as y[:, -1], rounded to y's dtype.) Any B, S and W
//   work: the TPU kernel asserted that its blocks divide them.
//
//   Design: one thread per channel walks S, warps on consecutive w, so each
//   step's loads and stores coalesce across the warp. The chain h_t is
//   sequential, so the kernel keeps loads in flight instead: the loop runs
//   in steps of UNROLL = 16 and loads the next block of a and b into
//   registers before it runs the current block's updates, so 32 loads per
//   thread are outstanding while the dependent multiply-adds run. Each
//   update is a round-to-nearest multiply, then an add (no fused FMA), the
//   plain PyTorch version's arithmetic, so the two agree bit for bit.
//
//   Bound on an H100: bytes. The recurrence does 2 operations per element
//   against 3 elements moved (a and b read, y written), far below the
//   card's ridge; at B = 4, S = 3000, W = 2560 in fp32 that is 369 MB, 0.110
//   ms at 3.35 TB/s. This first version does not reach it: at B = 4 there
//   are only 10,240 channels, 80 CTAs of 128 threads on 132 SMs, each thread
//   a chain of S dependent steps. A chunked scan over S (each CTA a span of
//   the sequence, then a pass that carries the chunk states across) is
//   later work.
//
// rglru_scan_bwd
//   Replaces no TPU kernel: the JAX package takes the recurrence's gradient
//   through XLA (jax.grad of its associative scan; jax.grad through the
//   Pallas rglru_scan fails, ROADMAP §3). It is the gradient of
//   rglru_scan_fwd in fp32: per channel, walking the sequence backwards,
//     dh_t = a_{t+1} * dh_{t+1} + dy_t,   dh_{S-1} = dh_T + dy_{S-1},
//     da_t = dh_t * h_{t-1},  db_t = dh_t,  dh0 = a_0 * dh_0,
//   with h_{t-1} read from the forward's y (exact in fp32), h_{-1} = h0
//   (zeros when h0 is null) and dh_T the final state's gradient (zeros when
//   null). Inputs a, y, dy (B, S, W), h0 and dh_T (B, W); outputs da, db
//   (B, S, W) and dh0 (B, W, skipped when null), all fp32.
//
//   Design: the forward's body run backwards: one thread per channel, warps
//   on consecutive w, the next UNROLL steps of a, y and dy loaded into
//   registers before the current block's dependent updates. Each update is
//   a round-to-nearest multiply, then an add, as the plain backward
//   (kernels/ref.py rglru_scan_bwd_ref) computes it, so the two agree bit
//   for bit.
//
//   Bound on an H100: bytes. 5 elements a step are moved (a, y, dy read,
//   da, db written) for 3 operations; at B = 4, S = 3000, W = 2560 that is
//   614 MB, 0.18 ms at 3.35 TB/s. Like the forward it keeps only 10,240
//   chains in flight at B = 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention.cuh"

using bullet::from_f;
using bullet::to_f;

namespace {

constexpr int RG_THREADS = 128;  // channels per CTA
constexpr int UNROLL = 16;       // steps whose loads are issued together

struct RglruArgs {
  const void *a, *b;   // (B, S, W), fp32 or bf16
  const float *h0;     // (B, W) fp32, or null for zeros
  void *y;             // (B, S, W), a's dtype
  float *h_last;       // (B, W) fp32
  int batch, s, w;
};

template <typename T>
__global__ void __launch_bounds__(RG_THREADS) rglru_scan_kernel(RglruArgs p) {
  const long ch = (long)blockIdx.x * RG_THREADS + threadIdx.x;
  if (ch >= (long)p.batch * p.w) return;
  const long bb = ch / p.w, ww = ch % p.w;
  const size_t base = (size_t)bb * p.s * p.w + ww;
  const T *a = static_cast<const T *>(p.a) + base;
  const T *b = static_cast<const T *>(p.b) + base;
  T *y = static_cast<T *>(p.y) + base;
  const size_t stride = p.w;

  float h = p.h0 ? p.h0[ch] : 0.f;
  float an[UNROLL], bn[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const bool in = u < p.s;
    an[u] = in ? to_f(a[u * stride]) : 1.f;
    bn[u] = in ? to_f(b[u * stride]) : 0.f;
  }
  for (int t0 = 0; t0 < p.s; t0 += UNROLL) {
    float ac[UNROLL], bc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ac[u] = an[u];
      bc[u] = bn[u];
    }
    // the next block's loads go out before this block's dependent updates
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + UNROLL + u;
      const bool in = t < p.s;
      an[u] = in ? to_f(a[t * stride]) : 1.f;
      bn[u] = in ? to_f(b[t * stride]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      if (t < p.s) {
        h = __fadd_rn(__fmul_rn(ac[u], h), bc[u]);
        y[t * stride] = from_f<T>(h);
      }
    }
  }
  p.h_last[ch] = h;
}

template <typename T>
int launch_rglru(const RglruArgs &a, cudaStream_t s) {
  const long channels = (long)a.batch * a.w;
  const int blocks = (int)((channels + RG_THREADS - 1) / RG_THREADS);
  rglru_scan_kernel<T><<<blocks, RG_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

struct RglruBwdArgs {
  const float *a, *y, *h0, *dy, *dh_last;  // h0, dh_last may be null
  float *da, *db, *dh0;                    // dh0 may be null
  int batch, s, w;
};

__global__ void __launch_bounds__(RG_THREADS)
    rglru_scan_bwd_kernel(RglruBwdArgs p) {
  const long ch = (long)blockIdx.x * RG_THREADS + threadIdx.x;
  if (ch >= (long)p.batch * p.w) return;
  const long bb = ch / p.w, ww = ch % p.w;
  const size_t base = (size_t)bb * p.s * p.w + ww;
  const float *a = p.a + base, *y = p.y + base, *dy = p.dy + base;
  float *da = p.da + base, *db = p.db + base;
  const size_t stride = p.w;
  const float h_init = p.h0 ? p.h0[ch] : 0.f;

  // step t of block k is t = s - 1 - (k * UNROLL + u); hp is h_{t-1}
  float an[UNROLL], hn[UNROLL], dn[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int t = p.s - 1 - u;
    an[u] = t >= 0 ? a[t * stride] : 0.f;
    dn[u] = t >= 0 ? dy[t * stride] : 0.f;
    hn[u] = t >= 1 ? y[(t - 1) * stride] : h_init;
  }
  float g = p.dh_last ? p.dh_last[ch] : 0.f;  // a_{t+1} * dh_{t+1}
  for (int t0 = p.s - 1; t0 >= 0; t0 -= UNROLL) {
    float ac[UNROLL], hc[UNROLL], dc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ac[u] = an[u];
      hc[u] = hn[u];
      dc[u] = dn[u];
    }
    // the next block's loads go out before this block's dependent updates
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 - UNROLL - u;
      an[u] = t >= 0 ? a[t * stride] : 0.f;
      dn[u] = t >= 0 ? dy[t * stride] : 0.f;
      hn[u] = t >= 1 ? y[(t - 1) * stride] : h_init;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        const float dh = __fadd_rn(g, dc[u]);
        da[t * stride] = __fmul_rn(dh, hc[u]);
        db[t * stride] = dh;
        g = __fmul_rn(ac[u], dh);
      }
    }
  }
  if (p.dh0) p.dh0[ch] = g;
}

}  // namespace

extern "C" {

int rglru_scan_fwd(const void *a, const void *b, const float *h0, void *y,
                   float *h_last, int batch, int s, int w, int dtype,
                   void *stream) {
  if (batch < 1 || s < 1 || w < 1) return (int)cudaErrorInvalidValue;
  RglruArgs p{a, b, h0, y, h_last, batch, s, w};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_rglru<float>(p, st);
  if (dtype == 1) return launch_rglru<__nv_bfloat16>(p, st);
  return (int)cudaErrorInvalidValue;
}

// fp32 only: a, y (the forward's output), dy (B, S, W); h0, dh_last (B, W)
// or null for zeros; writes da, db (B, S, W) and, unless null, dh0 (B, W)
int rglru_scan_bwd(const float *a, const float *y, const float *h0,
                   const float *dy, const float *dh_last, float *da,
                   float *db, float *dh0, int batch, int s, int w,
                   void *stream) {
  if (batch < 1 || s < 1 || w < 1) return (int)cudaErrorInvalidValue;
  RglruBwdArgs p{a, y, h0, dy, dh_last, da, db, dh0, batch, s, w};
  const long channels = (long)batch * w;
  const int blocks = (int)((channels + RG_THREADS - 1) / RG_THREADS);
  rglru_scan_bwd_kernel<<<blocks, RG_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
