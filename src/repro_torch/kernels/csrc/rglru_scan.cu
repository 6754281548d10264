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

}  // extern "C"
