// Hand-written Hopper (sm_90a) backward of the flash prefill attention
// (kernel 1), behind the same plain C interface as attention.cu (loaded with
// ctypes by repro_torch/kernels/build.py). It launches on the stream it is
// given, allocates nothing (the wrapper allocates the outputs and the
// per-row workspace), and returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue for what it is not built for.
//
// flash_attention_bwd
//   Replaces no TPU kernel: the JAX package takes attention's gradient
//   through XLA (jax.grad of flash_ref_attention; jax.grad through its
//   Pallas flash kernel fails, ROADMAP §3). It is the gradient of
//   flash_attention_fwd's fp32 body: q (BH, Sq, D), k and v (BH/G, Sk, D),
//   the forward's output o and the output's gradient dO (BH, Sq, D), kv head
//   = bh / G, scale D^-0.5, query row i at position i (q_offset 0), key row
//   j at j, key j seen by query i iff j < Sk and (non-causal or j <= i) and
//   (no window or j > i - window). Writes dq (BH, Sq, D) and dk, dv (BH/G,
//   Sk, D), fp32, at D = 64, 128 and 256. Any Sq and Sk work (ragged tails
//   are masked; Sq != Sk for cross-attention).
//
//   Design (FlashAttention-2's split, no atomics), three launches:
//   1. pre-pass, one CTA per (bh, query tile): each row's log-sum-
//      exp over its seen keys, recomputed with the forward's online max
//      and sum (so the forward kernels keep their registers and write no
//      LSE), and delta = rowsum(dO * o);
//   2. dK/dV, one CTA per (kv head, key tile): it walks the G query
//      heads of its kv head and, for each, the query tiles that see any of
//      its keys; per tile P^T = exp(K Q^T - lse) and dS^T = P^T (V dO^T -
//      delta) go through shared memory, and dV += P^T dO, dK += dS^T Q
//      accumulate in registers, so the G heads' sum into one kv head needs
//      no second pass;
//   3. dQ, one CTA per (bh, query tile): it walks the key tiles its
//      rows see and accumulates dQ += dS K.
//   A tile pair is skipped whole when the mask keeps none of its pairs
//   (uniform per CTA): causal needs the query tile's last row at or past
//   the key tile's first key, a window needs the query tile's first row
//   within the window of the key tile's last key.
//   In every tile thread t owns row t / RT, and the RT threads of a row
//   split the tile's columns (c = j + RT i) for the dot products and the
//   head dims (d = j + RT i) for the accumulations, as flash_item does; rows
//   in shared memory are padded by one float so column walks stay free of
//   bank conflicts. Tiles are 64 rows (RT = 4) at D = 64 and 128. At D = 256
//   that layout would need 4 tiles of 64 x 257 floats in the dK/dV kernel
//   (263 KB, over the 227 KB a CTA may hold), and 64 dK and 64 dV floats
//   a thread; so D = 256 takes 32-row tiles (RT = 8: 140 KB in the dK/dV
//   kernel, 136 KB in the dQ kernel, 32 dK and 32 dV floats a thread, as
//   at D = 128).
//
//   Bound on an H100: operations. The backward does 2.5 times the forward's
//   products (Q K^T again, dO V^T, P^T dO, dS^T Q, dS K against Q K^T and
//   P V), 10 multiply-adds a seen (query, key) pair a head dim; its inputs
//   and outputs are read and written once. This first body runs them on the
//   CUDA cores in fp32 (the fp32 peak is 67 TFLOP/s); the redesign on the
//   tensor cores and bf16 are ROADMAP §2 R18.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BWD_THREADS = 256;
constexpr float NEG_INF = -1e30f;

// A tile of TILE rows and columns (64 at D = 64 and 128, 32 at D = 256):
// RT threads share a tile row, each CPT of its columns
template <int TILE> struct Tiles {
  static constexpr int RT = BWD_THREADS / TILE;
  static constexpr int CPT = TILE / RT;
  static_assert(RT * TILE == BWD_THREADS && CPT * RT == TILE && RT <= 32,
                "a tile row's threads sit in one warp");
};

struct BwdArgs {
  const float *q, *k, *v, *o, *dout;
  float *dq, *dk, *dv, *lse, *delta;
  int bh, sq, sk, group, causal, window;
  float scale;
};

// query row i sees key j (q_offset 0)
__device__ __forceinline__ bool seen(const BwdArgs &a, int i, int j) {
  if (i >= a.sq || j >= a.sk) return false;
  if (a.causal && j > i) return false;
  if (a.window > 0 && j <= i - a.window) return false;
  return true;
}

// whether the query rows [q0, q1] and the keys [k0, k1] hold a seen pair
__device__ __forceinline__ bool tiles_meet(const BwdArgs &a, int q0, int q1,
                                           int k0, int k1) {
  if (a.causal && q1 < k0) return false;
  if (a.window > 0 && q0 - k1 >= a.window) return false;
  return true;
}

// rows [r0, r0 + TILE) of an (n, D) matrix into dst[TILE][D + 1], times
// mul, zeros past row n (consecutive threads on consecutive columns)
template <int D, int TILE>
__device__ __forceinline__ void load_tile(float *dst, const float *src, int r0,
                                          int n, float mul) {
  for (int e = threadIdx.x; e < TILE * D; e += BWD_THREADS) {
    const int row = e / D, col = e % D, s = r0 + row;
    dst[row * (D + 1) + col] = s < n ? src[(size_t)s * D + col] * mul : 0.f;
  }
}

// out[c] = A[r] . B[j + RT c] over D, A and B tiles of [TILE][D + 1]
template <int D, int TILE>
__device__ __forceinline__ void row_dots(float (&out)[Tiles<TILE>::CPT],
                                         const float *A, const float *B,
                                         int r, int j) {
  constexpr int RT = Tiles<TILE>::RT, CPT = Tiles<TILE>::CPT;
#pragma unroll
  for (int c = 0; c < CPT; ++c) out[c] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float ad = A[r * (D + 1) + d];
#pragma unroll
    for (int c = 0; c < CPT; ++c) out[c] += ad * B[(j + RT * c) * (D + 1) + d];
  }
}

// max and sum over the RT threads of a tile row (consecutive lanes)
template <int RT>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < RT; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <int RT>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < RT; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 1. lse and delta of one (bh, query tile)
template <int D, int TILE>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_pre_kernel(const BwdArgs a) {
  constexpr int RT = Tiles<TILE>::RT, CPT = Tiles<TILE>::CPT;
  extern __shared__ float smem[];
  float *Qs = smem;                  // [TILE][D + 1], scaled
  float *Ks = Qs + TILE * (D + 1);   // [TILE][D + 1]
  const int n_qt = (a.sq + TILE - 1) / TILE;
  const int bh = blockIdx.x / n_qt, qt = blockIdx.x % n_qt;
  const int kvh = bh / a.group;
  const int r = threadIdx.x / RT, j = threadIdx.x % RT;
  const int q0 = qt * TILE, q1 = min(q0 + TILE, a.sq) - 1, i = q0 + r;
  const float *k = a.k + (size_t)kvh * a.sk * D;
  load_tile<D, TILE>(Qs, a.q + (size_t)bh * a.sq * D, q0, a.sq, a.scale);

  float m = NEG_INF, l = 0.f;
  const int n_kt = (a.sk + TILE - 1) / TILE;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TILE, k1 = min(k0 + TILE, a.sk) - 1;
    if (!tiles_meet(a, q0, q1, k0, k1)) continue;
    __syncthreads();  // the previous key tile is consumed
    load_tile<D, TILE>(Ks, k, k0, a.sk, 1.f);
    __syncthreads();
    float s[CPT];
    row_dots<D, TILE>(s, Qs, Ks, r, j);
    float tmax = NEG_INF;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      if (!seen(a, i, k0 + j + RT * c)) s[c] = NEG_INF;
      tmax = fmaxf(tmax, s[c]);
    }
    const float m_new = fmaxf(m, row_max<RT>(tmax));
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      psum += s[c] > 0.5f * NEG_INF ? expf(s[c] - m_new) : 0.f;
    l = l * expf(m - m_new) + row_sum<RT>(psum);
    m = m_new;
  }

  float dsum = 0.f;
  if (i < a.sq) {
    const size_t row = ((size_t)bh * a.sq + i) * D;
    for (int d = j; d < D; d += RT) dsum += a.dout[row + d] * a.o[row + d];
  }
  dsum = row_sum<RT>(dsum);
  if (j == 0 && i < a.sq) {
    a.lse[(size_t)bh * a.sq + i] = m + logf(fmaxf(l, 1e-30f));
    a.delta[(size_t)bh * a.sq + i] = dsum;
  }
}

// 2. dK and dV of one (kv head, key tile), over its G query heads
template <int D, int TILE>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_dkdv_kernel(const BwdArgs a) {
  constexpr int RT = Tiles<TILE>::RT, CPT = Tiles<TILE>::CPT;
  extern __shared__ float smem[];
  float *Ks = smem;                    // [TILE][D + 1]
  float *Vs = Ks + TILE * (D + 1);     // [TILE][D + 1]
  float *Qs = Vs + TILE * (D + 1);     // [TILE][D + 1], scaled
  float *dOs = Qs + TILE * (D + 1);    // [TILE][D + 1]
  float *Pt = dOs + TILE * (D + 1);    // [TILE][TILE + 1]: key row, query col
  float *dSt = Pt + TILE * (TILE + 1); // [TILE][TILE + 1]
  float *Ls = dSt + TILE * (TILE + 1); // [TILE] lse of the query tile
  float *Ds = Ls + TILE;               // [TILE] delta of the query tile
  const int n_kt = (a.sk + TILE - 1) / TILE;
  const int kvh = blockIdx.x / n_kt, kt = blockIdx.x % n_kt;
  const int k0 = kt * TILE, k1 = min(k0 + TILE, a.sk) - 1;
  const int kr = threadIdx.x / RT, j = threadIdx.x % RT, jk = k0 + kr;
  load_tile<D, TILE>(Ks, a.k + (size_t)kvh * a.sk * D, k0, a.sk, 1.f);
  load_tile<D, TILE>(Vs, a.v + (size_t)kvh * a.sk * D, k0, a.sk, 1.f);

  float dk[D / RT], dv[D / RT];
#pragma unroll
  for (int x = 0; x < D / RT; ++x) dk[x] = dv[x] = 0.f;

  const int n_qt = (a.sq + TILE - 1) / TILE;
  for (int g = 0; g < a.group; ++g) {
    const int bh = kvh * a.group + g;
    const size_t base = (size_t)bh * a.sq;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * TILE, q1 = min(q0 + TILE, a.sq) - 1;
      if (!tiles_meet(a, q0, q1, k0, k1)) continue;
      __syncthreads();  // the previous query tile is consumed
      load_tile<D, TILE>(Qs, a.q + base * D, q0, a.sq, a.scale);
      load_tile<D, TILE>(dOs, a.dout + base * D, q0, a.sq, 1.f);
      for (int c = threadIdx.x; c < TILE; c += BWD_THREADS) {
        const bool in = q0 + c < a.sq;
        Ls[c] = in ? a.lse[base + q0 + c] : 0.f;
        Ds[c] = in ? a.delta[base + q0 + c] : 0.f;
      }
      __syncthreads();
      float s[CPT], dp[CPT];
      row_dots<D, TILE>(s, Ks, Qs, kr, j);
      row_dots<D, TILE>(dp, Vs, dOs, kr, j);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = j + RT * c;
        const float p =
            seen(a, q0 + col, jk) ? expf(s[c] - Ls[col]) : 0.f;
        Pt[kr * (TILE + 1) + col] = p;
        dSt[kr * (TILE + 1) + col] = p * (dp[c] - Ds[col]);
      }
      __syncthreads();  // a row's P and dS come from its 4 threads
      for (int c = 0; c < TILE; ++c) {
        const float p = Pt[kr * (TILE + 1) + c];
        const float ds = dSt[kr * (TILE + 1) + c];
#pragma unroll
        for (int x = 0; x < D / RT; ++x) {
          const int d = j + RT * x;
          dv[x] += p * dOs[c * (D + 1) + d];
          dk[x] += ds * Qs[c * (D + 1) + d];
        }
      }
    }
  }
  if (jk < a.sk) {
    const size_t row = ((size_t)kvh * a.sk + jk) * D;
#pragma unroll
    for (int x = 0; x < D / RT; ++x) {
      a.dk[row + j + RT * x] = dk[x];
      a.dv[row + j + RT * x] = dv[x];
    }
  }
}

// 3. dQ of one (bh, query tile)
template <int D, int TILE>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int RT = Tiles<TILE>::RT, CPT = Tiles<TILE>::CPT;
  extern __shared__ float smem[];
  float *Qs = smem;                    // [TILE][D + 1], scaled
  float *dOs = Qs + TILE * (D + 1);    // [TILE][D + 1]
  float *Ks = dOs + TILE * (D + 1);    // [TILE][D + 1]
  float *Vs = Ks + TILE * (D + 1);     // [TILE][D + 1]
  float *dSs = Vs + TILE * (D + 1);    // [TILE][TILE + 1]: query row, key col
  const int n_qt = (a.sq + TILE - 1) / TILE;
  const int bh = blockIdx.x / n_qt, qt = blockIdx.x % n_qt;
  const int kvh = bh / a.group;
  const int r = threadIdx.x / RT, j = threadIdx.x % RT;
  const int q0 = qt * TILE, q1 = min(q0 + TILE, a.sq) - 1, i = q0 + r;
  const size_t base = (size_t)bh * a.sq;
  load_tile<D, TILE>(Qs, a.q + base * D, q0, a.sq, a.scale);
  load_tile<D, TILE>(dOs, a.dout + base * D, q0, a.sq, 1.f);
  const float lse = i < a.sq ? a.lse[base + i] : 0.f;
  const float delta = i < a.sq ? a.delta[base + i] : 0.f;
  const float *k = a.k + (size_t)kvh * a.sk * D;
  const float *v = a.v + (size_t)kvh * a.sk * D;

  float dq[D / RT];
#pragma unroll
  for (int x = 0; x < D / RT; ++x) dq[x] = 0.f;
  const int n_kt = (a.sk + TILE - 1) / TILE;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TILE, k1 = min(k0 + TILE, a.sk) - 1;
    if (!tiles_meet(a, q0, q1, k0, k1)) continue;
    __syncthreads();  // the previous key tile is consumed
    load_tile<D, TILE>(Ks, k, k0, a.sk, 1.f);
    load_tile<D, TILE>(Vs, v, k0, a.sk, 1.f);
    __syncthreads();
    float s[CPT], dp[CPT];
    row_dots<D, TILE>(s, Qs, Ks, r, j);
    row_dots<D, TILE>(dp, dOs, Vs, r, j);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = j + RT * c;
      const float p = seen(a, i, k0 + col) ? expf(s[c] - lse) : 0.f;
      dSs[r * (TILE + 1) + col] = p * (dp[c] - delta);
    }
    __syncthreads();
    for (int c = 0; c < TILE; ++c) {
      const float ds = dSs[r * (TILE + 1) + c];
#pragma unroll
      for (int x = 0; x < D / RT; ++x)
        dq[x] += ds * Ks[c * (D + 1) + j + RT * x];
    }
  }
  if (i < a.sq) {
    float *row = a.dq + (base + i) * D;
#pragma unroll
    for (int x = 0; x < D / RT; ++x) row[j + RT * x] = dq[x] * a.scale;
  }
}

template <typename K>
cudaError_t launch_one(K kern, int grid, size_t smem, const BwdArgs &a,
                       cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, BWD_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <int D, int TILE>
int launch_bwd(const BwdArgs &a, cudaStream_t s) {
  const size_t row = sizeof(float) * TILE * (D + 1);
  const size_t pt = sizeof(float) * TILE * (TILE + 1);
  const int n_qt = (a.sq + TILE - 1) / TILE;
  const int n_kt = (a.sk + TILE - 1) / TILE;
  cudaError_t e = launch_one(flash_bwd_pre_kernel<D, TILE>, a.bh * n_qt,
                             2 * row, a, s);
  if (e != cudaSuccess) return (int)e;
  e = launch_one(flash_bwd_dkdv_kernel<D, TILE>, a.bh / a.group * n_kt,
                 4 * row + 2 * pt + 2 * sizeof(float) * TILE, a, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_one(flash_bwd_dq_kernel<D, TILE>, a.bh * n_qt,
                         4 * row + pt, a, s);
}

}  // namespace

extern "C" {

// fp32 (dtype 0) at D = 64, 128 or 256, q_offset 0; lse and delta are
// (bh, sq)
// fp32 workspaces the wrapper allocates
int flash_attention_bwd(const void *q, const void *k, const void *v,
                        const void *o, const void *dout, void *dq, void *dk,
                        void *dv, float *lse, float *delta, int bh, int sq,
                        int sk, int d, int group, int causal, int window,
                        int q_offset, int dtype, void *stream) {
  if (dtype != 0 || q_offset != 0 || bh < 1 || sq < 1 || sk < 1 ||
      group < 1 || bh % group != 0)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{static_cast<const float *>(q),    static_cast<const float *>(k),
            static_cast<const float *>(v),    static_cast<const float *>(o),
            static_cast<const float *>(dout), static_cast<float *>(dq),
            static_cast<float *>(dk),         static_cast<float *>(dv),
            lse,                              delta,
            bh,                               sq,
            sk,                               group,
            causal,                           window,
            1.0f / sqrtf((float)d)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_bwd<64, 64>(a, s);
  if (d == 128) return launch_bwd<128, 64>(a, s);
  if (d == 256) return launch_bwd<256, 32>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
