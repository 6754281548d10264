// Hand-written Hopper (sm_90a) attention kernels of the Bullet serving path,
// behind one plain C interface loaded with ctypes
// (repro_torch/kernels/build.py). Every entry point launches on the stream
// it is given, allocates nothing, and returns cudaGetLastError() after the
// launch (or cudaErrorInvalidValue for a head dim other than HEAD_DIM, the
// one head dim of the models this library serves).
//
// flash_attention_fwd
//   Replaces src/repro/kernels/flash_attention.py:77 `flash_attention`
//   (pl.pallas_call at :95). Causal / sliding-window prefill attention,
//   one CTA per (batch*head, 64-row query tile), an online softmax over
//   32-key tiles, GQA kv head = bh / group. Tails are masked, so any S
//   works. Bound on an H100: operations (4·S²·H·D/2 causal FLOPs per
//   sequence against ~S·(H+2K)·D·2 bytes), i.e. tensor-core rate. This
//   first version runs on the CUDA cores in fp32 (no wgmma yet): it keeps
//   the score and probability tiles in shared memory so no S×S matrix
//   reaches HBM, and skips KV tiles that the causal or window mask removes
//   whole, which halves the work of a causal prompt.
//
// paged_decode_fwd
//   Replaces src/repro/kernels/paged_decode_attention.py:73
//   `paged_decode_attention` (pl.pallas_call at :106). One-token GQA
//   decode over the shared page pool; one CTA per (slot, kv head) reads
//   its page ids from the block table itself and walks only the pages that
//   hold positions <= pos (any n_b). Bound: bytes (every live K/V page is
//   read once; 4·G·D FLOPs per 2·D·2 bytes of KV is far below the card's
//   ~295 FLOP/byte ridge). The design reads each live page once, with
//   neighbouring threads on neighbouring addresses, and packs the G query
//   heads of a kv head into one CTA so a page is read once for all of them.
//
// bullet_attention_paged_fwd
//   Replaces src/repro/kernels/bullet_attention.py:260
//   `bullet_attention_paged` (pl.pallas_call at :305). One persistent
//   launch of n_ctas CTAs, as many as the card holds at once
//   (n_SM x bullet_ctas_per_sm): CTAs [0, n_dec) loop over the decode items
//   and CTAs [n_dec, n_ctas) over the prefill items, so decode_share is a
//   share of the launch's CTAs, n_dec / n_ctas. The hardware places CTAs on
//   SMs itself: nothing pins the decode CTAs to particular SMs (libsmctrl
//   or a %smid check would), so this is the paper's SM partition only
//   while every SM holds the same number of CTAs. Bound: one function over
//   both phases' inputs, max(sum of bytes / HBM rate, sum of operations /
//   peak rate): decode's bytes and prefill's operations can overlap on
//   disjoint CTAs, so the fused launch can beat the two launches' bounds
//   added. Sizing the grid by the occupancy keeps prefill items at the
//   standalone flash kernel's CTAs per SM. Its per-item bodies are the
//   standalone kernels' device functions at the same block size, so its
//   outputs equal flash_attention_fwd + paged_decode_fwd bit for bit.

#include <cmath>

#include "attention.cuh"

using namespace bullet;

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(FlashArgs a) {
  extern __shared__ float smem[];
  flash_item<T, D>(a, blockIdx.x, smem);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    paged_decode_kernel(DecodeArgs a) {
  extern __shared__ float smem[];
  paged_decode_item<T, D>(a, blockIdx.x, smem);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    bullet_kernel(FlashArgs fa, DecodeArgs da, int n_dec) {
  extern __shared__ float smem[];
  const int cta = blockIdx.x;
  if (cta < n_dec) {
    const int n_items = da.b * da.kh;
    for (int item = cta; item < n_items; item += n_dec)
      paged_decode_item<T, D>(da, item, smem);
  } else {
    const int n_pre = gridDim.x - n_dec;
    const int n_items = fa.bh * flash_q_tiles(fa.sq);
    for (int item = cta - n_dec; item < n_items; item += n_pre)
      flash_item<T, D>(fa, item, smem);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
int launch_flash(const FlashArgs &a, cudaStream_t s) {
  const size_t smem = sizeof(float) * flash_smem_floats(D);
  auto kern = flash_kernel<T, D>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = a.bh * flash_q_tiles(a.sq);
  flash_kernel<T, D><<<grid, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_decode(const DecodeArgs &a, cudaStream_t s) {
  const size_t smem = sizeof(float) * decode_smem_floats(a.g, a.ps, D);
  auto kern = paged_decode_kernel<T, D>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  paged_decode_kernel<T, D><<<a.b * a.kh, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

inline size_t bullet_smem(int g, int ps, int d) {
  const size_t f = sizeof(float) * flash_smem_floats(d);
  const size_t dd = sizeof(float) * decode_smem_floats(g, ps, d);
  return f > dd ? f : dd;
}

template <typename T, int D>
int launch_bullet(const FlashArgs &fa, const DecodeArgs &da, int n_dec,
                  int n_ctas, cudaStream_t s) {
  const size_t smem = bullet_smem(da.g, da.ps, D);
  auto kern = bullet_kernel<T, D>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  bullet_kernel<T, D><<<n_ctas, THREADS, smem, s>>>(fa, da, n_dec);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bullet_occupancy(int g, int ps, int *ctas_per_sm) {
  const size_t smem = bullet_smem(g, ps, D);
  auto kern = bullet_kernel<T, D>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, kern, THREADS, smem);
}

// the head dim the library is built for (every model of the serving path
// has D = 128); dtype 0 = float32, 1 = bfloat16
constexpr int HEAD_DIM = 128;
#define DISPATCH(D_, DT_, CALL)                                   \
  do {                                                            \
    if ((D_) != HEAD_DIM) return (int)cudaErrorInvalidValue;      \
    constexpr int D = HEAD_DIM;                                   \
    if ((DT_) == 0) {                                             \
      using T = float;                                            \
      return CALL;                                                \
    }                                                             \
    if ((DT_) == 1) {                                             \
      using T = __nv_bfloat16;                                    \
      return CALL;                                                \
    }                                                             \
    return (int)cudaErrorInvalidValue;                            \
  } while (0)

}  // namespace

extern "C" {

int flash_attention_fwd(const void *q, const void *k, const void *v, void *o,
                        int bh, int sq, int sk, int d, int group, int causal,
                        int window, int dtype, void *stream) {
  FlashArgs a{q, k, v, o, bh, sq, sk, group, causal, window,
              1.0f / sqrtf((float)d)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(d, dtype, (launch_flash<T, D>(a, s)));
}

int paged_decode_fwd(const void *q, const void *k_pages, const void *v_pages,
                     const int *block_tables, const int *pos, void *o, int b,
                     int kh, int g, int d, int ps, int n_b, int dtype,
                     void *stream) {
  DecodeArgs a{q, k_pages, v_pages, block_tables, pos, o, b, kh, g, ps, n_b,
               1.0f / sqrtf((float)d)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(d, dtype, (launch_decode<T, D>(a, s)));
}

int bullet_attention_paged_fwd(
    const void *qp, const void *kp, const void *vp, void *op, int bh, int sp,
    int group, int causal, int window, const void *qd, const void *k_pages,
    const void *v_pages, const int *block_tables, const int *pos, void *od,
    int b, int kh, int g, int ps, int n_b, int d, int dtype, int n_dec,
    int n_ctas, void *stream) {
  const float scale = 1.0f / sqrtf((float)d);
  FlashArgs fa{qp, kp, vp, op, bh, sp, sp, group, causal, window, scale};
  DecodeArgs da{qd, k_pages, v_pages, block_tables, pos, od, b, kh, g, ps,
                n_b, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(d, dtype, (launch_bullet<T, D>(fa, da, n_dec, n_ctas, s)));
}

// CTAs of bullet_kernel one SM holds at once (the persistent grid is this
// times the SM count), for the current device
int bullet_ctas_per_sm(int d, int dtype, int g, int ps, int *ctas_per_sm) {
  DISPATCH(d, dtype, (bullet_occupancy<T, D>(g, ps, ctas_per_sm)));
}

const char *attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
