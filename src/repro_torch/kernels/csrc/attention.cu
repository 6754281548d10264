// Hand-written Hopper (sm_90a) attention kernels of the Bullet serving path,
// behind one plain C interface loaded with ctypes
// (repro_torch/kernels/build.py). Every entry point launches on the stream
// it is given, allocates nothing, and returns cudaGetLastError() after the
// launch (or cudaErrorInvalidValue for a head dim it is not built for).
// flash_attention_fwd and decode_attention_fwd are built for D = 64
// (Granite-3.0-2B, SeamlessM4T-Large-v2's encoder, decoder and
// cross-attention), D = 128 (Qwen3, Llama) and D = 256 (RecurrentGemma's
// sliding-window layers: 10 query heads on one kv head, window 2048);
// paged_decode_fwd and the two fused kernels for D = 64 and 128, the head
// dims of the paged path's models. D = 64 is computed at its own width,
// never padded to 128 (that would double the bytes every decode reads).
//
// flash_attention_fwd
//   Replaces src/repro/kernels/flash_attention.py:77 `flash_attention`
//   (pl.pallas_call at :95). Causal / sliding-window prefill attention,
//   GQA kv head = bh / group. Tails are masked, so any S works. A query
//   offset (the JAX flash_ref_attention's q_offset) places query row i at
//   position q_offset + i among the keys: a chunk of a prompt attends the
//   rows already cached before it (chunked prefill). Bound on an
//   H100: operations (4·S²·H·D/2 causal FLOPs per sequence against
//   ~S·(H+2K)·D·2 bytes), i.e. tensor-core rate. Two bodies, by dtype:
//   - bf16 (flash_tc_item, the design for that bound): one CTA per
//     (batch*head, 128-row query tile), one warpgroup per 64 query rows;
//     S = Q K^T and O += P V on the tensor cores with wgmma (bf16 operands,
//     fp32 accumulators, P rounded to bf16 in registers), K/V tiles of 64
//     keys brought by TMA (128-byte swizzle, zero fill past S) into a
//     2-stage ring behind mbarriers, the online softmax in fp32 registers.
//     The TMA maps are encoded here, on the host, through the runtime's
//     driver entry point (no -lcuda).
//   - fp32 (flash_item, the first port's body, kept so every fp32 gate
//     stays exact): one CTA per 64-row query tile on the CUDA cores, 32-key
//     tiles in shared memory.
//   Both keep the score tiles on chip, so no S×S matrix reaches HBM, and
//   skip the KV tiles that the causal or window mask removes whole.
//   flash_attention_fwd_lse is the bf16 launch of the training forward: an
//   instantiation of its own that also writes each row's log2-sum-exp2,
//   so kernel 1's bf16 backward need not recompute it.
//
// paged_decode_fwd, paged_decode_split_fwd
//   Replace src/repro/kernels/paged_decode_attention.py:73
//   `paged_decode_attention` (pl.pallas_call at :106). One-token GQA
//   decode over the shared page pool: a slot attends its positions <= pos,
//   row r at page bt[b, r / ps], row r % ps (any n_b). Bound: bytes (every
//   live K/V row is read once for all G query heads; 4·G·D FLOPs per 2·D·2
//   bytes of KV is far below the card's ~295 FLOP/byte ridge). Two bodies,
//   by dtype:
//   - bf16 (split_decode_item over the PagedRows source: dense decode's
//     split body, so the two caches share one bf16 decode path): the
//     launch holds n_split pieces per (slot, kv head), one CTA each (the
//     count from the shapes alone, decode_attention.split_count, so the
//     host never reads pos); a slot's own pos + 1 live rows are cut into
//     64-row tiles T and split into min(T / SPLIT_MIN_TILES, n_split)
//     pieces (at least 1; the pieces past them return at once), so a
//     slot's result does not depend on the table's width, nor on the
//     other slots of its launch; a tile's attended rows are its first
//     min(64, pos + 1 - 64·ti), their page ids read by warp 0 one tile
//     ahead, their K/V through cp.async, both products on mma.sync. Its
//     entry is
//     paged_decode_split_fwd (n_split, workspace and counters from the
//     wrapper, as decode_attention_split_fwd); paged_decode_fwd in bf16
//     runs the same body with one piece.
//   - fp32 (paged_decode_item, the first port's body): one CTA per (slot,
//     kv head) walks the live pages one at a time on the CUDA cores. Kept
//     so fp32 paged decode stays bit-equal to fp32 dense decode.
//
// decode_attention_fwd, decode_attention_split_fwd
//   Replace src/repro/kernels/decode_attention.py:62 `decode_attention`
//   (pl.pallas_call at :82). One-token GQA decode over a dense per-slot
//   cache (B, S, K, D), masked by kv_positions (B, S): row j of slot b is
//   attended when 0 <= kv_positions[b, j] <= pos[b], so ring caches (any
//   order of positions, holes of -1) work; any S works (the tail tile is
//   masked, not padded). Bound: bytes (the K/V rows of attended positions,
//   read once for all G query heads). Two bodies, by dtype:
//   - bf16 (split_decode_item, flash-decoding): each (slot, kv head)'s
//     64-row tiles are split into n_split pieces, one CTA each, so a batch
//     of few slots (MQA: B CTAs) still fills the card; a piece reads only
//     its attended rows, 16 bytes a thread, double-buffered, computes both
//     products on the tensor cores (mma.sync, the G <= 16 query heads of a
//     kv head as one 16-row operand), and the last piece of a (slot, kv
//     head) to finish merges the partials in piece order, so the result
//     does not depend on the order the CTAs ran in. Its entry is
//     decode_attention_split_fwd, which takes n_split, the workspace and
//     the counters from the wrapper (no workspace for n_split = 1) and
//     checks the wrapper's tile against SPLIT_TILE;
//     split_decode_ctas_per_sm gives the CTAs an SM holds, which the
//     wrapper's split count sizes its wave with. decode_attention_fwd is
//     the fp32 entry (in bf16 it runs the split body with one piece).
//   - fp32 (decode_item, the first port's body, unsplit): one CTA per
//     (slot, kv head) walks the rows in tiles of DECODE_TILE = 16 and skips
//     a tile none of whose rows is attended (decided from the positions,
//     never from the tile's index). With linear positions it walks
//     paged_decode_fwd's rows in the same 16-row tiles with the same
//     arithmetic, so the two agree bit for bit; in bf16 both caches run
//     split_decode_item, which lists the same rows in the same tiles (the
//     pieces agree where a slot's pieces, from its live rows, are the
//     dense cache's, from its S rows).
//
// bullet_attention_paged_fwd
//   Replaces src/repro/kernels/bullet_attention.py:260
//   `bullet_attention_paged` (pl.pallas_call at :305). One persistent
//   launch partitioned by SM, not by CTA index: each CTA reads %smid, the
//   first CTA to arrive on an SM gives it a dense rank through a table
//   indexed by %smid (SM ids need not be contiguous, so a threshold on
//   %smid itself would miscount), and the SMs of rank < n_dec_sm are
//   decode SMs, the rest prefill SMs, so decode_share is a share of the
//   SMs, n_dec_sm / n_SM. Work comes from two queues, one atomic ticket
//   counter per phase. A CTA of a decode SM takes decode items until that
//   queue is empty and leaves; a CTA of a prefill SM takes prefill items,
//   then decode leftovers. The grid holds as many CTAs as the card runs at
//   once (n_SM x bullet_ctas_per_sm) and, while both phases have work, as
//   many more as the decode SMs hold: these start in the slots the
//   leaving decode CTAs free and take the prefill leftovers. So a decode
//   item never waits behind a prefill item on a decode SM, and no slot
//   idles while an item is queued (work-conserving, as the TPU kernel's
//   schedule appends the leftovers of either stream). Prefill tickets walk
//   the query tiles heaviest first (by the key tiles each attends; heads
//   inner), and the CTAs on an SM take that queue's heavy and light end in
//   turn: the longest causal tiles start first, and not two on one SM
//   (two CTAs share an SM). The tickets, the rank
//   table and a count of the CTAs that have left live in a workspace the
//   wrapper keeps per (device, stream); it is zero at launch and the last
//   CTA to leave zeroes it again, so no launch needs a memset. Where the
//   caller passes a record, each ticket writes what ran it (see Sched).
//   Bound: one function over both phases' inputs, max(sum of bytes / HBM
//   rate, sum of operations / peak rate): decode's bytes and prefill's
//   operations can overlap on disjoint SMs, so the fused launch can beat
//   the two launches' bounds added. Its per-item bodies are the standalone
//   kernels' device functions at the same block size; in bf16 also at the
//   same CTAs per SM (two, as flash_kernel's), while the fp32 kernel's
//   schedule raises its registers above flash_kernel's (two CTAs an SM
//   where the standalone fp32 flash kernel runs three); in bf16 its decode
//   items are the same (slot, kv head, piece) items as the
//   standalone split launch's (the wrapper sizes both with one call), so
//   its outputs equal flash_attention_fwd + the paged decode wrapper's
//   launch bit for bit at every decode_share, whichever CTA ran an item.
//
// bullet_attention_fwd
//   Replaces src/repro/kernels/bullet_attention.py:361 `bullet_attention`
//   (pl.pallas_call at :400): the same persistent launch and schedule with
//   the dense decode body in place of the paged one; its decode items are
//   the standalone split launch's, so its outputs equal
//   flash_attention_fwd + the dense decode wrapper's launch bit for bit at
//   every decode_share. Bound: as bullet_attention_paged_fwd.

#include <cmath>
#include <type_traits>

#include "attention.cuh"

using namespace bullet;

namespace {

using bf16 = __nv_bfloat16;
template <typename T> constexpr bool is_bf16 = std::is_same<T, bf16>::value;

// The per-item bodies by dtype: the fp32 CUDA-core bodies for float, the
// tensor-core flash body and the split decode body (over either cache) for
// bfloat16.
template <typename T, int D>
__device__ __forceinline__ void flash_body(const FlashArgs &a, int item,
                                           unsigned char *smem) {
  if constexpr (is_bf16<T>)
    flash_tc_item<D>(a, item, smem);
  else
    flash_item<T, D>(a, item, reinterpret_cast<float *>(smem));
}

// DA = DecodeArgs (paged cache) or DenseDecodeArgs (dense cache)
template <typename T, int D, typename DA>
__device__ __forceinline__ void decode_body(const DA &a, int item,
                                            unsigned char *smem) {
  if constexpr (is_bf16<T>)
    split_decode_item<D>(a, item, smem);
  else if constexpr (std::is_same<DA, DecodeArgs>::value)
    paged_decode_item<T, D>(a, item, reinterpret_cast<float *>(smem));
  else
    decode_item<T, D>(a, item, reinterpret_cast<float *>(smem));
}

// work items of a decode launch: (slot, kv head), times the pieces of the
// bf16 split body
template <typename T, typename DA>
__host__ __device__ inline int decode_items(const DA &a) {
  return a.b * a.kh * (is_bf16<T> ? a.n_split : 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const __grid_constant__ FlashArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  flash_body<T, D>(a, blockIdx.x, smem);
}

// the bf16 flash body that also writes each row's log2-sum-exp2: the
// forward of kernel 1's gradient (flash_attention_bwd_tc reads it); the
// serving kernels instantiate flash_tc_item without it
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_lse_kernel(const __grid_constant__ FlashArgs a, float *lse2) {
  extern __shared__ __align__(16) unsigned char smem[];
  flash_tc_item<D, true>(a, blockIdx.x, smem, lse2);
}

// the fp32 decode bodies, one CTA per (slot, kv head)
template <typename T, int D, typename DA>
__global__ void __launch_bounds__(THREADS)
    decode_kernel(DA a) {
  extern __shared__ __align__(16) unsigned char smem[];
  decode_body<T, D>(a, blockIdx.x, smem);
}

// the bf16 split body over either cache: at most 128 registers a thread,
// two CTAs an SM
template <int D, typename DA>
__global__ void __launch_bounds__(THREADS, 2)
    split_decode_kernel(DA a) {
  extern __shared__ __align__(16) unsigned char smem[];
  split_decode_item<D>(a, blockIdx.x, smem);
}

// ---- the fused launches' schedule ------------------------------------------

#if !defined(SCHED_SMS)
#error "SCHED_SMS comes from the build (geometry.py)"
#endif

// words of the schedule workspace (SCHED_WORDS in geometry.py): zero at
// launch, zeroed again by the last CTA to leave
constexpr int WS_DEC = 0;       // decode tickets taken
constexpr int WS_PRE = 2;       // prefill tickets taken (64 bits, aligned)
constexpr int WS_LEFT = 4;      // CTAs that have left
constexpr int WS_RANKS = 5;     // SMs ranked
constexpr int WS_ARRIVED = 8;   // per SM id slot: CTAs arrived
constexpr int WS_RANK = 8 + SCHED_SMS;  // per SM id slot: its rank + 1
constexpr int REC = 7;          // ints a record holds per ticket

// A fused launch's schedule. Decode tickets are decode items in order;
// prefill ticket t is query tile j of head t % bh with j = t / bh taken
// from the base order (causal: the last tile first; else the first
// first) with its first tile moved to place `lift`, so the tickets attend
// non-increasing numbers of key tiles (the wrapper's prefill_order
// computes lift and mirrors this map). With a record, ticket t of the
// decode queue (t) or the prefill queue (n_dec + t) writes REC ints: how
// often it was taken, the body's item, the %smid that ran it, that SM's
// rank, 1 if it came from the CTA's own queue, and the low 32 bits of
// %globaltimer (ns) when it was taken and when its CTA asked for the next.
struct Sched {
  int *ws;       // the workspace, SCHED_WORDS ints
  int *record;   // null in serving
  int n_dec_sm;  // SMs of rank < n_dec_sm are decode SMs
  int n_dec, n_pre;  // items of each queue
  int lift;
};

__device__ __forceinline__ int sm_id() {
  int v;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(v));
  return v;
}
__device__ __forceinline__ int n_sm_ids() {
  int v;
  asm volatile("mov.u32 %0, %%nsmid;" : "=r"(v));
  return v;
}
// whether this is thread 0, read afresh: the compiler cannot merge this
// read with the bodies' own reads of threadIdx.x, so the thread index is
// not held in a register across a body (the bf16 bodies fill the kernel's
// 128 registers)
__device__ __forceinline__ bool thread0() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v == 0;
}
__device__ __forceinline__ int now_ns() {
  unsigned long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return (int)(v & 0xffffffffu);
}

// Thread 0's schedule state, in shared memory. sched_enter copies what the
// loops need from the launch's parameters; inside the loops thread 0 reads
// only this copy, which the compiler cannot hoist across the loops'
// barriers, so no address or count of the schedule is held in a register
// across a body (the bf16 bodies fill the kernel's 128 registers).
struct SchedState {
  int *ws, *record;
  int n_dec, n_pre, bh, n_qt, lift, causal;
  int item;   // the body's item to run; -1: the queue is empty
  int own;    // the SM's own phase: 0 decode, 1 prefill
  int dec_left;  // 1: decode tickets were left when the CTA arrived
  int back;   // 1: the CTA takes the prefill queue's light end
  int smid, rank;
  int last;   // the record entry of the CTA's last item; -1: none
};

// thread 0, once per CTA: rank this CTA's SM (the first CTA to arrive on
// it takes the next rank, a later one waits for it: both are resident on
// that SM, so the wait is short), pick its own phase, copy the schedule
template <typename T>
__device__ void sched_enter(const FlashArgs &fa, const Sched &sc,
                            SchedState &st) {
  const int smid = sm_id(), slot = smid % SCHED_SMS;
  int rank;
  const int arrived = atomicAdd(sc.ws + WS_ARRIVED + slot, 1);
  if (arrived == 0) {
    rank = atomicAdd(sc.ws + WS_RANKS, 1);
    atomicExch(sc.ws + WS_RANK + slot, rank + 1);
  } else {
    int v;
    while ((v = atomicAdd(sc.ws + WS_RANK + slot, 0)) == 0) __nanosleep(64);
    rank = v - 1;
  }
  st.ws = sc.ws;
  st.record = sc.record;
  st.n_dec = sc.n_dec;
  st.n_pre = sc.n_pre;
  st.bh = fa.bh;
  st.n_qt = flash_q_tiles<T>(fa.sq);
  st.lift = sc.lift;
  st.causal = fa.causal;
  st.own = rank < sc.n_dec_sm ? 0 : 1;
  st.dec_left = atomicAdd(sc.ws + WS_DEC, 0) < sc.n_dec;
  // prefill from both ends: the CTAs arriving on an SM take the heaviest
  // ticket left and the lightest in turn (first heavy, second light), so
  // two heavy tiles do not share an SM's tensor cores
  st.back = arrived & 1;
  st.smid = smid;
  st.rank = rank;
  st.last = -1;
}

// thread 0: a ticket of `phase`'s queue, or -1 once it is empty. The
// prefill counter's low word counts tickets taken from the heavy end, its
// high word those from the light end; a take is good while the two
// together stay below the queue's length
__device__ __forceinline__ int take(const SchedState &st, int phase) {
  if (phase == 0) {
    const int t = atomicAdd(st.ws + WS_DEC, 1);
    return t < st.n_dec ? t : -1;
  }
  const unsigned long long got = atomicAdd(
      reinterpret_cast<unsigned long long *>(st.ws + WS_PRE),
      st.back ? 1ull << 32 : 1ull);
  const int front = (int)(got & 0xffffffffu), back = (int)(got >> 32);
  if (front + back >= st.n_pre) return -1;
  return st.back ? st.n_pre - 1 - back : front;
}

// the body's item of prefill ticket t: query tile j of head t % bh, j =
// t / bh in the base order with its first tile lifted (see Sched); the
// fp32 body takes item bh * n_qt + qt, the bf16 one bh * n_qt + (n_qt - 1
// - qt)
template <typename T>
__device__ __forceinline__ int prefill_item(const SchedState &st, int t) {
  const int r = t / st.bh, h = t % st.bh;
  const int j = r < st.lift ? r + 1 : (r == st.lift ? 0 : r);
  const int qt = st.causal ? st.n_qt - 1 - j : j;
  return h * st.n_qt + (is_bf16<T> ? st.n_qt - 1 - qt : qt);
}

// thread 0: the next item of `phase`'s queue into st.item (-1 if it is
// empty), written to the record with the end of the CTA's last item
template <typename T>
__device__ void sched_next(SchedState &st, int phase) {
  if (st.record != nullptr && st.last >= 0)
    st.record[REC * st.last + 6] = now_ns();
  const int t = take(st, phase);
  st.last = -1;
  st.item = t < 0 ? -1 : phase == 0 ? t : prefill_item<T>(st, t);
  if (t >= 0 && st.record != nullptr) {
    st.last = phase == 0 ? t : st.n_dec + t;
    int *e = st.record + REC * st.last;
    atomicAdd(e, 1);
    e[1] = st.item;
    e[2] = st.smid;
    e[3] = st.rank;
    e[4] = phase == st.own;
    e[5] = now_ns();
  }
}

// thread 0, once per CTA: the last CTA to leave zeroes the workspace for
// the next launch (every other CTA has taken its last ticket by then)
__device__ void sched_leave(const Sched &sc) {
  __threadfence();
  if (atomicAdd(sc.ws + WS_LEFT, 1) != (int)gridDim.x - 1) return;
  __threadfence();
  const int n = min(n_sm_ids(), SCHED_SMS);
  for (int i = 0; i < n; ++i) {
    sc.ws[WS_ARRIVED + i] = 0;
    sc.ws[WS_RANK + i] = 0;
  }
  for (int i = 0; i < WS_ARRIVED; ++i) sc.ws[i] = 0;
}

// One CTA's items of PHASE's queue until it is empty, in the shared memory
// every item of the CTA uses. Before each item every thread fences its
// generic-proxy accesses to shared memory against the async proxy, so a
// flash_tc_item's TMA writes and mbarriers never race the split decode
// body's stores to the same bytes (and the reverse); each body starts
// with a barrier and flash_tc_item initialises its mbarriers per item.
template <int PHASE, typename T, int D, typename DA>
__device__ __forceinline__ void drain(const FlashArgs &fa, const DA &da,
                                      SchedState &st, unsigned char *smem) {
  for (;;) {
    if (thread0()) sched_next<T>(st, PHASE);
    __syncthreads();
    const int item = st.item;
    __syncthreads();  // read by all before thread 0 writes the next
    if (item < 0) return;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if constexpr (PHASE == 0)
      decode_body<T, D>(da, item, smem);
    else
      flash_body<T, D>(fa, item, smem);
  }
}

// One CTA of a fused launch. A CTA of a decode SM that finds decode
// tickets left takes decode items until that queue is empty, and leaves;
// every other CTA takes prefill items until that queue is empty, then
// decode items. A CTA thus never runs a prefill body after a decode body:
// the bf16 prefill body needs 127 of the kernel's 128 registers, and
// whatever the compiler carries from a decode loop into a prefill loop
// spills. The work still moves: the launch holds, beyond the CTAs the card
// runs at once, as many again as the decode SMs hold (the wrapper sizes
// the grid), and those start in the slots the leaving decode CTAs free,
// find the decode queue empty, and take the prefill leftovers. Each queue
// is empty for good once a take fails.
template <typename T, int D, typename DA>
__device__ __forceinline__ void bullet_body(const FlashArgs &fa, const DA &da,
                                            const Sched &sc,
                                            unsigned char *smem) {
  __shared__ SchedState st;
  if (thread0()) sched_enter<T>(fa, sc, st);
  __syncthreads();
  if (st.own == 0 && st.dec_left) {
    drain<0, T, D>(fa, da, st, smem);
  } else {
    drain<1, T, D>(fa, da, st, smem);
    drain<0, T, D>(fa, da, st, smem);
  }
  if (thread0()) sched_leave(sc);
}

template <typename T, int D, typename DA>
__global__ void __launch_bounds__(THREADS)
    bullet_kernel(const __grid_constant__ FlashArgs fa, DA da,
                  const __grid_constant__ Sched sc) {
  extern __shared__ __align__(16) unsigned char smem[];
  bullet_body<T, D, DA>(fa, da, sc, smem);
}

// bf16: at most 128 registers a thread, so two CTAs share an SM as the
// standalone bf16 flash kernel's do. The decode arguments stay in
// parameter space too (__grid_constant__), so the split body reads them
// where they lie and the kernel fits 128 registers without spilling
template <int D, typename DA>
__global__ void __launch_bounds__(THREADS, 2)
    bullet_tc_kernel(const __grid_constant__ FlashArgs fa,
                     const __grid_constant__ DA da,
                     const __grid_constant__ Sched sc) {
  extern __shared__ __align__(16) unsigned char smem[];
  bullet_body<bf16, D, DA>(fa, da, sc, smem);
}

// the kernel of a dtype: the fp32 ones keep the first port's launch bounds
template <typename T, int D, typename DA> auto decode_fn() {
  if constexpr (is_bf16<T>)
    return split_decode_kernel<D, DA>;
  else
    return decode_kernel<T, D, DA>;
}
template <typename T, int D, typename DA> auto bullet_fn() {
  if constexpr (is_bf16<T>)
    return bullet_tc_kernel<D, DA>;
  else
    return bullet_kernel<T, D, DA>;
}

// ---- TMA maps of the bf16 flash body, encoded on the host -----------------

using EncodeTiled = CUresult (*)(CUtensorMap *, CUtensorMapDataType,
                                 cuuint32_t, void *, const cuuint64_t *,
                                 const cuuint64_t *, const cuuint32_t *,
                                 const cuuint32_t *, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void *p = nullptr;
    cudaDriverEntryPointQueryResult got = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    return e == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (heads, rows, d) bf16 tensor as the 3-D map (d, rows, heads), boxes of
// 64 columns (128 bytes, the swizzle's width) x box_rows rows x 1 head; rows
// past the end of a head are zero-filled
bool encode_heads(CUtensorMap *map, const void *ptr, int d, int rows,
                  int heads, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void *>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the maps flash_tc_item reads (a no-op for fp32); false if one cannot be
// encoded (a base address that is not 16-byte aligned)
template <typename T> bool encode_flash(FlashArgs &a, int d) {
  if constexpr (is_bf16<T>) {
    if (!encode_heads(&a.tq, a.q, d, a.sq, a.bh, TC_BQ)) return false;
    if (a.sk == 0) return true;
    const int kvh = a.bh / a.group;
    return encode_heads(&a.tk, a.k, d, a.sk, kvh, TC_BK) &&
           encode_heads(&a.tv, a.v, d, a.sk, kvh, TC_BK);
  }
  return true;
}

// ---- launches ---------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T> size_t flash_smem(int d) {
  return is_bf16<T> ? (size_t)flash_tc_smem_bytes(d)
                    : sizeof(float) * flash_smem_floats(d);
}
// shared memory of a decode body: the split body's in bf16, else the fp32
// body's tiles (the paged one's are pages of ps rows)
template <typename T> size_t decode_smem(const DecodeArgs &a, int d) {
  return is_bf16<T> ? split_smem_bytes(d)
                    : sizeof(float) * decode_smem_floats(a.g, a.ps, d);
}
template <typename T> size_t decode_smem(const DenseDecodeArgs &a, int d) {
  return is_bf16<T> ? split_smem_bytes(d)
                    : sizeof(float) * decode_smem_floats(a.g, DECODE_TILE, d);
}

// the bf16 split body's launch conditions: a piece count it takes, at most
// SPLIT_G query heads, and for more than one piece the workspace and the
// arrival counters
template <typename T, typename DA> bool split_ok(const DA &a) {
  return !is_bf16<T> ||
         (a.n_split >= 1 && a.n_split <= MAX_SPLIT && a.g <= SPLIT_G &&
          (a.n_split == 1 || (a.ws_acc != nullptr && a.ws_ml != nullptr &&
                              a.counts != nullptr)));
}

template <typename T, int D>
int launch_flash(FlashArgs a, cudaStream_t s) {
  if (!encode_flash<T>(a, D)) return (int)cudaErrorInvalidValue;
  const size_t smem = flash_smem<T>(D);
  auto kern = flash_kernel<T, D>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = a.bh * flash_q_tiles<T>(a.sq);
  flash_kernel<T, D><<<grid, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_flash_lse(FlashArgs a, float *lse2, cudaStream_t s) {
  if (!encode_flash<bf16>(a, D)) return (int)cudaErrorInvalidValue;
  const size_t smem = flash_smem<bf16>(D);
  auto kern = flash_lse_kernel<D>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<a.bh * flash_q_tiles<bf16>(a.sq), THREADS, smem, s>>>(a, lse2);
  return (int)cudaGetLastError();
}

template <typename T, int D, typename DA>
int launch_decode(const DA &a, cudaStream_t s) {
  if (!split_ok<T>(a)) return (int)cudaErrorInvalidValue;
  const size_t smem = decode_smem<T>(a, D);
  auto kern = decode_fn<T, D, DA>();
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<decode_items<T>(a), THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// shared memory of a fused launch: the larger of its two bodies'
template <typename T, typename DA> size_t bullet_smem(const DA &a, int d) {
  const size_t f = flash_smem<T>(d), dd = decode_smem<T>(a, d);
  return f > dd ? f : dd;
}

// the schedule of a fused launch: its queues' lengths from the shapes
template <typename T, typename DA>
Sched make_sched(const FlashArgs &fa, const DA &da, int *ws, int *record,
                 int n_dec_sm, int lift) {
  return Sched{ws, record, n_dec_sm, decode_items<T>(da),
               fa.bh * flash_q_tiles<T>(fa.sq), lift};
}

template <typename T, int D, typename DA>
int launch_bullet(FlashArgs fa, const DA &da, const Sched &sc, int n_ctas,
                  cudaStream_t s) {
  const int n_qt = flash_q_tiles<T>(fa.sq);
  if (!encode_flash<T>(fa, D) || !split_ok<T>(da) || sc.ws == nullptr ||
      reinterpret_cast<uintptr_t>(sc.ws) % 8 != 0 || sc.lift < 0 ||
      (n_qt > 0 && sc.lift >= n_qt))
    return (int)cudaErrorInvalidValue;
  const size_t smem = bullet_smem<T>(da, D);
  auto kern = bullet_fn<T, D, DA>();
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<n_ctas, THREADS, smem, s>>>(fa, da, sc);
  return (int)cudaGetLastError();
}

template <typename T, int D, typename DA>
int bullet_occupancy(const DA &da, int *ctas_per_sm) {
  const size_t smem = bullet_smem<T>(da, D);
  auto kern = bullet_fn<T, D, DA>();
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, kern, THREADS, smem);
}

template <int D, typename DA> int split_occupancy(int *ctas_per_sm) {
  const size_t smem = split_smem_bytes(D);
  auto kern = split_decode_kernel<D, DA>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, kern, THREADS, smem);
}

// dtype 0 = float32, 1 = bfloat16: CALL instantiated for T and head dim D
#define DISPATCH_DTYPE(D_, DT_, CALL)                             \
  do {                                                            \
    constexpr int D = (D_);                                       \
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

// flash prefill and dense decode: D = 64 (Granite, Seamless), 128 (Qwen3,
// Llama) or 256 (RecurrentGemma). At D = 256 the fp32 flash_item's tiles
// take ~140 KB of shared memory and the bf16 flash_tc_item's ~193 KB (one
// CTA per SM, through set_smem's opt-in); flash_tc_item keeps 128 fp32
// accumulators a thread for its 64 x 256 output rows, 32 at D = 64 (where
// its tiles take ~50 KB).
#define DISPATCH(D_, DT_, CALL)                                   \
  do {                                                            \
    if ((D_) == 64) DISPATCH_DTYPE(64, DT_, CALL);                \
    if ((D_) == 128) DISPATCH_DTYPE(128, DT_, CALL);              \
    if ((D_) == 256) DISPATCH_DTYPE(256, DT_, CALL);              \
    return (int)cudaErrorInvalidValue;                            \
  } while (0)

// paged decode and the fused kernels: D = 64 (Granite) and 128
#define DISPATCH_PAGED(D_, DT_, CALL)                             \
  do {                                                            \
    if ((D_) == 64) DISPATCH_DTYPE(64, DT_, CALL);                \
    if ((D_) == 128) DISPATCH_DTYPE(128, DT_, CALL);              \
    return (int)cudaErrorInvalidValue;                            \
  } while (0)

}  // namespace

extern "C" {

// query row i at position q_offset + i among the sk keys (0: the prompt
// itself; a chunk of a prompt: the tokens already cached before it)
int flash_attention_fwd(const void *q, const void *k, const void *v, void *o,
                        int bh, int sq, int sk, int d, int group, int causal,
                        int window, int q_offset, int dtype, void *stream) {
  if (q_offset < 0) return (int)cudaErrorInvalidValue;
  FlashArgs a{q, k, v, o, bh, sq, sk, group, causal, window, q_offset,
              1.0f / sqrtf((float)d)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(d, dtype, (launch_flash<T, D>(a, s)));
}

// bf16, q_offset 0: flash_attention_fwd's bf16 launch that also writes
// each query row's log2-sum-exp2 of its scaled logits to lse2 (bh, sq)
// fp32, for kernel 1's bf16 backward
int flash_attention_fwd_lse(const void *q, const void *k, const void *v,
                            void *o, float *lse2, int bh, int sq, int sk,
                            int d, int group, int causal, int window,
                            void *stream) {
  FlashArgs a{q, k, v, o, bh, sq, sk, group, causal, window, 0,
              1.0f / sqrtf((float)d)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_flash_lse<64>(a, lse2, s);
  if (d == 128) return launch_flash_lse<128>(a, lse2, s);
  if (d == 256) return launch_flash_lse<256>(a, lse2, s);
  return (int)cudaErrorInvalidValue;
}

// one item per (slot, kv head) (in bf16 the split body with one piece)
int paged_decode_fwd(const void *q, const void *k_pages, const void *v_pages,
                     const int *block_tables, const int *pos, void *o, int b,
                     int kh, int g, int d, int ps, int n_b, int dtype,
                     void *stream) {
  if (ps < 1) return (int)cudaErrorInvalidValue;
  DecodeArgs a{q, k_pages, v_pages, block_tables, pos, o, b, kh, g, ps, n_b,
               1.0f / sqrtf((float)d), 1, nullptr, nullptr, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH_PAGED(d, dtype, (launch_decode<T, D>(a, s)));
}

// bf16 only: n_split pieces per (slot, kv head) over the n_b * ps rows of
// the block table in tiles of `tile` rows (the wrapper's constant, which
// must equal SPLIT_TILE); workspace and counters as
// decode_attention_split_fwd
int paged_decode_split_fwd(const void *q, const void *k_pages,
                           const void *v_pages, const int *block_tables,
                           const int *pos, void *o, float *ws_acc,
                           float *ws_ml, int *counts, int b, int kh, int g,
                           int d, int ps, int n_b, int n_split, int tile,
                           int dtype, void *stream) {
  if (dtype != 1 || tile != SPLIT_TILE || ps < 1)
    return (int)cudaErrorInvalidValue;
  DecodeArgs a{q, k_pages, v_pages, block_tables, pos, o, b, kh, g, ps, n_b,
               1.0f / sqrtf((float)d), n_split, ws_acc, ws_ml, counts};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH_PAGED(d, dtype, (launch_decode<T, D>(a, s)));
}

// bf16: the decode items are the paged split launch's, n_split pieces per
// (slot, kv head) with its workspace (null for one piece). The schedule:
// the workspace `sched` (SCHED_WORDS ints, 8-byte aligned, zero at launch
// and left zero), the decode SMs n_dec_sm, the prefill order's lift and
// `record` (null, or REC ints per ticket, zero at launch)
int bullet_attention_paged_fwd(
    const void *qp, const void *kp, const void *vp, void *op, int bh, int sp,
    int group, int causal, int window, const void *qd, const void *k_pages,
    const void *v_pages, const int *block_tables, const int *pos, void *od,
    float *ws_acc, float *ws_ml, int *counts, int b, int kh, int g, int ps,
    int n_b, int d, int dtype, int n_split, int n_ctas, int *sched,
    int *record, int n_dec_sm, int lift, void *stream) {
  if (ps < 1) return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)d);
  FlashArgs fa{qp, kp, vp, op, bh, sp, sp, group, causal, window, 0, scale};
  DecodeArgs da{qd, k_pages, v_pages, block_tables, pos, od, b, kh, g, ps,
                n_b, scale, n_split, ws_acc, ws_ml, counts};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH_PAGED(d, dtype, (launch_bullet<T, D>(
      fa, da,
      make_sched<T>(fa, da, sched, record, n_dec_sm, lift),
      n_ctas, s)));
}

// one item per (slot, kv head) (in bf16 the split body with one piece)
int decode_attention_fwd(const void *q, const void *k, const void *v,
                         const int *kv_positions, const int *pos, void *o,
                         int b, int kh, int g, int d, int s_len, int dtype,
                         void *stream) {
  DenseDecodeArgs a{q, k, v, kv_positions, pos, o, b, kh, g, s_len,
                    1.0f / sqrtf((float)d), 1, nullptr, nullptr, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(d, dtype, (launch_decode<T, D>(a, s)));
}

// bf16 only: n_split pieces per (slot, kv head) over row tiles of `tile`
// rows (the wrapper's constant, which must equal SPLIT_TILE); for
// n_split > 1 the partials go to ws_acc / ws_ml and the arrival counters
// in counts (zero at launch, left zero), for n_split = 1 all three may be
// null
int decode_attention_split_fwd(const void *q, const void *k, const void *v,
                               const int *kv_positions, const int *pos,
                               void *o, float *ws_acc, float *ws_ml,
                               int *counts, int b, int kh, int g, int d,
                               int s_len, int n_split, int tile, int dtype,
                               void *stream) {
  if (dtype != 1 || tile != SPLIT_TILE) return (int)cudaErrorInvalidValue;
  DenseDecodeArgs a{q, k, v, kv_positions, pos, o, b, kh, g, s_len,
                    1.0f / sqrtf((float)d), n_split, ws_acc, ws_ml, counts};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(d, dtype, (launch_decode<T, D>(a, s)));
}

// the paged fused launch over the dense cache (schedule arguments as
// bullet_attention_paged_fwd)
int bullet_attention_fwd(const void *qp, const void *kp, const void *vp,
                         void *op, int bh, int sp, int group, int causal,
                         int window, const void *qd, const void *kd,
                         const void *vd, const int *kv_positions,
                         const int *pos, void *od, float *ws_acc,
                         float *ws_ml, int *counts, int b, int kh, int g,
                         int s_len, int d, int dtype, int n_split,
                         int n_ctas, int *sched, int *record, int n_dec_sm,
                         int lift, void *stream) {
  const float scale = 1.0f / sqrtf((float)d);
  FlashArgs fa{qp, kp, vp, op, bh, sp, sp, group, causal, window, 0, scale};
  DenseDecodeArgs da{qd, kd, vd, kv_positions, pos, od, b, kh, g, s_len,
                     scale, n_split, ws_acc, ws_ml, counts};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH_PAGED(d, dtype, (launch_bullet<T, D>(
      fa, da,
      make_sched<T>(fa, da, sched, record, n_dec_sm, lift),
      n_ctas, s)));
}

// CTAs of the bullet kernel one SM holds at once (the persistent grid is
// this times the SM count), for the current device: the paged variant
// (dense = 0, tiles of ps rows) or the dense one (dense = 1)
int bullet_ctas_per_sm(int d, int dtype, int g, int ps, int dense,
                       int *ctas_per_sm) {
  if (dense) {
    DenseDecodeArgs da{};
    da.g = g;
    DISPATCH_PAGED(d, dtype, (bullet_occupancy<T, D>(da, ctas_per_sm)));
  }
  DecodeArgs da{};
  da.g = g;
  da.ps = ps;
  DISPATCH_PAGED(d, dtype, (bullet_occupancy<T, D>(da, ctas_per_sm)));
}

// CTAs of the bf16 split decode kernel one SM holds at once at head dim d,
// for the current device: over the dense cache (paged = 0; two at D = 128,
// one at D = 256 by its shared memory, at D = 64 as many as its registers
// and ~46 KB allow) or the page pool (paged = 1, D = 64 and 128)
int split_decode_ctas_per_sm(int d, int paged, int *ctas_per_sm) {
  if (paged)
    DISPATCH_PAGED(d, 1, (split_occupancy<D, DecodeArgs>(ctas_per_sm)));
  DISPATCH(d, 1, (split_occupancy<D, DenseDecodeArgs>(ctas_per_sm)));
}

const char *attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
