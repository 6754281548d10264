"""Probe kernel 1's fp32 backward (``csrc/flash_attention_bwd.cu``) on one
CUDA card.

    python3 scripts/bwd_probe.py

Prints the card's name and power limit, then:

1. what a warp's 16-byte shared-memory load (``LDS.128``) costs by its
   address pattern: 8 warps an SM, each 16 independent loads an
   iteration, cycles a warp-load across the SM; the patterns are those of
   the backward's score products (8 distinct (row, share) addresses in
   each quarter-warp for one operand, 2 for the other) beside uniform and
   all-distinct loads;
2. at each ``chip_smoke.BWD_SHAPES`` shape, from a copy of the source with
   ``clock64`` marks (built here by nvcc, beside the library), the mean
   cycles a dK/dV item and a dQ key tile spend in each phase, for the
   first thread of each group of 4 warps (group A: S, P, dV; group B: dP,
   dS, dK), and each launch's device time from torch.profiler.

The marks are placed by text: a change to the marked lines of the source
fails here with the line it could not find. Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "build", "bwd_probe")

LDS = r'''
#include <cstdio>
__device__ int pick(int p, int lane) {
  switch (p) {
    case 0: return lane;                         // 32 distinct
    case 1: return lane % 8;                     // 8 in every quarter
    case 2: return (lane % 2) + 2 * (lane / 8);  // 2 in every quarter
    case 3: return lane % 4;                     // 4 in every quarter
    default: return 0;                           // uniform
  }
}
__global__ void bench(float *out, long long *cyc, int p, int iters) {
  __shared__ float4 buf[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    buf[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int idx = pick(p, threadIdx.x % 32);
  float4 a[16];
  for (int u = 0; u < 16; ++u) a[u] = make_float4(0, 0, 0, 0);
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const float4 v = buf[(idx + 32 * u + it) & 1023];
      a[u].x += v.x; a[u].y += v.y; a[u].z += v.z; a[u].w += v.w;
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0;
  for (int u = 0; u < 16; ++u) s += a[u].x + a[u].y + a[u].z + a[u].w;
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}
int main() {
  float *out; long long *cyc;
  cudaMalloc(&out, 132 * 256 * 4);
  cudaMalloc(&cyc, 132 * 8);
  const char *names[] = {"32 distinct", "8 a quarter-warp (score A)",
                         "2 a quarter-warp (score B)", "4 a quarter-warp",
                         "uniform"};
  for (int p = 0; p < 5; ++p) {
    const int iters = 2000;
    bench<<<132, 256>>>(out, cyc, p, iters);
    long long h[132];
    cudaMemcpy(h, cyc, sizeof(h), cudaMemcpyDeviceToHost);
    double m = 0;
    for (int i = 0; i < 132; ++i) m += h[i];
    printf("LDS.128, %s: %.2f cycles a warp-load\n", names[p],
           m / 132 / (iters * 16.0 * 8));
  }
  return 0;
}
'''

#: the marks: (line of the source, what to put after it); PROF(kind, n)
#: adds the cycles since the last mark to phase n of the kind (0 dK/dV, 1
#: dQ) for the thread
HEAD = '''
__device__ unsigned long long g_prof[2][2][8];
__device__ unsigned long long g_items[2];
#define PROF(kind, ph) { const long long n_ = clock64(); \\
  if (threadIdx.x % 128 == 0) atomicAdd(&g_prof[kind][threadIdx.x / 128][ph], \\
      (unsigned long long)(n_ - t_)); t_ = n_; }
namespace {
'''
MARKS = [
    ("namespace {\n\nconstexpr int THREADS", HEAD + "\nconstexpr int THREADS",
     True),
    ("      cp_async_wait<0>();  // this item's tiles have landed\n",
     "      long long t_ = clock64();\n"
     "      if (threadIdx.x == 0) atomicAdd(&g_items[0], 1ull);\n", False),
    ("      __syncthreads();     // ... for all; the previous item is "
     "consumed\n", "      PROF(0, 0)\n", False),
    ("      score_block<D>(s, grp ? Vs : Ks, grp ? dOs : Qs, ab, bb, h);\n",
     "      PROF(0, 1)\n", False),
    ("      __syncthreads();  // P is in place; K and V are read\n",
     "      PROF(0, 3)\n", False),
    ("        group_b_sync();  // dS is in place for group B\n      }\n",
     "      PROF(0, 4)\n", False),
    ("                   sh * T / G::KVSH, (sh + 1) * T / G::KVSH);\n",
     "      PROF(0, 5)\n", False),
    ("    cp_async_wait<0>();  // K(kt), V(kt) have landed\n",
     "    long long t_ = clock64();\n"
     "    if (threadIdx.x == 0) atomicAdd(&g_items[1], 1ull);\n", False),
    ("    __syncthreads();     // ... for all; tile kt - 1 is consumed\n",
     "    PROF(1, 0)\n", False),
    ("    score_block<D>(s, grp ? dOs : Qs, grp ? Vs : Ks, ab, bb, h);\n",
     "    PROF(1, 1)\n", False),
    ("    __syncthreads();  // dS is in place\n", "    PROF(1, 3)\n", False),
    ("    acc_block<D>(acc, dSt, Ks, 8 * rb, cb, sh * T / G::QSH,\n"
     "                 (sh + 1) * T / G::QSH);\n", "    PROF(1, 4)\n", False),
    ('extern "C" {\n', 'extern "C" {\n'
     "int prof_read(void *dst) {\n"
     "  cudaMemcpyFromSymbol(dst, g_prof, sizeof(g_prof));\n"
     "  return (int)cudaMemcpyFromSymbol((char *)dst + sizeof(g_prof), "
     "g_items, sizeof(g_items));\n}\n"
     "int prof_zero() {\n"
     "  static unsigned long long z[2 * 2 * 8 + 2] = {};\n"
     "  cudaMemcpyToSymbol(g_prof, z, sizeof(g_prof));\n"
     "  return (int)cudaMemcpyToSymbol(g_items, z, sizeof(g_items));\n}\n",
     True),
]
#: the phases each mark closes (the P epilogue's mark sits before the
#: barrier that publishes P, so the wait there opens the next phase)
PHASES = (("wait and top barrier", "score product", "-",
           "P epilogue (A) / wait for P (B)",
           "dS epilogue and group B's barrier", "accumulate"),
          ("wait and top barrier", "score product", "-",
           "P, dS epilogues and barriers", "accumulate"))


def instrumented(src: str) -> str:
    """The source with the marks in place."""
    for line, add, replace in MARKS:
        if src.count(line) != 1:
            raise SystemExit(f"bwd_probe: the mark's line is not found "
                             f"once: {line!r}")
        src = src.replace(line, add if replace else line + add)
    return src


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from repro_torch.kernels import build, geometry
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA

    CS.phase_card()
    os.makedirs(OUT, exist_ok=True)
    nvcc = build._nvcc()
    lds = os.path.join(OUT, "lds")
    open(lds + ".cu", "w").write(LDS)
    subprocess.run([nvcc, "-gencode", build.ARCH, "-O3", "-o", lds,
                    lds + ".cu"], check=True)
    print(subprocess.run([lds], capture_output=True, text=True,
                         check=True).stdout, end="", flush=True)

    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    cu = os.path.join(OUT, "bwd.cu")
    open(cu, "w").write(instrumented(src))
    lib_path = os.path.join(OUT, "bwd.so")
    subprocess.run([nvcc, "-gencode", build.ARCH, "-std=c++17", "-O3",
                    *(f"-D{k}={v}" for k, v in
                      sorted(geometry.all_defines().items())),
                    "-I", str(build.CSRC), "-Xcompiler", "-fPIC", "-shared",
                    "-o", lib_path, cu], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.flash_attention_bwd.argtypes = build.SIGNATURES[
        "flash_attention_bwd"]
    build.library()
    buf = (ctypes.c_ulonglong * 34)()
    gen = torch.Generator(device="cuda").manual_seed(26)
    for name, b, sq, sk, h, kh, d, causal, window in CS.BWD_SHAPES:
        g = h // kh
        q, k, v = CS.flash_inputs(gen, b, sq, torch.float32, h, kh, d, sk)
        do = torch.randn(q.shape, generator=gen, device="cuda")
        kw = dict(causal=causal, window=window, group=g)
        o, lse = FA._forward_lse(q, k, v, **kw)
        bh = q.shape[0]
        split = FA.bwd_split(sq, sk, g, bh // g, causal, window,
                             DA.sm_count(0), geometry.rt_bwd_tile(d))
        grads = [torch.empty_like(t) for t in (q, k, v)]
        delta = torch.empty(bh, sq, device="cuda")
        part = (torch.empty(2, split, bh // g, sk, d, device="cuda")
                if split > 1 else None)

        def call():
            return lib.flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), *(t.data_ptr() for t in grads),
                lse.data_ptr(), delta.data_ptr(),
                None if part is None else part.data_ptr(), bh, sq, sk, d, g,
                int(causal), int(window), split, build.stream_of(q))
        lib.prof_zero()
        build.check(call(), "flash_attention_bwd (marked)")
        torch.cuda.synchronize()
        lib.prof_read(buf)
        vals, items = list(buf), list(buf)[32:34]
        print(f"{name}: {items[0]} dK/dV items, {items[1]} dQ key tiles; "
              f"split {split}", flush=True)
        for kind in (0, 1):
            n = max(items[kind], 1)
            for grp in (0, 1):
                ph = vals[kind * 16 + grp * 8:kind * 16 + grp * 8 + 6]
                print(f"  {'dK/dV' if kind == 0 else 'dQ'} group "
                      f"{'AB'[grp]}: {sum(ph) / n:.0f} cycles an item: "
                      + ", ".join(f"{p} {x / n:.0f}"
                                  for p, x in zip(PHASES[kind], ph)
                                  if p != "-"), flush=True)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                FA.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
            torch.cuda.synchronize()
        print("  device us a call: " + ", ".join(
            f"{re.search(r'flash_\w+', e.key).group(0)} "
            f"{e.device_time_total / 10:.1f}"
            for e in prof.key_averages()
            if e.device_time_total and "flash_" in e.key), flush=True)
        del q, k, v, do, o, lse, grads, delta, part
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
