"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --kernels-only  # build + kernel phases only

Phases, each fatal on failure (non-zero exit, no result line):

1. the card: name and power limit as nvidia-smi reports them;
2. build: the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a;
3. kernels, at the main-path shapes of Qwen3-1.7B (H=16, K=8, G=2, D=128,
   page size 16): each kernel against its plain PyTorch version on the
   card, fp32 (atol 1e-4) and bf16 (atol 2e-2), and the fused bullet
   kernel bit-equal to flash + paged decode at every decode_share of the
   tile table; median times over CUDA events (L2 flushed before each
   launch) beside each kernel's bound and the library yardstick;
4. reference: a 2-layer cut of Qwen3-1.7B at full width, fp32, prefill +
   decode on the card (kernels) against the same on the CPU (plain
   versions);
5. serve: Qwen3-1.7B at full width and depth, bf16, seeded random
   weights, 12 requests through BulletServer fused (the default) with the
   launch counters read around that run, then serial: identical streams;
   then the same requests under the scheduler's defaults (its fused
   share); then a torch.profiler window over 30 fused cycles (device time
   by kernel kind, device busy share).

The second-last line is the kernel table as JSON, the last line the
device summary as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM data-sheet peaks (dense): HBM bytes/s and operations/s by type
HBM_BW = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
H, K, G, D, PS = 16, 8, 2, 128, 16


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Median milliseconds of one call over CUDA events; a 256 MiB buffer
    is rewritten before every timed call so each starts with a cold L2,
    as a layer's attention does in the model."""

    def __init__(self, reps: int = 15):
        self.reps = reps
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple:
    t_b = n_bytes / HBM_BW * 1e3
    t_o = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def esize(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def flash_inputs(gen, bp, s, dtype):
    q = torch.randn(bp * H, s, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(bp * K, s, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(bp * K, s, D, generator=gen, device="cuda").to(dtype)
    return q, k, v


#: decode slots: live contexts (pos + 1) incl. page edges; 0 = inactive
CONTEXTS = (1, 15, 16, 17, 257, 500, 1000, 0)


def decode_inputs(gen, dtype):
    """8 slots over a page pool: mixed contexts, page-edge cases, one
    inactive slot (pos = -1), the table bucketed to a power of two with the
    trash page past each slot's live pages; the trash page holds large
    garbage so any read of it would show."""
    b = len(CONTEXTS)
    need = [-(-c // PS) for c in CONTEXTS]
    n_b = 1 << (max(need) - 1).bit_length()
    n_pages = sum(need) + 8
    trash = n_pages
    kp = torch.randn(n_pages + 1, PS, K, D, generator=gen, device="cuda")
    vp = torch.randn(n_pages + 1, PS, K, D, generator=gen, device="cuda")
    kp[trash] = 1e4
    vp[trash] = -1e4
    perm = torch.randperm(n_pages, generator=gen, device="cuda").cpu()
    bt = np.full((b, n_b), trash, np.int32)
    used = 0
    for i, n in enumerate(need):
        bt[i, :n] = perm[used:used + n].numpy()
        used += n
    pos = torch.tensor([c - 1 for c in CONTEXTS], dtype=torch.int32,
                       device="cuda")
    q = torch.randn(b, K, G, D, generator=gen, device="cuda").to(dtype)
    return (q, kp.to(dtype), vp.to(dtype),
            torch.from_numpy(bt).cuda(), pos)


def flash_cost(bp, s, dtype):
    n_bytes = (2 * bp * H * s * D + 2 * bp * K * s * D) * esize(dtype)
    n_ops = 4 * D * bp * H * s * (s + 1) / 2          # causal pairs
    return n_bytes, n_ops


def decode_cost(q, pos, dtype):
    """What the paged decode function needs for this run's data: the K and
    V rows of every active slot's positions <= pos, q read and the output
    written, the block-table entries of the live pages and pos; the
    scores and the PV product over those rows."""
    live = [int(p) + 1 for p in pos.tolist() if p >= 0]
    tokens = sum(live)
    entries = sum(-(-c // PS) for c in live)
    n_bytes = (2 * tokens * K * D + 2 * q.numel()) * esize(dtype) \
        + 4 * (entries + pos.numel())
    n_ops = 4 * G * D * K * tokens
    return n_bytes, n_ops


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card() -> str:
    check(torch.cuda.is_available(), "no CUDA device")
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    card = res.stdout.strip()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"SMs {torch.cuda.get_device_properties(0).multi_processor_count}")
    return card


def phase_build():
    from repro_torch.kernels import build
    b = build.build()
    lines = [ln.strip() for ln in b.log.splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"build: {b.seconds:.1f} s -> {os.path.relpath(b.path, ROOT)}")
    for ln in lines:
        log(f"  ptxas {ln}")
    build.library()
    return b


def phase_kernels(timer: Timer):
    from repro_torch.core.estimator import HardwareSpec
    from repro_torch.core.resource import ResourceManager
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.kernels import bullet_attention as BA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PD

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    err = {"flash": 0.0, "decode": 0.0, "bullet": 0.0}

    # -- flash: S in {128, 200, 1000}, Bp in {1, 4}, plus a window case
    for dtype in (torch.float32, torch.bfloat16):
        for bp in (1, 4):
            for s, window in ((128, 0), (200, 0), (1000, 0), (200, 17)):
                q, k, v = flash_inputs(gen, bp, s, dtype)
                out = FA.flash_attention(q, k, v, causal=True, window=window,
                                         group=G)
                ref = FA.flash_attention_plain(q, k, v, causal=True,
                                               window=window, group=G)
                torch.cuda.synchronize()
                e = (out.float() - ref.float()).abs().max().item()
                check(math.isfinite(e) and e <= TOL[dtype],
                      f"flash {dtype} Bp={bp} S={s} w={window}: err {e}")
                if dtype == torch.bfloat16:
                    err["flash"] = max(err["flash"], e)
                log(f"flash {str(dtype)[6:]} Bp={bp} S={s} window={window}: "
                    f"max|kernel-plain| = {e:.3e}")

    # -- paged decode: 8 slots, mixed contexts, inactive slot, trash page
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, bt, pos = decode_inputs(gen, dtype)
        out = PD.paged_decode_attention(q, kp, vp, bt, pos)
        ref = PD.paged_decode_attention_plain(q, kp, vp, bt, pos)
        torch.cuda.synchronize()
        act = pos >= 0
        e = (out[act].float() - ref[act].float()).abs().max().item()
        check(math.isfinite(e) and e <= TOL[dtype],
              f"paged decode {dtype}: err {e}")
        check(bool((out[~act] == 0).all()), "inactive slot not zero")
        if dtype == torch.bfloat16:
            err["decode"] = max(err["decode"], e)
        log(f"paged decode {str(dtype)[6:]} contexts {CONTEXTS} n_b "
            f"{bt.shape[1]}: max|kernel-plain| (active) = {e:.3e}, "
            f"inactive slot zeros")

    # -- bullet: every decode_share of the tile table, bit-equal
    rm = ResourceManager(HardwareSpec(), SchedulerConfig().unit_quantum)
    shares = sorted({round(p.decode_share, 6) for p in rm.tile_entries})
    for dtype in (torch.float32, torch.bfloat16):
        qp, kpp, vpp = flash_inputs(gen, 2, 200, dtype)
        qd, kpg, vpg, bt, pos = decode_inputs(gen, dtype)
        fo = FA.flash_attention(qp, kpp, vpp, causal=True, group=G)
        do = PD.paged_decode_attention(qd, kpg, vpg, bt, pos)
        rp, rd = BA.bullet_attention_paged_plain(qp, kpp, vpp, qd, kpg, vpg,
                                                 bt, pos, group=G)
        act = pos >= 0
        for share in shares:
            op, od = BA.bullet_attention_paged(qp, kpp, vpp, qd, kpg, vpg,
                                               bt, pos, decode_share=share,
                                               group=G)
            torch.cuda.synchronize()
            check(torch.equal(op, fo) and torch.equal(od, do),
                  f"bullet {dtype} share {share}: not bit-equal to "
                  "flash + paged decode")
        e = max((op.float() - rp.float()).abs().max().item(),
                (od[act].float() - rd[act].float()).abs().max().item())
        check(math.isfinite(e) and e <= TOL[dtype], f"bullet {dtype}: {e}")
        if dtype == torch.bfloat16:
            err["bullet"] = e
        log(f"bullet {str(dtype)[6:]}: bit-equal to flash + paged decode at "
            f"all {len(shares)} tile-table shares; max|kernel-plain| = "
            f"{e:.3e}")

    # -- timings at the serving shapes (bf16): the longest prompt of the
    # serve phase, its 8-slot decode batch, and the two fused
    dt = torch.bfloat16
    rows = []
    F = torch.nn.functional

    q, k, v = flash_inputs(gen, 1, 1000, dt)
    qs, ks, vs = (t.reshape(1, -1, 1000, D) for t in (q, k, v))
    ks, vs = ks.repeat_interleave(G, 1), vs.repeat_interleave(G, 1)
    nb, no = flash_cost(1, 1000, dt)
    bms, bby = bound_ms(nb, no, dt)
    f_ms = timer(lambda: FA.flash_attention(q, k, v, group=G))
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/attention.cu",
        replaces="src/repro/kernels/flash_attention.py:77",
        ms=f_ms,
        plain_ms=timer(lambda: FA.flash_attention_plain(q, k, v, group=G)),
        bound_ms=bms, bound_by=bby,
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True)),
        max_abs_err=err["flash"], shape="Bp=1 S=1000 H=16 K=8 D=128 bf16"))

    qd, kpg, vpg, bt, pos = decode_inputs(gen, dt)
    nb_d, no_d = decode_cost(qd, pos, dt)
    bms, bby = bound_ms(nb_d, no_d, dt)
    b = qd.shape[0]
    kd = kpg[bt.long()].reshape(b, -1, K, D).transpose(1, 2) \
        .repeat_interleave(G, 1).contiguous()
    vd = vpg[bt.long()].reshape(b, -1, K, D).transpose(1, 2) \
        .repeat_interleave(G, 1).contiguous()
    kvpos = torch.arange(kd.shape[2], device="cuda")
    mask = (kvpos[None, :] <= pos[:, None])[:, None, None, :]
    qsd = qd.reshape(b, H, 1, D)
    rows.append(dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/attention.cu",
        replaces="src/repro/kernels/paged_decode_attention.py:73",
        ms=timer(lambda: PD.paged_decode_attention(qd, kpg, vpg, bt, pos)),
        plain_ms=timer(lambda: PD.paged_decode_attention_plain(
            qd, kpg, vpg, bt, pos)),
        bound_ms=bms, bound_by=bby,
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            qsd, kd, vd, attn_mask=mask)),
        max_abs_err=err["decode"],
        shape=f"8 slots contexts {CONTEXTS} n_b={bt.shape[1]} bf16"))

    share = round(rm.current.decode_share, 6)
    # one function over both phases' inputs: max(sum of bytes / rate,
    # sum of operations / peak)
    bms, bby = bound_ms(nb + nb_d, no + no_d, dt)
    n_ctas = BA.grid_ctas(torch.cuda.current_device(), 1, D, G, PS)
    n_dec = BA.decode_ctas(share, n_ctas, True, True)
    rows.append(dict(
        name="bullet_attention_paged", route="cuda",
        source="src/repro_torch/kernels/csrc/attention.cu",
        replaces="src/repro/kernels/bullet_attention.py:260",
        ms=timer(lambda: BA.bullet_attention_paged(
            q, k, v, qd, kpg, vpg, bt, pos, decode_share=share, group=G)),
        plain_ms=timer(lambda: BA.bullet_attention_paged_plain(
            q, k, v, qd, kpg, vpg, bt, pos, group=G)),
        bound_ms=bms, bound_by=bby, library_ms=None,
        max_abs_err=err["bullet"],
        shape=f"flash Bp=1 S=1000 + decode as above, decode_share={share}: "
              f"{n_dec} of {n_ctas} CTAs decode"))
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}) at {r['shape']}")
    return rows


def phase_reference():
    """Full-width Qwen3-1.7B cut to 2 layers, fp32: prefill + 4 decode
    steps on the card (kernels) against the CPU (plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("qwen3-1.7b"), n_layers=2)
    params = T.init_params(cfg, seed=1, dtype=torch.float32, device="cuda")
    cpu = {k: (tuple({n: t.cpu() for n, t in b.items()} for b in v)
               if k == "blocks" else v.cpu()) for k, v in params.items()}
    s, n_dec = 200, 4
    toks = torch.randint(0, cfg.vocab_size, (1, s),
                         generator=torch.Generator().manual_seed(1))
    n_pages = -(-(s + n_dec) // PS)
    page_map = torch.arange(-(-s // PS), dtype=torch.int32)[None]
    bt = torch.arange(n_pages, dtype=torch.int32)[None]
    worst = 0.0
    outs = {}
    for dev, p in (("cuda", params), ("cpu", cpu)):
        cache = T.init_paged_cache(cfg, n_pages, PS, torch.float32, dev)
        logits, _ = T.prefill(p, toks.to(dev), torch.tensor([s]).to(dev),
                              cache, page_map.to(dev), cfg)
        seq = [logits.float().cpu()]
        tok = logits.argmax(-1)
        for i in range(n_dec):
            logits, _ = T.decode_step(
                p, cache, tok[:, None].to(torch.int32),
                torch.tensor([s + i], dtype=torch.int32, device=dev), cfg,
                block_tables=bt.to(dev))
            seq.append(logits.float().cpu())
            tok = logits.argmax(-1)
        outs[dev] = seq
    for a, b in zip(outs["cuda"], outs["cpu"]):
        a, b = a[:, :cfg.vocab_size], b[:, :cfg.vocab_size]   # real vocab
        check(bool(torch.isfinite(a).all()), "non-finite logits on the card")
        e = (a - b).abs().max().item()
        scale = max(1.0, b.abs().max().item())
        check(e <= 1e-3 * scale, f"card vs CPU logits differ by {e}")
        check(bool((a.argmax(-1) == b.argmax(-1)).all()), "argmax differs")
        worst = max(worst, e / scale)
    log(f"reference: 2-layer full-width Qwen3-1.7B fp32, prefill S={s} + "
        f"{n_dec} decode steps, card vs CPU max rel logit err {worst:.2e}")


def _serve(cfg, params, prompts, outs, arrivals, fused: bool,
           profile=None, default_sched: bool = False):
    """Serve the requests, each released when the virtual clock reaches its
    arrival. The clock advances by the H100 estimator's price of each cycle
    (as the JAX package's virtual replay does), so the scheduler's
    decisions do not depend on this run's wall time; throughput is timed
    on the wall clock. One prompt per prefill batch keeps each request's
    prefill shapes, and so its bf16 numerics, independent of which requests
    happen to be admitted together, so fused and serial runs can be
    compared token for token. As in tests/test_fused.py the §3.3.3 decode
    pause is off (max_decode_pause_cycles=0): with a 150 ms TPOT SLO and
    millisecond decode steps the scheduler would otherwise borrow the card
    for prefill 48 cycles out of 49, and the run would barely reach the
    fused path it exists to drive. ``default_sched=True`` serves with the
    scheduler's defaults instead (pause on, up to 4 prompts per prefill
    batch), to show how often the default configuration fuses.

    ``profile=(first, n)`` traces cycles [first, first + n) with
    torch.profiler and returns the profiler and the window's wall time
    in place of the cycle count."""
    from repro_torch.core.config import ControlConfig, ExecConfig, ServerConfig
    from repro_torch.core.engine import BulletServer
    from repro_torch.core.estimator import predict_cycle
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.serving.request import SLO, Request

    if default_sched:
        config = ServerConfig(slo=SLO(3.0, 150.0), max_slots=8, max_len=1152,
                              dtype=torch.bfloat16,
                              execution=ExecConfig(fused=fused))
    else:
        config = ServerConfig(
            slo=SLO(3.0, 150.0), max_slots=8, max_len=1152,
            max_prefill_batch=1, dtype=torch.bfloat16,
            execution=ExecConfig(fused=fused),
            control=ControlConfig(
                sched=SchedulerConfig(max_decode_pause_cycles=0)))
    server = BulletServer(cfg, params, config=config, device="cuda")
    queue = sorted(zip(arrivals, range(len(prompts))))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    now, cycles = 0.0, 0
    prof, window = None, None
    while queue or not server.idle:
        check(cycles < 20_000, "serve did not drain")
        while queue and queue[0][0] <= now:
            arrival, rid = queue.pop(0)
            server.submit(Request(rid=rid, arrival=arrival,
                                  prompt_len=len(prompts[rid]),
                                  output_len=outs[rid]), prompts[rid])
        if server.idle:
            now = queue[0][0]
            continue
        if profile and cycles == profile[0]:
            torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            tw = time.perf_counter()
        server.step(now)
        server.check_invariants()
        obs = server.last_cycle_observation()
        now += predict_cycle(server.est, server.cfg, obs) if obs else 1e-4
        cycles += 1
        if prof is not None and window is None \
                and cycles == profile[0] + profile[1]:
            torch.cuda.synchronize()
            window = time.perf_counter() - tw
            prof.__exit__(None, None, None)
    torch.cuda.synchronize()
    if profile:
        check(window is not None, "the serve ended before the profile window")
        return server, prof, window
    return server, time.perf_counter() - t0, cycles


def _kernel_kind(name: str) -> str:
    if any(k in name for k in ("flash_kernel", "paged_decode_kernel",
                               "bullet_kernel")):
        return "attention (this port's kernels)"
    if any(k in name.lower() for k in ("gemm", "nvjet", "cutlass", "xmma")):
        return "GEMM (cuBLAS)"
    return "other (elementwise, norms, copies, index ops)"


def phase_profile(cfg, params, prompts, outs, arrivals, card: str):
    """Where the time goes in steady fused serving: device time by kernel
    kind over 30 cycles of the serve workload, and the device's busy share
    of that window's wall time."""
    server, prof, wall = _serve(cfg, params, prompts, outs, arrivals,
                                fused=True, profile=(150, 30))
    kinds, names = {}, []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): the operators that
        # launched them report the same time again
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = e.device_time_total                                  # us
        if t <= 0:
            continue
        kinds[_kernel_kind(e.key)] = kinds.get(_kernel_kind(e.key), 0.0) + t
        names.append((t, e.count, e.key))
    busy = sum(kinds.values()) / 1e3
    check(busy > 0, "the profiler saw no device time")
    log(f"profile: 30 fused-serving cycles, wall {wall * 1e3:.1f} ms, "
        f"device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%)  "
        f"[{card}]")
    for kind, t in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"  {kind}: {t / 1e3:.2f} ms ({100 * t / 1e3 / busy:.1f}% of "
            f"device time)")
    for t, count, name in sorted(names, reverse=True)[:8]:
        log(f"  {t / 1e3:8.2f} ms {count:6d}x {name[:90]}")


def phase_serve(card: str):
    from repro_torch.configs import get_config
    from repro_torch.kernels import bullet_attention as BA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PD
    from repro_torch.models import transformer as T

    cfg = get_config("qwen3-1.7b")
    check(cfg.n_layers == 28 and cfg.d_model == 2048 and cfg.n_heads == 16
          and cfg.n_kv_heads == 8 and cfg.vocab_size == 151936,
          "not the full Qwen3-1.7B config")
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(0)
    n = 12
    prompt_lens = rng.integers(64, 1025, n)
    out_lens = rng.integers(16, 65, n)
    prompts = [rng.integers(0, cfg.vocab_size, int(L)).astype(np.int32)
               for L in prompt_lens]
    # Poisson arrivals, 20 ms apart on average on the virtual clock: a
    # choice of this smoke test that keeps prefill and decode co-resident,
    # not a rate measured from any trace
    arrivals = np.cumsum(rng.exponential(0.02, n)).tolist()
    log(f"serve: qwen3-1.7b full width/depth bf16, {n} requests, prompts "
        f"{prompt_lens.tolist()}, outputs {out_lens.tolist()}, arrivals "
        f"every {arrivals[-1] / n * 1e3:.1f} ms on average (virtual clock)")
    # warm-up: cuBLAS handles and kernel modules load outside the timing
    _serve(cfg, params, prompts[:2], [2, 2], [0.0, 0.0], fused=True)

    FA.launches = PD.launches = BA.launches = 0
    server, secs, cycles = _serve(cfg, params, prompts, out_lens.tolist(),
                                  arrivals, fused=True)
    launches = {"flash_attention": FA.launches,
                "paged_decode_attention": PD.launches,
                "bullet_attention_paged": BA.launches}
    st = server.stats
    for rid, o in enumerate(out_lens.tolist()):
        got = server.outputs.get(rid, [])
        check(len(got) == o, f"request {rid}: {len(got)} tokens, want {o}")
        check(all(0 <= t < cfg.vocab_size for t in got),
              f"request {rid}: token out of vocab")
    check(server.pool.available_blocks == server.pool.n_blocks,
          "KV pool not clean")
    check(st.fused_cycles > 0, "no fused cycle ran")
    for name, c in launches.items():
        check(c > 0, f"{name} never launched on the main path")
    n_tok = int(sum(out_lens))
    log(f"serve fused: {n_tok} tokens in {secs:.3f} s = "
        f"{n_tok / secs:.1f} tok/s, {cycles} cycles, stats {vars(st)}, "
        f"launches {launches}, KV pool clean: True  [{card}]")

    serial, s_secs, s_cycles = _serve(cfg, params, prompts,
                                      out_lens.tolist(), arrivals,
                                      fused=False)
    check(serial.stats.fused_cycles == 0, "serial run fused")
    for rid in range(n):
        check(serial.outputs[rid] == server.outputs[rid],
              f"request {rid}: fused and serial token streams differ")
    log(f"serve serial: {n_tok / s_secs:.1f} tok/s, {s_cycles} cycles; "
        f"token streams identical to fused  [{card}]")

    # the scheduler's defaults on the same requests: how often they fuse
    BA.launches = 0
    dflt, d_secs, d_cycles = _serve(cfg, params, prompts, out_lens.tolist(),
                                    arrivals, fused=True, default_sched=True)
    for rid, o in enumerate(out_lens.tolist()):
        check(len(dflt.outputs.get(rid, [])) == o,
              f"default scheduler: request {rid} unfinished")
    log(f"serve default scheduler (pause on, max_prefill_batch 4): "
        f"{n_tok / d_secs:.1f} tok/s, {dflt.stats.fused_cycles} of "
        f"{d_cycles} cycles fused, bullet launches {BA.launches}  [{card}]")
    phase_profile(cfg, params, prompts, out_lens.tolist(), arrivals, card)
    return launches, n_tok / secs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels, skip the model phases")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_card()
    phase_build()
    rows = phase_kernels(Timer())
    if args.kernels_only:
        return 0
    phase_reference()
    launches, _ = phase_serve(card)
    for r in rows:
        r["launches"] = launches[r["name"]]
    log(f"{card}")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
