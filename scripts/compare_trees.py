"""Compare two checkouts of the port on one CUDA card, in turns.

    python3 scripts/compare_trees.py OTHER_CHECKOUT
    python3 scripts/compare_trees.py OTHER_CHECKOUT --windows
    python3 scripts/compare_trees.py OTHER_CHECKOUT --bwd

``--bwd`` runs only ``bwd`` (kernel 1's fp32 backward at
``chip_smoke.BWD_SHAPES``, the training and serving fp32 forwards there,
and the fp32 train steps of ``BWD_TRAIN``) of each checkout, in the order
other, this, this, other, prints every number per turn, and which kernels'
machine code differs between the two built libraries.

``--windows`` runs only ``windows`` (the serve, Mamba-2 and
RecurrentGemma decode paths with their profile windows, see there) of
each checkout, in the order other, this, this, other, and prints every
number per turn. Without it:

Runs, in the order other, this, this, other: ``chip_smoke.py
--kernels-only`` of each checkout (each builds its own kernels under its
own ``build/``), then a dump of the SSD scan's outputs on seeded inputs at
Mamba-2-2.7B's shapes (fp32 and bf16; B in {1, 4}, S in {1000, 200}) and
of flash prefill at the serving shape (S=1000, 16 heads on 8, both
dtypes) through that checkout's wrappers, then the fused kernels 3 and 5
through that checkout's wrappers, timed by the same code for both
(``fused``), in bf16 and fp32: at the serving shape (``chip_smoke.py``'s
flash Bp=1 S=1000 with its 8-slot paged and dense decode batches,
decode_share 0.5) beside flash + paged decode launched apart, each as the
card's time alone (this checkout's ``chip_smoke.Timer``, which holds
the stream busy while the host enqueues, so the events bracket the
kernel and not the wrapper's Python),
torch.profiler's device µs per launch, and the wrapper's host µs per
call (``host_us``), as are flash, paged decode and dense decode alone at
that shape; the paged one at the serving shape over ``SHARES``;
the dense one over the colocated shape's shares beside its two kernels
launched apart; and, where the wrapper records its launch, item spans of
recorded launches (``spans``). Prints every kernel row's time
per turn; for each SSD and flash case whether the outputs are bit-equal
between the checkouts and between the two turns of each; the fused
timings per turn; and which kernels' machine code (``cuobjdump -sass`` of
the two built libraries) differs. Logs go to ``OUT`` (a ``compare/``
folder in the checkout's output directory), the dumps to
``build/compare/``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out", "compare")
DUMPS = os.path.join(ROOT, "build", "compare")
CASES = ((1, 1000), (4, 1000), (4, 200), (1, 200))
#: decode_share values of the paged fused kernel's sweep at the serving
#: shape: chip_smoke.py's SWEEP_SHARES and the shares (of 132 SMs) at which
#: its serve and replay (a) ran their fused cycles most often
SHARES = (0.0, 0.0606, 0.0909, 0.1, 0.1212, 0.25, 0.3182, 0.4697, 0.5,
          0.6515, 0.75, 0.9, 1.0)
#: recorded launches whose spans' medians ``fused`` reports
RECORDED = 5


def dump(tree: str, path: str) -> None:
    """Seeded SSD scan and flash prefill outputs of ``tree``'s wrappers,
    saved to ``path`` (run in a process of its own, with ``tree/src``
    first on the path)."""
    import torch
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as SK
    assert SK.__file__.startswith(tree), SK.__file__
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(7)
        q, k, v = (torch.randn(n, 1000, 128, generator=gen,
                               device="cuda").to(dtype) for n in (16, 8, 8))
        out[f"flash {str(dtype)[6:]} S=1000"] = (
            FA.flash_attention(q, k, v, group=2).cpu(),)
    for dtype in (torch.float32, torch.bfloat16):
        for b, s in CASES:
            gen = torch.Generator(device="cuda").manual_seed(1000 * b + s)

            def rn(*shape):
                return torch.randn(*shape, generator=gen, device="cuda")
            x = rn(b, s, 80, 64).to(dtype)
            dt = torch.nn.functional.softplus(rn(b, s, 80))
            u = torch.rand(80, generator=gen, device="cuda") * 0.8 + 0.1
            A = -torch.exp(torch.log(u / (1 - u)))
            xw, cum, bm, cm = ops.ssd_chunk_inputs(
                x, dt, A, rn(b, s, 128).to(dtype), rn(b, s, 128).to(dtype),
                chunk=256)
            y, st = SK.ssd_scan(xw, cum, bm, cm)
            torch.cuda.synchronize()
            out[f"ssd_scan {str(dtype)[6:]} B={b} S={s}"] = (y.cpu(),
                                                              st.cpu())
    torch.save(out, path)


def smoke_module():
    """This checkout's ``chip_smoke.py``, loaded from its file under another
    name, so the same timing and driving code serves both checkouts: call
    it before the other checkout's modules are imported and put on the
    path (chip_smoke.py puts its own ``src`` first on the path)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "compare_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def use_tree(tree: str) -> None:
    """Put ``tree``'s ``src`` first on the path and drop every
    ``repro_torch`` module imported so far (this checkout's
    ``chip_smoke.py`` imports the package where ``smoke_module`` loads
    it), so that the next import of the package is ``tree``'s."""
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, os.path.join(tree, "src"))


def smoke_timer():
    """This checkout's ``chip_smoke.Timer`` (see ``smoke_module``)."""
    return smoke_module().Timer()


def profiled_us(fn, key: str, n: int = 20) -> float:
    """Device µs per launch of the kernels whose name holds ``key``."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    tot = 0.0
    for ev in prof.key_averages():
        if key in ev.key:
            tot += getattr(ev, "device_time_total", None) or \
                ev.cuda_time_total
    return tot / n


def host_us(fn, n: int = 20, batches: int = 25) -> float:
    """The wrapper's host µs per call: the least over ``batches`` of n
    calls enqueued back to back, each batch started on an idle card (the
    least, since the host's cores are shared and a batch the OS
    interrupts reads long)."""
    import torch
    fn()
    times = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return min(times)


def spans(sched) -> dict:
    """µs from the first item's start, read from one recorded launch's
    %globaltimer stamps: its span, the end of its last decode item, and
    its longest prefill item."""
    rec = sched.record.cpu().long()
    t0 = int(rec[:, 5].min())
    start = (rec[:, 5] - t0) % (1 << 32)
    end = (rec[:, 6] - t0) % (1 << 32)
    pre = slice(sched.n_dec, len(rec))
    return {"span": int(end.max()) / 1e3,
            "decode end": int(end[:sched.n_dec].max()) / 1e3,
            "longest prefill item": int((end[pre] - start[pre]).max()) / 1e3}


def fused(tree: str, path: str) -> None:
    """The fused kernels of ``tree``'s wrappers, timed by the same code
    for both checkouts (``smoke_timer``, ``profiled_us``, ``host_us``; run
    in a process of its own, with ``tree`` and its ``src`` first on the
    path), saved to ``path`` as JSON. Where the checkout's wrapper
    records its launch, also the medians of ``spans`` over RECORDED
    launches at the serving shape, bf16, share 0.5."""
    import torch
    timer = smoke_timer()
    use_tree(tree)
    sys.path.insert(0, tree)
    import chip_smoke as CS
    from repro_torch.kernels import bullet_attention as BA
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PD
    assert BA.__file__.startswith(tree) and CS.__file__.startswith(tree)

    def device_ms(fn):
        return timer(fn)
    G, h, kh, d = CS.G, CS.H, CS.K, CS.D
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        tag = str(dt)[6:]
        gen = torch.Generator(device="cuda").manual_seed(18)
        q, k, v = CS.flash_inputs(gen, 1, CS.MAX_LEN, dt)
        dec = CS.decode_inputs(gen, dt)
        dense = CS.dense_inputs(gen, dt, False)
        for name, fn, key in (
                ("bullet_attention_paged", lambda: BA.bullet_attention_paged(
                    q, k, v, *dec, decode_share=0.5, group=G), "bullet"),
                ("bullet_attention", lambda: BA.bullet_attention(
                    q, k, v, *dense, decode_share=0.5, group=G), "bullet"),
                ("flash + paged decode apart", lambda: (
                    FA.flash_attention(q, k, v, group=G),
                    PD.paged_decode_attention(*dec)), "kernel")):
            what = f"{name} {tag}, serving shape, share 0.5"
            out[f"{what}: device ms"] = device_ms(fn)
            out[f"{what}: profiled us"] = profiled_us(fn, key)
            out[f"{what}: host us"] = host_us(fn)
        for name, fn in (
                ("flash_attention", lambda: FA.flash_attention(q, k, v,
                                                               group=G)),
                ("paged_decode_attention",
                 lambda: PD.paged_decode_attention(*dec)),
                ("decode_attention", lambda: DA.decode_attention(*dense))):
            what = f"{name} {tag}, serving shape"
            out[f"{what}: device ms"] = device_ms(fn)
            out[f"{what}: host us"] = host_us(fn)
        for x in SHARES:
            out[f"bullet_attention_paged {tag}, serving shape, share {x}: "
                "device ms"] = device_ms(
                lambda: BA.bullet_attention_paged(
                    q, k, v, *dec, decode_share=x, group=G))
        if dt == torch.bfloat16 and hasattr(BA, "Schedule"):
            got = []
            for _ in range(RECORDED):
                *_, sched = BA.bullet_attention_paged(
                    q, k, v, *dec, decode_share=0.5, group=G, record=True)
                torch.cuda.synchronize()
                got.append(spans(sched))
            for key in got[0]:
                out[f"recorded launch {tag}, serving shape, share 0.5: "
                    f"{key} us"] = statistics.median(g[key] for g in got)
        qc = torch.randn(2 * h, 256, d, generator=gen, device="cuda").to(dt)
        kc = torch.randn(2 * kh, 256, d, generator=gen, device="cuda").to(dt)
        vc = torch.randn(2 * kh, 256, d, generator=gen, device="cuda").to(dt)
        qd = torch.randn(8, kh, G, d, generator=gen, device="cuda").to(dt)
        kd = torch.randn(8, 512, kh, d, generator=gen, device="cuda").to(dt)
        vd = torch.randn(8, 512, kh, d, generator=gen, device="cuda").to(dt)
        kvpos = torch.arange(512, dtype=torch.int32,
                             device="cuda")[None].expand(8, 512).contiguous()
        pos = torch.randint(64, 512, (8,), generator=gen, device="cuda",
                            dtype=torch.int32)
        out[f"colocated {tag}, apart: device ms"] = device_ms(lambda: (
            FA.flash_attention(qc, kc, vc, group=G),
            DA.decode_attention(qd, kd, vd, kvpos, pos)))
        for x in (0.0, 0.25, 0.5, 0.75, 1.0):
            out[f"colocated {tag}, share {x}: device ms"] = device_ms(
                lambda: BA.bullet_attention(
                    qc, kc, vc, qd, kd, vd, kvpos, pos, decode_share=x,
                    group=G))
    with open(path, "w") as f:
        json.dump(out, f)


def _prefixed(what: str, numbers: dict) -> dict:
    return {f"{what}: {k}": v for k, v in numbers.items()}


def windows(tree: str, path: str) -> None:
    """The decode path of ``tree``, driven, timed and profiled by this
    checkout's ``chip_smoke.py`` functions (the same code for both
    checkouts; run in a process of its own, ``tree``'s ``src`` first on
    the path), saved to ``path`` as JSON: Qwen3-1.7B bf16 served fused,
    serial and under the scheduler's defaults (tok/s), the fused serve's
    host time per fused cycle by part (``HostSplit``), the decode-heavy
    default-scheduler serve (tok/s, and its window of 30 serial decode
    cycles) and the window of 30 fused cycles; Mamba-2-2.7B's wall-clock
    warm-up windows (cycles 11-20, a prefill group in each, and 101-110,
    decode); RecurrentGemma-2B's decode of the padded 4-prompt batch
    (ms per step over 63 steps after the first, through ``GraphedDecode``
    where the checkout has it, else ``decode_step``) and its window of 10
    decode steps. Each window: wall ms, device busy ms and share, ms per
    cycle, tok/s."""
    import importlib.util
    import torch
    cs = smoke_module()
    use_tree(tree)
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    assert T.__file__.startswith(tree), T.__file__
    card = cs.phase_card()
    out = {}

    cfg = get_config("qwen3-1.7b")
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    prompts, outs, arrivals = cs.serve_workload(cfg)
    cs._serve(cfg, params, prompts[:2], [2, 2], [0.0, 0.0], fused=True)
    for name, kw in (("fused", dict(fused=True)),
                     ("serial", dict(fused=False)),
                     ("default scheduler", dict(fused=True,
                                                default_sched=True))):
        _, secs, _ = cs._serve(cfg, params, prompts, outs, arrivals, **kw)
        out[f"qwen3 serve {name}: tok/s"] = sum(outs) / secs
    split = cs.HostSplit()
    cs._serve(cfg, params, prompts, outs, arrivals, fused=True, audit=split)
    out.update(_prefixed("qwen3 serve fused cycles: ms",
                         split.report("fused")))
    out.update(_prefixed("qwen3 decode serve",
                         cs.decode_serve(cfg, params, card)))
    out.update(_prefixed("qwen3 30 fused cycles", cs.phase_profile(
        cfg, params, prompts, outs, arrivals, card)))
    del params
    torch.cuda.empty_cache()

    cfg = get_config("mamba2-2.7b")
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    wins = (cs.ProfileCycles(10, 10), cs.ProfileCycles(100, 10))
    cs._replay(cfg, params, torch.bfloat16, paged=None, max_prefill_batch=4,
               wall=True, n_requests=2,
               audit=lambda srv: [w(srv) for w in wins])
    for w in wins:
        what = f"mamba2 cycles {w.start + 1}-{w.start + w.n}"
        out.update(_prefixed(what, w.report(
            f"{what} ({w.prefills} with a prefill group)", card)))
    del params
    torch.cuda.empty_cache()

    cfg = get_config("recurrentgemma-2b")
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    b = len(cs.RG_PROMPTS)
    toks, lens = cs._prompt_batch(cfg, cs.RG_PROMPTS, seed=3)
    toks, lens = toks.cuda(), lens.cuda()
    cache = T.init_cache(cfg, b, max(cs.RG_PROMPTS) + cs.RG_DECODE,
                         torch.bfloat16, "cuda")
    logits, _ = T.prefill(params, toks, lens, cache, None, cfg)
    if importlib.util.find_spec("repro_torch.core.graphs") is not None:
        from repro_torch.core.graphs import GraphedDecode
        step = GraphedDecode(params, cache, cfg)
    else:
        def step(tok, pos):
            return T.decode_step(params, cache, tok, pos, cfg)[0]
    tok, pos = logits.argmax(-1).to(torch.int32), lens.clone()

    def run(n):
        nonlocal tok, pos
        t0 = time.perf_counter()
        for _ in range(n):
            lg = step(tok[:, None], pos)
            tok, pos = lg.argmax(-1).to(torch.int32), pos + 1
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    run(1)                                  # the first step (captures)
    n = cs.RG_DECODE - 1
    wall = run(n)
    out["recurrentgemma decode: ms per step"] = wall * 1e3 / n
    out["recurrentgemma decode: tok/s"] = b * n / wall
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall = run(10)
    what = "recurrentgemma 10 decode steps"
    out.update(_prefixed(what, cs._profile_report(
        prof, wall, what, card, cycles=10, tokens=b * 10)))
    with open(path, "w") as f:
        json.dump(out, f)


#: the fp32 train steps ``bwd`` times: chip_smoke.py's launcher arguments
#: of Qwen3-1.7B, Granite-3.0-2B and RecurrentGemma-2B (batch 8 x 128), and
#: the steps of a run (a step's time is the median after the first)
BWD_TRAIN = ("TRAIN_QWEN", "TRAIN_GRANITE", "TRAIN_RG")
BWD_TRAIN_STEPS = 3


def bwd(tree: str, path: str) -> None:
    """Kernel 1's fp32 backward through ``tree``'s wrappers at each
    ``chip_smoke.BWD_SHAPES`` shape (the rows' inputs), timed by this
    checkout's ``chip_smoke.Timer``: as the tree's train step runs it, from
    the log-sum-exp of its fp32 training forward where it has one (a tree
    whose fp32 forward keeps none, ``_forward_lse`` raising, computes it in
    its backward); that training forward and the serving forward; then the
    fp32 train steps of ``BWD_TRAIN`` through the tree's launcher (ms a
    step). Run in a process of its own, ``tree``'s ``src`` first on the
    path; saved to ``path`` as JSON."""
    import gc
    import statistics as st
    import torch
    cs = smoke_module()
    timer = cs.Timer()
    use_tree(tree)
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as launcher
    assert FA.__file__.startswith(tree), FA.__file__
    cs.phase_card()
    build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(26)
    for name, b, sq, sk, h, kh, d, causal, window in cs.BWD_SHAPES:
        q, k, v = cs.flash_inputs(gen, b, sq, torch.float32, h, kh, d, sk)
        do = torch.randn(q.shape, generator=gen, device="cuda")
        kw = dict(causal=causal, window=window, group=h // kh)
        try:
            o, lse = FA._forward_lse(q, k, v, **kw)
            out[f"{name} training forward: ms"] = timer(
                lambda: FA._forward_lse(q, k, v, **kw))
        except ValueError:
            o, lse = FA._forward(q, k, v, **kw), None
        out[f"{name} serving forward: ms"] = timer(
            lambda: FA._forward(q, k, v, **kw))
        out[f"{name}: ms"] = timer(lambda: FA.flash_attention_bwd(
            q, k, v, o, do, lse=lse, **kw))
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    for arch in BWD_TRAIN:
        argv = getattr(cs, arch) + ["--steps", str(BWD_TRAIN_STEPS)]
        run = launcher.run(launcher.parse_args(argv))
        out[f"train {argv[1]} fp32: ms a step"] = st.median(run.step_ms[1:])
        del run
        gc.collect()
        torch.cuda.empty_cache()
    with open(path, "w") as f:
        json.dump(out, f)


def rows(log: str) -> dict:
    """Kernel name -> ms from a --kernels-only log."""
    got = {}
    for ln in open(log):
        m = re.match(r"^([a-z0-9_]+): ([0-9.]+) ms \(plain", ln)
        m = m or re.match(r"^((?:ssd|rglru)_scan \w+) B=\d+ S=\d+[^:]*: "
                          r"([0-9.]+) ms", ln)
        if m:
            got[m.group(1)] = float(m.group(2))
    return got


def sass(tree: str) -> dict:
    """Kernel -> its SASS, from the library ``tree`` built; the hash nvcc
    gives each source's anonymous namespace, which names the checkout's
    path, is dropped, and runs of blanks are one (cuobjdump pads every
    line to the longest in the library, so a kernel added elsewhere would
    shift the columns of all the others)."""
    lib_dir = os.path.join(tree, "build", "repro_torch_kernels")
    lib = [f for f in os.listdir(lib_dir) if f.endswith(".so")]
    assert len(lib) == 1, lib
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", os.path.join(lib_dir, lib[0])],
                          capture_output=True, text=True, check=True).stdout
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", text)
    out, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            out[name].append(" ".join(ln.split()))
    return out


def print_sass_diff(other: str) -> None:
    """Which kernels' machine code differs between the library ``other``
    built and this checkout's."""
    a, b = sass(other), sass(ROOT)
    common = sorted(set(a) & set(b))
    differ = [k for k in common if a[k] != b[k]]
    print(f"SASS: {len(common)} kernels in both libraries, {len(differ)} "
          f"differ: {differ}; only in the other: {sorted(set(a) - set(b))}; "
          f"only in this: {sorted(set(b) - set(a))}")


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--dump":
        dump(os.path.abspath(sys.argv[2]), sys.argv[3])
        return 0
    if len(sys.argv) == 4 and sys.argv[1] == "--fused":
        fused(os.path.abspath(sys.argv[2]), sys.argv[3])
        return 0
    if len(sys.argv) == 4 and sys.argv[1] == "--window":
        windows(os.path.abspath(sys.argv[2]), sys.argv[3])
        return 0
    if len(sys.argv) == 4 and sys.argv[1] == "--bwd-turn":
        bwd(os.path.abspath(sys.argv[2]), sys.argv[3])
        return 0
    import torch
    other = os.path.abspath(sys.argv[1])
    os.makedirs(OUT, exist_ok=True)
    os.makedirs(DUMPS, exist_ok=True)
    turns = [("other", other), ("this", ROOT), ("this", ROOT),
             ("other", other)]
    if sys.argv[2:] in (["--windows"], ["--bwd"]):
        what = "windows" if sys.argv[2] == "--windows" else "bwd"
        got = []
        for i, (tag, tree) in enumerate(turns):
            path = os.path.join(DUMPS, f"{i}_{tag}_{what}.json")
            with open(os.path.join(OUT, f"{i}_{tag}_{what}.log"), "w") as f:
                rc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__),
                     "--window" if what == "windows" else "--bwd-turn",
                     tree, path], stdout=f, stderr=subprocess.STDOUT,
                    cwd=tree).returncode
            print(f"turn {i} ({tag}): {what} rc={rc}")
            if rc:
                return rc
            with open(path) as f:
                got.append(json.load(f))
        print(f"{what} (turns): " + " / ".join(
            f"{i} {t}" for i, (t, _) in enumerate(turns)))
        for key in got[1]:
            print(f"{key}: " + " / ".join(
                f"{g[key]:.4f}" if key in g else "-" for g in got))
        if what == "bwd":
            print_sass_diff(other)
        return 0
    logs, dumps, timings = [], [], []
    for i, (tag, tree) in enumerate(turns):
        log = os.path.join(OUT, f"{i}_{tag}.log")
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, "chip_smoke.py",
                                 "--kernels-only"], cwd=tree, stdout=f,
                                stderr=subprocess.STDOUT).returncode
        print(f"turn {i} ({tag}): chip_smoke.py --kernels-only rc={rc}")
        if rc:
            return rc
        path = os.path.join(DUMPS, f"{i}_{tag}.pt")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--dump",
                        tree, path], check=True)
        logs.append(rows(log))
        dumps.append(torch.load(path))
        path = os.path.join(DUMPS, f"{i}_{tag}_fused.json")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--fused", tree, path], check=True)
        with open(path) as f:
            timings.append(json.load(f))
    print("row (ms): " + " / ".join(f"{i} {t}" for i, (t, _) in
                                    enumerate(turns)))
    for name in logs[1]:
        print(f"{name}: " + " / ".join(
            f"{r[name]:.4f}" if name in r else "-" for r in logs))
    for key in timings[1]:
        print(f"{key}: " + " / ".join(
            f"{t[key]:.4f}" if key in t else "-" for t in timings))
    print_sass_diff(other)
    for key in dumps[0]:
        same = [all(torch.equal(a, b) for a, b in zip(dumps[i][key],
                                                      dumps[j][key]))
                for i, j in ((0, 1), (1, 2), (0, 3))]
        print(f"{key}: outputs bit-equal other/this {same[0]}, "
              f"this/this {same[1]}, other/other {same[2]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
