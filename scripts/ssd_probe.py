"""Probe kernel 6 (the Mamba-2 SSD chunk scan) on one CUDA card.

    python3 scripts/ssd_probe.py

Builds the kernels, prints ptxas's registers and spills of the SSD
kernels, then at Mamba-2-2.7B's shapes (H=80, P=64, N=128, chunk 256) and
B in {1, 4}, S in {1000, 200}: the bf16 kernel's time at each P slice of
its output kernel (median of 15 CUDA-event timings, L2 flushed, as
``chip_smoke.py`` times), its error against the plain version and against
its plain mirror ``ref.ssd_scan_tc_ref``; then a torch.profiler window of
20 calls at B=1, S=1000 with the device time of each of the bf16 body's
launches, and the card's name and power limit. Exits non-zero without a
card.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from repro_torch.kernels import build, geometry
    from repro_torch.kernels import ref as KR
    from repro_torch.kernels import ssd_scan as SK

    b = build.build()
    rep = CS.ptxas_report(b.log)
    for r, name in zip(rep, CS.demangled([r["kernel"] for r in rep])):
        if any(k in name for k in CS.SSD_KERNELS):
            print(f"ptxas {name}: {r.get('regs')} registers, spills "
                  f"{r['spill_st']}/{r['spill_ld']} B")
    timer = CS.Timer()
    gen = torch.Generator(device="cuda").manual_seed(6)
    for bb, ss in ((1, 1000), (4, 1000), (4, 200), (1, 200)):
        xw, cum, bm, cm = CS.ssd_inputs(gen, bb, ss, torch.bfloat16)
        ry, rst = SK.ssd_scan_plain(xw, cum, bm, cm)
        my, mst = KR.ssd_scan_tc_ref(xw, cum, bm, cm)
        for ps in geometry.SSD_P_SLICES:
            y, st = SK.ssd_scan(xw, cum, bm, cm, p_slice=ps)
            torch.cuda.synchronize()
            ms = timer(lambda: SK.ssd_scan(xw, cum, bm, cm, p_slice=ps))
            print(f"B={bb} S={ss} P slice {ps}: {ms:.4f} ms; against the "
                  f"plain version y {CS.rel_err(y, ry):.3e} state "
                  f"{CS.rel_err(st, rst):.3e}, against the mirror y "
                  f"{CS.rel_err(y, my):.3e} state {CS.rel_err(st, mst):.3e}")
    xw, cum, bm, cm = CS.ssd_inputs(gen, 1, 1000, torch.bfloat16)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            timer.flush.zero_()
            SK.ssd_scan(xw, cum, bm, cm)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and any(k in e.key for k in CS.SSD_KERNELS)):
            print(f"profile B=1 S=1000 bf16 {e.key[:60]}: "
                  f"{e.device_time_total / e.count:.2f} us a call")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
