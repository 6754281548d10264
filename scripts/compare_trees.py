"""Compare two checkouts of the port on one CUDA card, in turns.

    python3 scripts/compare_trees.py OTHER_CHECKOUT

Runs, in the order other, this, this, other: ``chip_smoke.py
--kernels-only`` of each checkout (each builds its own kernels under its
own ``build/``), then a dump of the SSD scan's outputs on seeded inputs at
Mamba-2-2.7B's shapes (fp32 and bf16; B in {1, 4}, S in {1000, 200})
through that checkout's wrapper. Prints every kernel row's time per turn;
for each SSD case whether y and the final state are bit-equal between the
checkouts and between the two turns of each; and which kernels' machine
code (``cuobjdump -sass`` of the two built libraries) differs. Logs go to
``chiprun_out/compare/``, the dumps to ``build/compare/``.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out", "compare")
DUMPS = os.path.join(ROOT, "build", "compare")
CASES = ((1, 1000), (4, 1000), (4, 200), (1, 200))


def dump(tree: str, path: str) -> None:
    """Seeded SSD scan outputs of ``tree``'s wrapper, saved to ``path``
    (run in a process of its own, with ``tree/src`` first on the path)."""
    import torch
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as SK
    assert SK.__file__.startswith(tree), SK.__file__
    out = {}
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
            out[f"{str(dtype)[6:]} B={b} S={s}"] = (y.cpu(), st.cpu())
    torch.save(out, path)


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
    path, is dropped."""
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
            out[name].append(ln)
    return out


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--dump":
        dump(os.path.abspath(sys.argv[2]), sys.argv[3])
        return 0
    import torch
    other = os.path.abspath(sys.argv[1])
    os.makedirs(OUT, exist_ok=True)
    os.makedirs(DUMPS, exist_ok=True)
    turns = [("other", other), ("this", ROOT), ("this", ROOT),
             ("other", other)]
    logs, dumps = [], []
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
    print("row (ms): " + " / ".join(f"{i} {t}" for i, (t, _) in
                                    enumerate(turns)))
    for name in logs[1]:
        print(f"{name}: " + " / ".join(
            f"{r[name]:.4f}" if name in r else "-" for r in logs))
    a, b = sass(other), sass(ROOT)
    common = sorted(set(a) & set(b))
    differ = [k for k in common if a[k] != b[k]]
    print(f"SASS: {len(common)} kernels in both libraries, {len(differ)} "
          f"differ: {differ}; only in the other: {sorted(set(a) - set(b))}; "
          f"only in this: {sorted(set(b) - set(a))}")
    for key in dumps[0]:
        same = [all(torch.equal(a, b) for a, b in zip(dumps[i][key],
                                                      dumps[j][key]))
                for i, j in ((0, 1), (1, 2), (0, 3))]
        print(f"ssd_scan {key}: y and state bit-equal other/this {same[0]}, "
              f"this/this {same[1]}, other/other {same[2]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
