"""Serving launcher of the PyTorch port.

Mode ``host`` (the only one ported so far): run the Bullet runtime
(paged KV pool, fused prefill+decode cycles, SLO scheduler) over a
reduced model variant with seeded random weights, on one CUDA card by
default or on the CPU with ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode host
  PYTHONPATH=src python -m repro_torch.launch.serve --mode host \
      --device cpu --requests 4
"""

from __future__ import annotations

import argparse
import sys


def _host(args) -> str:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.config import build_server_config
    from repro_torch.core.engine import BulletServer
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.request import SLO, Request

    cfg = get_config(args.arch).reduced()
    params = init_params(cfg, seed=0, dtype=torch.float32,
                         device=args.device)
    server = BulletServer(cfg, params, config=build_server_config(
        args, slo=SLO(args.slo_ttft, args.slo_tpot)), device=args.device)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.integers(4, args.max_len // 3))
        out = int(rng.integers(2, args.max_len // 4))
        r = Request(rid=rid, arrival=0.0, prompt_len=plen, output_len=out)
        server.submit(r, rng.integers(0, cfg.vocab_size, plen))
    outputs = server.run()
    done = sum(len(v) for v in outputs.values())
    stats = " ".join(f"{k}={v}" for k, v in vars(server.stats).items())
    clean = server.pool.available_blocks == server.pool.n_blocks
    return "\n".join([
        f"served {len(outputs)} requests, {done} tokens total",
        f"stats: {stats}",
        f"KV pool clean: {clean}"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("host",), default="host")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--slo-ttft", type=float, default=3.0)
    ap.add_argument("--slo-tpot", type=float, default=150.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(_host(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
