"""Training launcher of the PyTorch port (the JAX package's
``launch/train.py``).

Two modes:
- host (default): really train, on one CUDA card unless ``--device cpu``
  is given: the reduced variant of the selected architecture unless
  ``--full`` is passed, params from the port's seeded init (``--seed``),
  fp32, per-block remat, the optimizer the config's size picks, the
  synthetic LM stream. It prints the JAX launcher's step lines; on the
  card also the median ms a step (the first, which builds the kernels,
  apart), tok/s and the peak of allocated device memory. Every config
  trains on the card and on the CPU (Mamba-2 and RecurrentGemma through
  the hand-written backwards of the SSD and RG-LRU scans).
- dryrun: trace ``train_4k`` of the selected architecture at full width
  on the meta device on the 16×16 production mesh (``launch/dryrun.py``,
  in-process, where the JAX launcher starts a subprocess); no device is
  touched.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 10
  PYTHONPATH=src python -m repro_torch.launch.train --mode dryrun
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import List, NamedTuple, Optional

import torch


class TrainRun(NamedTuple):
    state: object              # the final TrainState
    losses: List[float]        # every step's loss
    grad_norms: List[float]    # every step's gradient norm (before the clip)
    step_ms: List[float]       # every step's wall ms (synchronized)
    tok_s: float               # tokens a second over the steps after the first
    peak_bytes: Optional[int]  # peak allocated device memory (card only)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="use the full (not reduced) config")
    ap.add_argument("--mode", choices=("host", "dryrun"), default="host")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the params' init")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> TrainRun:
    """Train as ``--mode host`` does and return the run (``--mode
    dryrun`` is :func:`main`'s)."""
    if args.mode == "dryrun":
        raise ValueError("run() trains; --mode dryrun goes through main()")
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.training.checkpoint import save_checkpoint
    from repro_torch.training.trainer import make_train_step

    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    params = T.init_params(cfg, seed=args.seed, dtype=torch.float32,
                           device=device)
    print(f"training {cfg.name}: {T.param_count(params)/1e6:.1f}M params, "
          f"batch {args.batch} x seq {args.seq}, {args.steps} steps",
          flush=True)
    init_fn, step_fn = make_train_step(cfg, remat=True, lr=args.lr,
                                       warmup=min(20, args.steps // 4 + 1))
    state = init_fn(params)
    del params
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq_len=args.seq,
                                  batch_size=args.batch, n_symbols=256))
    losses, norms, step_ms = [], [], []
    t0 = time.time()
    for i, raw in zip(range(args.steps), data.batches()):
        ts = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
        if cfg.frontend_embed_len:
            fe_len = (cfg.encoder_seq_len if cfg.n_encoder_layers
                      else cfg.frontend_embed_len)
            batch["frontend"] = torch.zeros(
                (args.batch, fe_len, cfg.frontend_embed_dim),
                dtype=torch.float32, device=device)
        state, m = step_fn(state, batch)
        _sync(device)
        step_ms.append((time.perf_counter() - ts) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"gnorm {norms[-1]:.3f} "
                  f"({(i+1)*args.batch*args.seq/(time.time()-t0):,.0f} "
                  "tok/s)", flush=True)
    later = step_ms[1:] or step_ms
    tok_s = args.batch * args.seq * len(later) / (sum(later) / 1e3)
    peak = None
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        print(f"{statistics.median(later):.1f} ms a step (median of "
              f"{len(later)}; the first {step_ms[0]:.1f} ms), {tok_s:,.0f} "
              f"tok/s, peak allocated {peak / 2**30:.2f} GiB on "
              f"{torch.cuda.get_device_name(device)}", flush=True)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state.params, step=args.steps)
        print("saved", args.checkpoint)
    return TrainRun(state, losses, norms, step_ms, tok_s, peak)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.mode == "dryrun":
        from repro_torch.launch import dryrun
        dryrun.main(["--arch", args.arch, "--shape", "train_4k"])
        return
    run(args)


if __name__ == "__main__":
    main()
