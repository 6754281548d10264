"""Workload generation: Poisson arrivals over dataset-shaped length
distributions (paper §4.1, Fig. 10).

The three datasets are modeled as truncated lognormals fitted to the CDFs in
the paper's Fig. 10 / the public datasets:

- ShareGPT: conversational — short prompts, medium outputs.
- Azure-Code: production code completion — long prompts, short outputs.
- arXiv-Summary: long-document summarization — very long prompts, medium
  outputs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.serving.request import Request


@dataclass(frozen=True)
class LengthDist:
    log_mean: float
    log_std: float
    lo: int
    hi: int

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        x = rng.lognormal(self.log_mean, self.log_std, size=n)
        return np.clip(x.astype(np.int64), self.lo, self.hi)


@dataclass(frozen=True)
class Dataset:
    name: str
    prompt: LengthDist
    output: LengthDist


DATASETS = {
    # mean ~220 in / ~230 out, heavy tail to 2k
    "sharegpt": Dataset("sharegpt",
                        LengthDist(5.0, 1.0, 16, 4096),
                        LengthDist(5.0, 0.9, 8, 1024)),
    # mean ~2k in / ~40 out (code completion)
    "azure-code": Dataset("azure-code",
                          LengthDist(7.3, 0.8, 128, 8192),
                          LengthDist(3.3, 0.8, 4, 256)),
    # mean ~6k in / ~180 out (summarization)
    "arxiv-summary": Dataset("arxiv-summary",
                             LengthDist(8.4, 0.5, 1024, 16384),
                             LengthDist(5.0, 0.4, 32, 512)),
}


def fit_trace_to_context(trace: List[Request], max_len: int) -> List[Request]:
    """Clamp a trace's dataset-shaped lengths onto a reduced context window
    (real-engine replay of full-scale workloads). Mutates and returns it."""
    for r in trace:
        r.prompt_len = max(4, min(r.prompt_len, max_len // 2))
        r.output_len = max(2, min(r.output_len, max_len - r.prompt_len - 1))
    return trace


def generate_trace(dataset: str, rate_req_s: float, duration_s: float,
                   seed: int = 0, max_requests: int = 0) -> List[Request]:
    """Poisson arrival process at ``rate_req_s`` for ``duration_s``."""
    ds = DATASETS[dataset]
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs: List[Request] = []
    rid = 0
    while t < duration_s:
        t += rng.exponential(1.0 / rate_req_s)
        if t >= duration_s:
            break
        p = int(ds.prompt.sample(rng, 1)[0])
        o = int(ds.output.sample(rng, 1)[0])
        reqs.append(Request(rid=rid, arrival=t, prompt_len=p, output_len=o))
        rid += 1
        if max_requests and rid >= max_requests:
            break
    return reqs


# ---------------------------------------------------------------------------
# Multi-turn interactions (the shared-prefix reuse workload)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Turn:
    """One turn of a chat session: ``new_tokens`` of fresh user prompt
    appended to the full accumulated history, then ``output_tokens`` of
    generation. The turn's effective prompt is history + new tokens, so
    everything before the fresh suffix is a reuse candidate
    (docs/KV_SHARING.md)."""
    new_tokens: int
    output_tokens: int
    #: user think time between the previous turn finishing and this one
    #: arriving (seconds)
    think_time_s: float = 0.0


@dataclass(frozen=True)
class Interaction:
    """A closed-loop multi-turn session. Turn ``k+1`` cannot be issued
    until turn ``k``'s output exists (its tokens are part of the next
    prompt), so interactions replay through the frontend's
    ``submit_interactions`` rather than as a flat open-loop trace."""
    session_id: int
    arrival: float          # arrival of the first turn
    turns: tuple            # Tuple[Turn, ...]
    #: tenant identity (docs/MULTITENANCY.md): None on single-tenant
    #: workloads; ``tenancy.generate_tenant_interactions`` fills both
    user_id: Optional[int] = None
    app_id: Optional[int] = None


def generate_interactions(n_sessions: int, rate_s: float, *,
                          turns: int = 3, new_tokens: int = 12,
                          output_tokens: int = 6,
                          think_time_s: float = 0.0,
                          seed: int = 0) -> List[Interaction]:
    """Poisson session arrivals; per-session turn shapes jittered around
    the given means (±50%) so sessions diverge while still sharing their
    own history. Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    out: List[Interaction] = []
    t = 0.0
    for sid in range(n_sessions):
        t += rng.exponential(1.0 / rate_s)
        n_turns = max(1, int(rng.integers(max(1, turns // 2), turns + 1)))
        ts = []
        for _ in range(n_turns):
            nt = max(2, int(rng.integers(max(2, new_tokens // 2),
                                         new_tokens + new_tokens // 2 + 1)))
            ot = max(2, int(rng.integers(max(2, output_tokens // 2),
                                         output_tokens + output_tokens // 2
                                         + 1)))
            ts.append(Turn(nt, ot, think_time_s))
        out.append(Interaction(session_id=sid, arrival=t, turns=tuple(ts)))
    return out
