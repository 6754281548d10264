"""Model / run configuration system.

Every assigned architecture is expressed as a ``ModelConfig`` — a frozen
dataclass wide enough to cover dense GQA, MoE, SSM (Mamba-2 SSD), hybrid
(RG-LRU + local attention), encoder-decoder, and VLM/audio backbones.

Block-pattern model: a model is a repeated sequence of ``BlockSpec`` entries
(``pattern``); ``n_layers`` must be a multiple of ``len(pattern)``. This is
what lets recurrentgemma express its 1:2 (local-attn : RG-LRU) layout and
llama4 its interleaved MoE while everything lowers through one scan.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

# ---------------------------------------------------------------------------
# Block kinds
# ---------------------------------------------------------------------------

ATTN = "attn"                # full (causal) self attention
SWA = "swa"                  # sliding-window self attention
RGLRU = "rglru"              # RG-LRU recurrent block (griffin/recurrentgemma)
SSD = "ssd"                  # Mamba-2 state-space duality block
BLOCK_KINDS = (ATTN, SWA, RGLRU, SSD)

MLP = "mlp"                  # dense gated MLP
MOE = "moe"                  # routed mixture-of-experts
FF_KINDS = (MLP, MOE, "none")


@dataclass(frozen=True)
class BlockSpec:
    """One transformer block = mixer (attention/recurrence) + feed-forward."""

    mixer: str = ATTN        # one of BLOCK_KINDS
    ff: str = MLP            # one of FF_KINDS

    def __post_init__(self):
        if self.mixer not in BLOCK_KINDS:
            raise ValueError(f"unknown mixer {self.mixer!r}")
        if self.ff not in FF_KINDS:
            raise ValueError(f"unknown ff {self.ff!r}")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attention-free)
    n_kv_heads: int                  # kv heads (GQA); 0 for attention-free
    d_ff: int                        # MLP hidden (per expert for MoE)
    vocab_size: int
    head_dim: int = 128
    pattern: Sequence[BlockSpec] = (BlockSpec(),)
    #: trailing blocks outside the repeated pattern (e.g. recurrentgemma's
    #: 26 = (R,R,L)x8 + (R,R)); applied after the scanned stack.
    pattern_tail: Sequence[BlockSpec] = ()

    # attention options
    qkv_bias: bool = False           # qwen1.5-style QKV bias
    qk_norm: bool = False            # qwen3-style per-head RMSNorm on q,k
    rope_theta: float = 10000.0
    sliding_window: int = 4096       # window for SWA blocks
    long_context_window: int = 8192  # window used for the long_500k variant
    attention_logit_softcap: float = 0.0

    # MoE options
    n_experts: int = 0
    n_experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (mamba2 / SSD) options
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # RG-LRU options
    rglru_lru_width: int = 0         # 0 -> d_model
    rglru_conv_width: int = 4

    # encoder-decoder options
    n_encoder_layers: int = 0
    encoder_seq_len: int = 0         # stub-frontend output length (frames/patches)
    cross_attention: bool = False

    # multimodal stub frontend (audio frames / vision patches)
    frontend_embed_len: int = 0      # prepended embedding tokens for vlm/audio
    frontend_embed_dim: int = 0      # raw embedding dim (projector maps to d_model)

    # norm / misc
    rmsnorm_eps: float = 1e-6
    tie_embeddings: bool = False
    citation: str = ""

    # ---------------------------------------------------------------
    def __post_init__(self):
        if (self.n_layers - len(self.pattern_tail)) % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} minus tail "
                f"{len(self.pattern_tail)} not a multiple of pattern length "
                f"{len(self.pattern)}")
        if self.family == "encdec" and self.n_encoder_layers <= 0:
            raise ValueError(f"{self.name}: encdec needs n_encoder_layers")

    # -- derived -----------------------------------------------------
    @property
    def n_pattern_repeats(self) -> int:
        return (self.n_layers - len(self.pattern_tail)) // len(self.pattern)

    @property
    def all_blocks(self) -> Sequence[BlockSpec]:
        return tuple(self.pattern) * self.n_pattern_repeats + \
            tuple(self.pattern_tail)

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 so the logits/vocab dim shards
        over any reasonable model axis (padding masked to -inf in
        lm_logits)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_head_total(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.d_model * self.ssm_expand

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def lru_width(self) -> int:
        return self.rglru_lru_width or self.d_model

    def has_mixer(self, kind: str) -> bool:
        return any(b.mixer == kind
                   for b in tuple(self.pattern) + tuple(self.pattern_tail))

    def has_ff(self, kind: str) -> bool:
        return any(b.ff == kind
                   for b in tuple(self.pattern) + tuple(self.pattern_tail))

    @property
    def is_attention_free(self) -> bool:
        return not (self.has_mixer(ATTN) or self.has_mixer(SWA))

    @property
    def supports_long_context(self) -> bool:
        """True if decode memory is sub-linear in context (state/window)."""
        return True   # all configs run long_500k via state/window carve-out

    @property
    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d = self.d_model
        total = self.vocab_size * d            # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d       # lm head
        per_pattern = 0
        for b in self.all_blocks:
            if b.mixer in (ATTN, SWA):
                per_pattern += d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                per_pattern += self.n_heads * self.head_dim * d
            elif b.mixer == SSD:
                di, ns = self.ssm_d_inner, self.ssm_state
                per_pattern += d * (2 * di + 2 * ns * 1 + self.ssm_n_heads)  # in_proj approx
                per_pattern += di * d
            elif b.mixer == RGLRU:
                w = self.lru_width
                per_pattern += d * w * 2 + w * d + 3 * w  # in/out proj + gates
            if b.ff == MLP:
                per_pattern += 3 * d * self.d_ff
            elif b.ff == MOE:
                per_pattern += d * self.n_experts            # router
                per_pattern += self.n_experts * 3 * d * self.d_ff
                per_pattern += self.n_shared_experts * 3 * d * self.d_ff
        total += per_pattern
        if self.n_encoder_layers:
            enc = self.n_encoder_layers * (
                self.d_model * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                + self.n_heads * self.head_dim * d + 3 * d * self.d_ff)
            total += enc
            if self.cross_attention:   # decoder cross-attn already in pattern? add here
                total += self.n_layers * (
                    d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                    + self.n_heads * self.head_dim * d)
        return total

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE top-k only)."""
        if not self.has_ff(MOE):
            return self.n_params
        d = self.d_model
        total = self.n_params
        # subtract inactive experts
        n_moe_layers = sum(1 for b in self.all_blocks if b.ff == MOE)
        inactive = (self.n_experts - self.n_experts_per_token)
        total -= n_moe_layers * inactive * 3 * d * self.d_ff
        return total

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: tiny dims, same family/pattern structure."""
        small = dict(
            n_layers=len(self.pattern) + len(self.pattern_tail),
            d_model=128,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            sliding_window=64,
            long_context_window=64,
            encoder_seq_len=16 if self.n_encoder_layers else 0,
            n_encoder_layers=1 if self.n_encoder_layers else 0,
            frontend_embed_len=8 if self.frontend_embed_len else 0,
            frontend_embed_dim=64 if self.frontend_embed_dim else 0,
            n_experts=min(self.n_experts, 4),
            n_experts_per_token=min(self.n_experts_per_token, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=16,
            rglru_lru_width=64 if self.has_mixer(RGLRU) else 0,
            name=self.name + "-reduced",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate config {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False

def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # import all config modules for registration side effects; the port
    # registers only the dense pure-attention models its paged path serves
    from repro_torch.configs import qwen3_1p7b, llama31_8b  # noqa: F401
