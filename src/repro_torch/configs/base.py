"""Architecture config schema + registry + input shapes.

Each assigned architecture gets one file in this package defining an
``ArchConfig`` with the exact public-literature dimensions; ``reduced()``
yields the CPU-smoke-test version of the same family (same code path, tiny
dims).  The four input-shape regimes from the brief are defined here as
``SHAPES``; ``supported_shapes(cfg)`` encodes the skip rules documented in
DESIGN.md §Arch-applicability.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    act: str = "silu"
    norm: str = "rms"  # rms | layer | nonparametric
    rope_theta: float = 1e4
    attn_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = True
    # sliding-window pattern (Gemma3): every `global_period`-th layer is
    # global, the rest use `window`
    window: int = 0  # 0 = all layers full attention
    global_period: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0  # shared (always-on) experts
    d_expert: int = 0  # per-expert FFN width
    # SSM / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    d_inner: int = 0
    hybrid_period: int = 0  # Zamba: shared attention block every N layers
    # modality / topology
    frontend: str = ""  # "" | "patch" (VLM) | "frame" (audio)
    causal: bool = True
    has_decoder: bool = True  # encoder-only archs have no decode step
    max_seq: int = 131072

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=4 if self.hybrid_period else 2,
            d_model=64,
            n_heads=4,
            n_kv=2 if self.n_kv < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab=512,
            window=16 if self.window else 0,
            global_period=2 if self.global_period else 0,
            n_experts=8 if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared=1 if self.n_shared else 0,
            d_expert=32 if self.d_expert else 0,
            ssm_state=8 if self.ssm_state else 0,
            ssm_heads=4 if self.ssm_heads else 0,
            d_inner=128 if self.d_inner else 0,
            hybrid_period=2 if self.hybrid_period else 0,
            max_seq=256,
        )

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks)."""
        d, f, l = self.d_model, self.d_ff, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * self.hd * (self.n_heads + 2 * self.n_kv) + self.n_heads * self.hd * d
        if self.family == "ssm":  # rwkv6-style block
            blk = 2 * d * self.d_ff + d * self.d_ff + 5 * d * d  # ffn + mixing
        elif self.family == "hybrid":
            di = self.d_inner or 2 * d
            mamba = d * di * 2 + di * d + di * (2 * self.ssm_state)
            blk = mamba + 2 * d * f + d * f  # + shared attn amortized
        elif self.n_experts:
            expert = 3 * d * self.d_expert
            shared = 3 * d * self.d_expert * 4 if self.n_shared else 0
            blk = attn + self.n_experts * expert + shared + d * self.n_experts
        else:
            blk = attn + 3 * d * f
        return emb + l * blk

    def n_active_params(self) -> int:
        """Active (per-token) parameters — differs for MoE."""
        if not self.n_experts:
            return self.n_params()
        d, l = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * self.hd * (self.n_heads + 2 * self.n_kv) + self.n_heads * self.hd * d
        expert = 3 * d * self.d_expert
        active = attn + (self.top_k + 4 * self.n_shared) * expert + d * self.n_experts
        return emb + l * active


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs allowed to run long_500k (sub-quadratic / mostly-local attention);
# see DESIGN.md §Arch-applicability
_LONG_OK_FAMILIES = {"ssm", "hybrid"}


def supported_shapes(cfg: ArchConfig) -> list[str]:
    out = ["train_4k", "prefill_32k"]
    if cfg.has_decoder:
        out.append("decode_32k")
        if cfg.family in _LONG_OK_FAMILIES or (cfg.window and cfg.global_period):
            out.append("long_500k")
    return out


def skip_reason(cfg: ArchConfig, shape: str) -> str | None:
    if shape in supported_shapes(cfg):
        return None
    if not cfg.has_decoder:
        return "encoder-only: no autoregressive decode step"
    return (
        "pure full-attention arch: 500k-context KV cache exceeds HBM and the "
        "arch defines no sub-quadratic path (DESIGN.md §Arch-applicability)"
    )


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    return _REGISTRY[name]


def all_configs() -> dict[str, ArchConfig]:
    _ensure_loaded()
    return dict(_REGISTRY)


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    from . import (  # noqa: F401
        command_r_plus_104b,
        gemma3_4b,
        granite_3_8b,
        hubert_xlarge,
        internvl2_1b,
        olmo_1b,
        qwen2_moe_a2_7b,
        qwen3_moe_30b_a3b,
        rwkv6_3b,
        zamba2_2_7b,
    )
