"""qwen3-moe-30b-a3b [moe]: 48L d=2048 32H (GQA kv=4) d_expert=768 V=151936.

MoE: 128 routed experts, top-8, no shared expert; qk-norm.
[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv=4,
    head_dim=128,
    d_ff=768,
    vocab=151936,
    act="silu",
    norm="rms",
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=False,
    n_experts=128,
    top_k=8,
    n_shared=0,
    d_expert=768,
))
