"""qwen2-moe-a2.7b [moe]: 24L d=2048 16H (kv=16) d_expert=1408 V=151936.

MoE: 60 routed experts top-4 + 4-way shared expert (shared width 5632 =
4 x 1408). [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=5632,        # shared-expert width
    vocab=151936,
    act="silu",
    norm="rms",
    rope_theta=1_000_000.0,
    attn_bias=True,
    tie_embeddings=False,
    n_experts=60,
    top_k=4,
    n_shared=4,
    d_expert=1408,
))
