"""internvl2-1b [vlm]: 24L d=896 14H (GQA kv=2) ff=4864 V=151655.

InternViT frontend (STUB: precomputed patch embeddings) + InternLM2/Qwen2
0.5B language backbone. [arXiv:2404.16821; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv=2,
    d_ff=4864,
    vocab=151655,
    act="silu",
    norm="rms",
    rope_theta=1_000_000.0,
    attn_bias=True,
    tie_embeddings=True,
    frontend="patch",
))
