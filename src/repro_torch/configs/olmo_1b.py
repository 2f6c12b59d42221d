"""olmo-1b [dense]: 16L d=2048 16H (kv=16) ff=8192 V=50304.

Non-parametric LayerNorm. [arXiv:2402.00838; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=8192,
    vocab=50304,
    act="silu",
    norm="nonparametric",
    rope_theta=10_000.0,
    attn_bias=False,
    tie_embeddings=True,
))
