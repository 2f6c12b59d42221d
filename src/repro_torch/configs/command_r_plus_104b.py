"""command-r-plus-104b [dense]: 64L d=12288 96H (GQA kv=8) ff=33792 V=256000.

GQA, no-bias.  [hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv=8,
    d_ff=33792,
    vocab=256000,
    head_dim=128,
    act="silu",
    norm="layer",
    rope_theta=75_000_000.0,
    attn_bias=False,
    tie_embeddings=True,
))
