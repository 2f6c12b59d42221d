"""granite-3-8b [dense]: 40L d=4096 32H (GQA kv=8) ff=12800 V=49155.

[hf:ibm-granite/granite-3.0-2b-base; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=12800,
    vocab=49155,
    act="silu",
    norm="rms",
    rope_theta=10_000_000.0,
    tie_embeddings=True,
))
