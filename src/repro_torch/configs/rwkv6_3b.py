"""rwkv6-3b [ssm]: 32L d=2560 (attention-free) ff=8960 V=65536.

RWKV-6 "Finch" — data-dependent decay. [arXiv:2404.05892; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,       # wkv head size 64
    n_kv=40,
    head_dim=64,
    d_ff=8960,
    vocab=65536,
    act="relu",       # rwkv channel-mix uses relu^2
    norm="layer",
    tie_embeddings=False,
))
