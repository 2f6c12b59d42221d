"""zamba2-2.7b [hybrid]: 54L d=2560 Mamba2 backbone + shared attention
blocks (32H kv=32) every 6 layers, ff=10240, V=32000, ssm_state=64.

[arXiv:2411.15242; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    act="gelu",
    norm="rms",
    tie_embeddings=True,
    ssm_state=64,
    ssm_heads=80,     # d_inner 5120, head dim 64
    d_inner=5120,
    hybrid_period=6,
))
