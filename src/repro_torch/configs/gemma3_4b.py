"""gemma3-4b [dense]: 34L d=2560 8H (GQA kv=4) ff=10240 V=262144.

5:1 local:global sliding-window pattern, 128k context.
[hf:google/gemma-3-1b-pt; unverified]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv=4,
    d_ff=10240,
    vocab=262144,
    head_dim=256,
    act="gelu_tanh",
    norm="rms",
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    window=1024,
    global_period=6,  # every 6th layer global -> 5:1 local:global
    max_seq=131072,
))
