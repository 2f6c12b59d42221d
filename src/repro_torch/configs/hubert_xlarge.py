"""hubert-xlarge [audio]: 48L d=1280 16H (kv=16) ff=5120 V=504.

Encoder-only (same arch as wav2vec2); conv frame frontend is a STUB —
input_specs() provides precomputed frame embeddings.
[arXiv:2106.07447; unverified]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv=16,
    d_ff=5120,
    vocab=504,
    act="gelu",
    norm="layer",
    attn_bias=True,
    tie_embeddings=False,
    frontend="frame",
    causal=False,
    has_decoder=False,
))
