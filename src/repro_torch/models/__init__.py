"""Model zoo: the dense transformer family (decoder, encoder, VLM backbone)
on PyTorch, with FlashAttention (K6) on the card, the MoE family with
SharesSkew expert dispatch on the same attention, RWKV-6 with its wkv
recurrence (K7) on the card, and the Zamba2 hybrid (Mamba2 blocks in SSD's
chunked form and a shared attention block on K6)."""
from .convert import params_from_jax
from .zoo import ModelApi, build_model, make_batch

__all__ = ["ModelApi", "build_model", "make_batch", "params_from_jax"]
