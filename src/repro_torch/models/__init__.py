"""Model zoo: the dense transformer family (decoder, encoder, VLM backbone)
on PyTorch, with FlashAttention (K6) on the card, the MoE family with
SharesSkew expert dispatch on the same attention, and RWKV-6 with its wkv
recurrence (K7) on the card; the Mamba2 hybrid is not ported yet
(ROADMAP)."""
from .convert import params_from_jax
from .zoo import ModelApi, build_model, make_batch

__all__ = ["ModelApi", "build_model", "make_batch", "params_from_jax"]
