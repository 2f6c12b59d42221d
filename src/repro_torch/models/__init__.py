"""Model zoo: the dense transformer family (decoder, encoder, VLM backbone)
on PyTorch, with FlashAttention (K6) on the card, and RWKV-6 with its wkv
recurrence (K7) on the card; MoE and the Mamba2 hybrid are not ported yet
(ROADMAP)."""
from .convert import params_from_jax
from .zoo import ModelApi, build_model, make_batch

__all__ = ["ModelApi", "build_model", "make_batch", "params_from_jax"]
