"""Uniform model API over the architecture families: the counterpart of
``repro.models.zoo``.

``build_model(cfg)`` dispatches on ``cfg.family`` and returns a ``ModelApi``
whose members share one signature per role, so the serving loop treats
every architecture alike.  The model lives on one device, chosen here:
``device="cuda"`` unless the caller asks for the CPU, and a CUDA device
without a card raises.  ``dense``, ``vlm`` and ``audio`` run on
``transformer``, ``moe`` on ``moe`` (SharesSkew expert dispatch), ``ssm``
(RWKV-6) on ``rwkv6`` and ``hybrid`` (Zamba2: Mamba2 blocks and a shared
attention block) on ``mamba2``.

``build_model(cfg, device, tp=mesh)`` splits any model over the mesh's
"model" axis (``tensor_parallel``: heads and MLP columns, the vocab, for
``moe`` expert parallelism with SharesSkew's replica slots spread over the
ranks, for ``ssm`` RWKV-6's heads and channel-mix columns, for ``hybrid``
the Mamba2 heads and the shared block's heads): the rules' specs
(``launch.sharding.param_specs`` at that axis's size, no FSDP, as the JAX
launcher) are reckoned from the whole model's shapes under
``FakeTensorMode``, and every member of the ``ModelApi`` works on this
rank's blocks.  Where a stream's length divides the axis, its sequence
is split over it between blocks (sequence parallelism, ``tensor_parallel``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.sharding import param_specs
from repro_torch.mapreduce.executor import _device

from . import mamba2, moe, rwkv6, transformer
from .tensor_parallel import TensorParallel, leaf_split

@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    device: torch.device
    init_params: Callable[..., dict]  # (seed, dtype=float32) -> params
    # (params, batch, dtype=, remat=, loss_chunk=) -> scalar; differentiable
    # for every family (moe also takes capacity_factor=, extra_slots=
    # (SharesSkew replica slots) and aux_coef=; ssm differentiates its
    # recurrence through K7 and its backward kernel K7b on the card)
    loss_fn: Callable[..., torch.Tensor]
    init_cache: Callable[..., dict] | None  # (batch, max_seq, dtype) -> cache
    decode_step: Callable[..., tuple] | None  # (params, cache, tokens, pos, **kw)
    forward_hidden: Callable[..., Any]  # (params, batch, **kw) -> hidden (moe: (hidden, aux))
    tp: TensorParallel | None = None  # this rank's part of a model split over "model"


def tensor_parallel(cfg: ArchConfig, mesh) -> TensorParallel:
    """The split of ``cfg``'s model over ``mesh``'s "model" axis, its specs
    from the whole tree of the family's own ``init_params``."""
    family = {"moe": moe, "ssm": rwkv6, "hybrid": mamba2}.get(cfg.family, transformer)
    with FakeTensorMode():
        whole = family.init_params(cfg, 0, "cpu")
    specs = param_specs(whole, mesh.size("model"))
    return TensorParallel(mesh, specs, leaf_split(specs, whole))


def build_model(cfg: ArchConfig, device: torch.device | str = "cuda", tp=None) -> ModelApi:
    """The ``ModelApi`` of ``cfg`` on ``device``; ``tp``: a
    ``launch.mesh.Mesh`` whose "model" axis splits the model (None, or an
    axis of one rank: the whole model here)."""
    dev = _device(device)
    fam = cfg.family
    split = tp is not None and "model" in tp.mesh_dim_names and tp.size("model") > 1
    tp = tensor_parallel(cfg, tp) if split else None
    if fam == "hybrid":
        return ModelApi(
            cfg=cfg,
            device=dev,
            init_params=lambda seed, dtype=torch.float32: mamba2.init_params(
                cfg, seed, dev, dtype, tp),
            loss_fn=lambda params, batch, **kw: mamba2.loss_fn(cfg, params, batch, tp=tp, **kw),
            init_cache=lambda batch, max_seq, dtype=torch.bfloat16: mamba2.init_state(
                cfg, batch, max_seq, dtype, dev, tp),
            decode_step=lambda params, cache, tokens, pos, **kw: mamba2.decode_step(
                cfg, params, cache, tokens, pos, tp=tp, **kw),
            forward_hidden=lambda params, batch, **kw: mamba2.forward_hidden(
                cfg, params, batch["tokens"], batch.get("prefix_embeds"), tp=tp, **kw),
            tp=tp,
        )
    if fam == "ssm":
        return ModelApi(
            cfg=cfg,
            device=dev,
            init_params=lambda seed, dtype=torch.float32: rwkv6.init_params(
                cfg, seed, dev, dtype, tp),
            loss_fn=lambda params, batch, **kw: rwkv6.loss_fn(cfg, params, batch, tp=tp, **kw),
            init_cache=lambda batch, max_seq=0, dtype=torch.bfloat16: rwkv6.init_state(
                cfg, batch, dtype, dev, tp),
            decode_step=lambda params, cache, tokens, pos=None, **kw: rwkv6.decode_step(
                cfg, params, cache, tokens, pos, tp=tp, **kw),
            forward_hidden=lambda params, batch, **kw: rwkv6.forward_hidden(
                cfg, params, batch["tokens"], tp=tp, **kw),
            tp=tp,
        )
    if fam == "moe":
        return ModelApi(
            cfg=cfg,
            device=dev,
            init_params=lambda seed, dtype=torch.float32: moe.init_params(
                cfg, seed, dev, dtype, tp),
            loss_fn=lambda params, batch, **kw: moe.loss_fn(cfg, params, batch, tp=tp, **kw),
            init_cache=lambda batch, max_seq, dtype=torch.bfloat16: moe.init_kv_cache(
                cfg, batch, max_seq, dtype, dev, tp),
            decode_step=lambda params, cache, tokens, pos, **kw: moe.decode_step(
                cfg, params, cache, tokens, pos, tp=tp, **kw),
            forward_hidden=lambda params, batch, **kw: moe.forward_hidden(
                cfg, params, batch["tokens"], batch.get("prefix_embeds"), tp=tp, **kw),
            tp=tp,
        )
    if fam not in ("dense", "vlm", "audio"):
        raise ValueError(f"unknown family {fam}")
    decoder = fam != "audio"  # hubert is encoder-only
    return ModelApi(
        cfg=cfg,
        device=dev,
        init_params=lambda seed, dtype=torch.float32: transformer.init_params(
            cfg, seed, dev, dtype, tp),
        loss_fn=lambda params, batch, **kw: transformer.loss_fn(cfg, params, batch, tp=tp, **kw),
        init_cache=(lambda batch, max_seq, dtype=torch.bfloat16: transformer.init_kv_cache(
            cfg, batch, max_seq, dtype, dev, tp)) if decoder else None,
        decode_step=(lambda params, cache, tokens, pos, **kw: transformer.decode_step(
            cfg, params, cache, tokens, pos, tp=tp, **kw)) if decoder else None,
        forward_hidden=lambda params, batch, **kw: transformer.forward_hidden(
            cfg, params, batch.get("tokens"), batch.get("prefix_embeds"), tp=tp, **kw),
        tp=tp,
    )


def make_batch(
    cfg: ArchConfig, rng: np.random.Generator, batch: int, seq: int,
    device: torch.device | str = "cuda",
) -> dict:
    """Synthetic batch with the right modality for the arch (stub frontends
    provide precomputed frame/patch embeddings), drawn from ``rng`` in the
    order the JAX package draws it, so one seed gives both packages the
    same batch."""
    dev = _device(device)

    def put(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(device=dev, dtype=dtype)

    out: dict = {}
    if cfg.family == "audio":
        out["prefix_embeds"] = put(rng.normal(size=(batch, seq, cfg.d_model)), torch.bfloat16)
        out["labels"] = put(rng.integers(0, cfg.vocab, size=(batch, seq)), torch.int32)
        return out
    out["tokens"] = put(rng.integers(0, cfg.vocab, size=(batch, seq)), torch.int32)
    if cfg.family == "vlm":
        n_patch = min(64, max(8, seq // 4))
        out["prefix_embeds"] = put(rng.normal(size=(batch, n_patch, cfg.d_model)),
                                   torch.bfloat16)
    return out
