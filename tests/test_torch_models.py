"""The port's dense transformer against the JAX package's, on the CPU in
fp32: the same weights (carried by ``params_from_jax``) and the same seeded
inputs through ``forward_hidden``, ``loss_fn``, ``prefill`` and
``decode_step`` of both.  Reduced configs: olmo-1b (non-parametric LN),
granite-3-8b (GQA), gemma3-4b (sliding window, qk-norm, global period),
hubert-xlarge (bidirectional encoder, gelu, biases) and internvl2-1b (a
VLM: patch embeddings ahead of the tokens in the forward and the loss;
prefill and decode take the tokens alone, as the JAX package's do)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build
from repro.models import layers as jlayers
from repro.models import make_batch as jax_make_batch
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.models import build_model, make_batch, params_from_jax
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as tt

_NAMES = ["olmo-1b", "granite-3-8b", "gemma3-4b", "hubert-xlarge", "internvl2-1b"]
_TOL = dict(rtol=2e-4, atol=2e-4)
_B, _L = 2, 12


class _Pair:
    """One reduced config in both packages, on the same weights."""

    def __init__(self, name: str):
        self.cfg = jconfigs.get_config(name).reduced()
        self.tcfg = tconfigs.get_config(name).reduced()
        self.jm = jax_build(self.cfg)
        self.jp = self.jm.init_params(jax.random.PRNGKey(3))
        self.tm = build_model(self.tcfg, device="cpu")
        self.tp = params_from_jax(self.tcfg, jax.tree.map(np.asarray, self.jp), device="cpu")

    def batch(self, seed: int, b: int = _B, l: int = _L, prefix: bool = True):
        """(the JAX batch, the port's): frames and labels for the encoder;
        tokens, and for the VLM (unless ``prefix`` is False) 4 patch
        embeddings ahead of them."""
        rng = np.random.default_rng(seed)
        if self.cfg.family == "audio":
            pe = rng.normal(size=(b, l, self.cfg.d_model)).astype(np.float32)
            labels = rng.integers(0, self.cfg.vocab, (b, l)).astype(np.int32)
            return ({"prefix_embeds": jnp.asarray(pe), "labels": jnp.asarray(labels)},
                    {"prefix_embeds": torch.from_numpy(pe), "labels": torch.from_numpy(labels)})
        toks = rng.integers(0, self.cfg.vocab, (b, l)).astype(np.int32)
        jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
        if self.cfg.family == "vlm" and prefix:
            pe = rng.normal(size=(b, 4, self.cfg.d_model)).astype(np.float32)
            jb["prefix_embeds"], tb["prefix_embeds"] = jnp.asarray(pe), torch.from_numpy(pe)
        return jb, tb


@pytest.fixture(scope="module", params=_NAMES)
def pair(request):
    return _Pair(request.param)


def _decoders(pair):
    if not pair.cfg.has_decoder:
        pytest.skip(f"{pair.cfg.name} is encoder-only: no cache, no decode step")


def test_forward_hidden_matches_jax(pair):
    jb, tb = pair.batch(0)
    want = pair.jm.forward_hidden(pair.jp, jb, dtype=jnp.float32, remat=False)
    got = pair.tm.forward_hidden(pair.tp, tb, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_TOL)


def test_loss_matches_jax(pair):
    jb, tb = pair.batch(1)
    want = pair.jm.loss_fn(pair.jp, jb, dtype=jnp.float32, remat=False, loss_chunk=5)
    got = pair.tm.loss_fn(pair.tp, tb, dtype=torch.float32, loss_chunk=5)
    np.testing.assert_allclose(float(got), float(want), **_TOL)


def test_prefill_logits_and_cache_match_jax(pair):
    _decoders(pair)
    jb, tb = pair.batch(2)
    jc = pair.jm.init_cache(_B, 32, dtype=jnp.float32)
    want, jc = jt.prefill(pair.cfg, pair.jp, jb["tokens"], jc, dtype=jnp.float32)
    tc = pair.tm.init_cache(_B, 32, dtype=torch.float32)
    got, tc2 = tt.prefill(pair.tcfg, pair.tp, tb["tokens"], tc, dtype=torch.float32)
    assert tc2 is tc  # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_TOL)
    for key in ("k", "v"):
        assert tc[key].shape == jc[key].shape
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **_TOL)


def test_decode_step_matches_jax(pair):
    """Three decode steps from a prefilled cache in each package."""
    _decoders(pair)
    jb, tb = pair.batch(3)
    jc = pair.jm.init_cache(_B, 32, dtype=jnp.float32)
    _, jc = jt.prefill(pair.cfg, pair.jp, jb["tokens"], jc, dtype=jnp.float32)
    tc = pair.tm.init_cache(_B, 32, dtype=torch.float32)
    tt.prefill(pair.tcfg, pair.tp, tb["tokens"], tc, dtype=torch.float32)
    rng = np.random.default_rng(4)
    for pos in range(_L, _L + 3):
        nxt = rng.integers(0, pair.cfg.vocab, (_B, 1)).astype(np.int32)
        want, jc = pair.jm.decode_step(pair.jp, jc, jnp.asarray(nxt), jnp.int32(pos),
                                       dtype=jnp.float32)
        got, tc = pair.tm.decode_step(pair.tp, tc, torch.from_numpy(nxt), pos,
                                      dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **_TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **_TOL)


def test_decode_matches_forward(pair):
    """Token-by-token decode over a sequence equals the parallel forward's
    per-position logits (``tests/test_train_serve.py``'s invariant)."""
    _decoders(pair)
    _, tb = pair.batch(5, prefix=False)
    h = pair.tm.forward_hidden(pair.tp, tb, dtype=torch.float32)
    table = tt.logits_table(pair.tcfg, pair.tp)
    want = (h @ table.T).numpy()
    cache = pair.tm.init_cache(_B, 32, dtype=torch.float32)
    got = []
    for t in range(_L):
        logits, cache = pair.tm.decode_step(pair.tp, cache, tb["tokens"][:, t:t + 1], t,
                                            dtype=torch.float32)
        got.append(logits.numpy())
    np.testing.assert_allclose(np.stack(got, axis=1), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 24)])
def test_chunked_attention_matches_jax(causal, window):
    """The query-chunked branch the CPU takes past ATTN_CHUNK_THRESHOLD,
    at a small chunk."""
    rng = np.random.default_rng(8)
    q = rng.normal(size=(2, 4, 64, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 2, 64, 16)).astype(np.float32) for _ in range(2))
    want = jlayers._sdpa_chunked(*map(jnp.asarray, (q, k, v)), causal,
                                 None if window is None else jnp.int32(window), 16, None)
    got = tlayers._sdpa_chunked(*map(torch.from_numpy, (q, k, v)), causal, window, 16, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_TOL)


@pytest.mark.parametrize("causal,softcap", [(True, None), (True, 30.0), (False, 30.0)])
def test_softcapped_sdpa_matches_jax(causal, softcap):
    rng = np.random.default_rng(9)
    q = rng.normal(size=(1, 4, 20, 16)).astype(np.float32) * 4
    k, v = (rng.normal(size=(1, 2, 20, 16)).astype(np.float32) * 4 for _ in range(2))
    want = jlayers._sdpa(*map(jnp.asarray, (q, k, v)), causal, None, softcap=softcap)
    got = tlayers._sdpa(*map(torch.from_numpy, (q, k, v)), causal, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_tanh", "relu"])
def test_mlp_activations_match_jax(act):
    """``"gelu"`` is jax.nn.gelu's default, the tanh form, in both."""
    rng = np.random.default_rng(10)
    p = {n: rng.normal(size=s).astype(np.float32)
         for n, s in [("w_up", (16, 32)), ("w_gate", (16, 32)), ("w_down", (32, 16))]}
    x = rng.normal(size=(3, 16)).astype(np.float32) * 2
    want = jlayers.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), act)
    got = tlayers.mlp({n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_TOL)


@pytest.mark.parametrize("name", _NAMES + ["zamba2-2.7b"])
def test_make_batch_matches_jax(name):
    cfg = jconfigs.get_config(name).reduced()
    want = jax_make_batch(cfg, np.random.default_rng(6), 2, 16)
    got = make_batch(tconfigs.get_config(name).reduced(), np.random.default_rng(6), 2, 16,
                     device="cpu")
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key].float().numpy(), np.asarray(arr, np.float32))


def test_configs_are_a_copy_of_the_reference():
    want, got = jconfigs.all_configs(), tconfigs.all_configs()
    assert sorted(got) == sorted(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(want[name])
        assert dataclasses.asdict(got[name].reduced()) == dataclasses.asdict(want[name].reduced())
        assert got[name].n_params() == want[name].n_params()
    assert tconfigs.SHAPES.keys() == jconfigs.SHAPES.keys()
    olmo = got["olmo-1b"]
    assert (olmo.n_layers, olmo.d_model, olmo.n_heads, olmo.hd, olmo.d_ff, olmo.vocab) == (
        16, 2048, 16, 128, 8192, 50304)


@pytest.mark.parametrize("name", ["zamba2-2.7b"])
def test_hybrid_family_builds_a_working_model(name):
    """The hybrid family's ``ModelApi`` on the CPU: init (a tied embedding,
    one shared block), forward, loss with a gradient through the shared
    block, and a decode step."""
    cfg = tconfigs.get_config(name).reduced()
    model = build_model(cfg, device="cpu")
    assert model.device == torch.device("cpu")
    params = model.init_params(0)
    assert len(params["blocks"]) == cfg.n_layers and "lm_head" not in params
    batch = make_batch(cfg, np.random.default_rng(0), 2, 16, device="cpu")
    h = model.forward_hidden(params, batch, dtype=torch.float32)
    assert h.shape == (2, 16, cfg.d_model) and bool(torch.isfinite(h).all())
    for p in jax.tree.leaves(params, is_leaf=lambda x: isinstance(x, torch.Tensor)):
        p.requires_grad_(True)
    loss = model.loss_fn(params, batch, dtype=torch.float32)
    loss.backward()
    assert bool(torch.isfinite(loss))
    assert float(params["shared_attn"]["attn"]["wq"].grad.abs().max()) > 0
    assert float(params["blocks"][0]["A_log"].grad.abs().max()) > 0
    cache = model.init_cache(2, 8, dtype=torch.float32)
    with torch.no_grad():
        logits, cache = model.decode_step(params, cache, batch["tokens"][:, :1], 0,
                                          dtype=torch.float32)
    assert logits.shape == (2, cfg.vocab) and bool(torch.isfinite(logits).all())
    assert float(cache["ssm"].abs().max()) > 0 and float(cache["k"][:, :, :, 0].abs().max()) > 0


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"])
def test_moe_family_builds_a_working_model(name):
    """The moe family's ``ModelApi`` on the CPU: init, forward (hidden and
    the aux loss), loss with a gradient, and a decode step."""
    cfg = tconfigs.get_config(name).reduced()
    model = build_model(cfg, device="cpu")
    assert model.device == torch.device("cpu")
    params = model.init_params(0)
    batch = make_batch(cfg, np.random.default_rng(0), 2, 16, device="cpu")
    h, aux = model.forward_hidden(params, batch, dtype=torch.float32, extra_slots=4)
    assert h.shape == (2, 16, cfg.d_model) and bool(torch.isfinite(h).all())
    assert float(aux) > 0
    for p in jax.tree.leaves(params, is_leaf=lambda x: isinstance(x, torch.Tensor)):
        p.requires_grad_(True)
    loss = model.loss_fn(params, batch, dtype=torch.float32)
    loss.backward()
    assert bool(torch.isfinite(loss)) and float(params["blocks"][0]["router"].grad.abs().max()) > 0
    cache = model.init_cache(2, 8, dtype=torch.float32)
    with torch.no_grad():
        logits, cache = model.decode_step(params, cache, batch["tokens"][:, :1], 0,
                                          dtype=torch.float32)
    assert logits.shape == (2, cfg.vocab) and bool(torch.isfinite(logits).all())


def test_serve_example_runs_the_moe_family(capsys):
    """``examples/serve_lm_torch.py --arch qwen2-moe-a2.7b --device cpu``."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "serve_lm_torch.py"
    spec = importlib.util.spec_from_file_location("serve_lm_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert example.main(["--arch", "qwen2-moe-a2.7b", "--device", "cpu", "--requests", "5",
                         "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "arch=qwen2-moe-a2.7b: served 5 requests, 20 tokens" in out


def test_serve_example_runs_the_hybrid_family(capsys):
    """``examples/serve_lm_torch.py --arch zamba2-2.7b --device cpu``."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "serve_lm_torch.py"
    spec = importlib.util.spec_from_file_location("serve_lm_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert example.main(["--arch", "zamba2-2.7b", "--device", "cpu", "--requests", "5",
                         "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "arch=zamba2-2.7b: served 5 requests, 20 tokens" in out


def test_init_params_shapes_match_jax():
    cfg = jconfigs.get_config("hubert-xlarge").reduced()
    want = jax.tree.map(np.shape, jax_build(cfg).init_params(jax.random.PRNGKey(0)))
    got = build_model(tconfigs.get_config("hubert-xlarge").reduced(), device="cpu").init_params(0)
    flat_w = jax.tree_util.tree_leaves_with_path(want, is_leaf=lambda x: isinstance(x, tuple))
    for path, shape in flat_w:
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            node = got["blocks"][0]
            for key in keys[1:]:
                node = node[key]
            assert tuple(node.shape) == tuple(shape[1:]), keys
            assert len(got["blocks"]) == shape[0]
        else:
            node = got
            for key in keys:
                node = node[key]
            assert tuple(node.shape) == tuple(shape), keys


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = tconfigs.get_config("olmo-1b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(cfg, np.random.default_rng(0), 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init_kv_cache(cfg, 1, 8)
