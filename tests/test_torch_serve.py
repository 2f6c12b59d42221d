"""The port's serving engine against the JAX package's, on the CPU in fp32:
``greedy_generate`` tokens and ``BucketServer`` completions on the same
weights (carried by ``params_from_jax``) and prompts; the port's parallel
``prefill`` against its own ``scan_prefill``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build
from repro.serve import BucketServer as JaxBucketServer
from repro.serve import Request as JaxRequest
from repro.serve import greedy_generate as jax_greedy
from repro_torch import configs as tconfigs
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import transformer as tt
from repro_torch.serve import BucketServer, Request, greedy_generate, scan_prefill


def _pair(name: str, seed: int):
    cfg = jconfigs.get_config(name).reduced()
    jm = jax_build(cfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tcfg = tconfigs.get_config(name).reduced()
    tm = build_model(tcfg, device="cpu")
    return cfg, jm, jp, tm, params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("name", ["olmo-1b", "granite-3-8b", "gemma3-4b"])
def test_greedy_generate_matches_jax(name):
    cfg, jm, jp, tm, tp = _pair(name, 5)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 8)).astype(np.int32)
    want = jax_greedy(jm, jp, prompts, max_new=5, dtype=jnp.float32)
    got = greedy_generate(tm, tp, prompts, max_new=5, dtype=torch.float32)
    assert got.shape == (2, 5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(greedy_generate(tm, tp, prompts, 5, dtype=torch.float32), got)


def test_greedy_generate_one_token():
    """max_new = 1 is the argmax after the prompt and no decode step."""
    cfg, jm, jp, tm, tp = _pair("olmo-1b", 6)
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, size=(3, 4)).astype(np.int32)
    np.testing.assert_array_equal(greedy_generate(tm, tp, prompts, 1, dtype=torch.float32),
                                  jax_greedy(jm, jp, prompts, 1, dtype=jnp.float32))


def test_bucket_server_matches_jax_and_solo():
    cfg, jm, jp, tm, tp = _pair("olmo-1b", 5)
    rng = np.random.default_rng(5)
    prompts = {8: rng.integers(0, cfg.vocab, size=(3, 8)).astype(np.int32),
               5: rng.integers(0, cfg.vocab, size=(2, 5)).astype(np.int32)}
    reqs = [(0, prompts[8][0], 4), (1, prompts[5][0], 3), (2, prompts[8][1], 4),
            (3, prompts[8][2], 2), (4, prompts[5][1], 4)]
    jax_server = JaxBucketServer(jm, jp, max_batch=2, dtype=jnp.float32)
    server = BucketServer(tm, tp, max_batch=2, dtype=torch.float32)
    for uid, prompt, max_new in reqs:
        jax_server.submit(JaxRequest(uid=uid, prompt=prompt, max_new=max_new))
        server.submit(Request(uid=uid, prompt=prompt, max_new=max_new))
    # the fullest bucket first: both serve the 8-token bucket's first two
    first = server.run_wave()
    assert [c.uid for c in first] == [0, 2]
    want = {c.uid: c.tokens for c in jax_server.drain()}
    got = {c.uid: c.tokens for c in first + server.drain()}
    assert sorted(got) == sorted(want) == [0, 1, 2, 3, 4]
    for uid, prompt, max_new in reqs:
        np.testing.assert_array_equal(got[uid], want[uid])
        assert got[uid].shape == (max_new,)
        solo = greedy_generate(tm, tp, prompt[None], max_new, dtype=torch.float32)
        np.testing.assert_array_equal(got[uid], solo[0])
    assert server.run_wave() == []


@pytest.mark.parametrize("name", ["gemma3-4b", "olmo-1b"])
def test_prefill_matches_scan_prefill(name):
    """The parallel prefill fills the cache as the token-by-token one does:
    the same logits now and one decode step later."""
    cfg, _, _, tm, tp = _pair(name, 11)
    rng = np.random.default_rng(11)
    b, l = 2, 10
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (b, l)).astype(np.int32))
    cache_a = tm.init_cache(b, 32, dtype=torch.float32)
    logits_a, cache_a = tt.prefill(tm.cfg, tp, prompts, cache_a, dtype=torch.float32)
    cache_b = tm.init_cache(b, 32, dtype=torch.float32)
    logits_b, cache_b = scan_prefill(tm, tp, cache_b, prompts, dtype=torch.float32)
    torch.testing.assert_close(logits_a, logits_b, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(cache_a["k"], cache_b["k"], rtol=2e-4, atol=2e-4)
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32))
    la, _ = tm.decode_step(tp, cache_a, nxt, l, dtype=torch.float32)
    lb, _ = tm.decode_step(tp, cache_b, nxt, l, dtype=torch.float32)
    torch.testing.assert_close(la, lb, rtol=2e-4, atol=2e-4)


def test_encoder_has_no_decoder():
    tm = build_model(tconfigs.get_config("hubert-xlarge").reduced(), device="cpu")
    assert tm.init_cache is None and tm.decode_step is None
