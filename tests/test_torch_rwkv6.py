"""The port's RWKV-6 (reduced rwkv6-3b) against the JAX package's, on the
CPU: the same weights (carried by ``params_from_jax``) and the same seeded
inputs through ``time_mix``, ``channel_mix``, ``forward_hidden``,
``loss_fn``, ``decode_step``, ``greedy_generate`` and ``BucketServer`` of
both; the loss's gradients (with and without remat) and two train steps.
The JAX initialisation sets ``u = 0``, every ``mu = 0.5`` and unit norms,
so the weights are perturbed first (in numpy, for both packages) to reach
the bonus term, the mixing and the norms' parameters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build
from repro.models import rwkv6 as jr
from repro.serve import BucketServer as JaxBucketServer
from repro.serve import Request as JaxRequest
from repro.serve import greedy_generate as jax_greedy
from repro_torch import configs as tconfigs
from repro_torch.kernels import wkv6 as wk
from repro_torch.models import build_model, convert, params_from_jax
from repro_torch.models import rwkv6 as tr
from repro_torch.serve import BucketServer, Request, greedy_generate
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import _flatten_with_paths

_TOL = dict(rtol=2e-4, atol=2e-4)
# bf16 runs the projections in bf16 in both packages, with other summation
# orders in their matmuls: hidden states and logits of a few units agree to
# about two bf16 ulps (0.033 at |h| = 3.8 here, where one ulp is 0.0156)
_BF16_TOL = dict(rtol=5e-2, atol=5e-2)
_NAME = "rwkv6-3b"
_B, _L = 2, 12


def _perturb(params: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: np.array(a, dtype=np.float32), params)
    tm, cm = p["blocks"]["tm"], p["blocks"]["cm"]
    for mu in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
        tm[mu] = rng.uniform(0, 1, tm[mu].shape).astype(np.float32)
    for mu in ("mu_k", "mu_r"):
        cm[mu] = rng.uniform(0, 1, cm[mu].shape).astype(np.float32)
    tm["u"] = (rng.normal(size=tm["u"].shape) * 0.5).astype(np.float32)
    tm["w0"] = (tm["w0"] + rng.normal(size=tm["w0"].shape) * 0.5).astype(np.float32)
    tm["wB"] = (rng.normal(size=tm["wB"].shape) * 0.3).astype(np.float32)
    for norm in (tm["ln_x"], p["blocks"]["ln1"], p["blocks"]["ln2"], p["ln0"], p["final_norm"]):
        norm["scale"] = (1 + rng.normal(size=norm["scale"].shape) * 0.1).astype(np.float32)
        norm["bias"] = (rng.normal(size=norm["bias"].shape) * 0.1).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def pair():
    cfg = jconfigs.get_config(_NAME).reduced()
    tcfg = tconfigs.get_config(_NAME).reduced()
    jm = jax_build(cfg)
    arrays = _perturb(jm.init_params(jax.random.PRNGKey(3)), 3)
    jp = jax.tree.map(jnp.asarray, arrays)
    tm = build_model(tcfg, device="cpu")
    return cfg, tcfg, jm, jp, tm, params_from_jax(tcfg, arrays, device="cpu")


def _tokens(cfg, seed, b=_B, l=_L):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, l)).astype(np.int32)


def _block(jp, i):
    return jax.tree.map(lambda a: a[i], jp["blocks"])


def test_time_mix_matches_jax(pair):
    """Output, final state and last token, from a non-zero state and a
    carried previous token."""
    cfg, tcfg, _, jp, _, tp = pair
    rng = np.random.default_rng(0)
    x = rng.normal(size=(_B, _L, cfg.d_model)).astype(np.float32)
    s0 = (rng.normal(size=(_B, cfg.n_heads, cfg.hd, cfg.hd)) * 0.3).astype(np.float32)
    prev = rng.normal(size=(_B, cfg.d_model)).astype(np.float32)
    want = jr.time_mix(_block(jp, 1)["tm"], jnp.asarray(x), cfg, s0=jnp.asarray(s0),
                       x_prev=jnp.asarray(prev), chunk=8)
    got = tr.time_mix(tp["blocks"][1]["tm"], torch.from_numpy(x), tcfg,
                      s0=torch.from_numpy(s0), x_prev=torch.from_numpy(prev))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **_TOL)
    # from zero, as forward_hidden calls it
    want0 = jr.time_mix(_block(jp, 0)["tm"], jnp.asarray(x), cfg)
    got0 = tr.time_mix(tp["blocks"][0]["tm"], torch.from_numpy(x), tcfg)
    for g, w in zip(got0, want0):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **_TOL)


@pytest.mark.parametrize("with_prev", [False, True])
def test_channel_mix_matches_jax(pair, with_prev):
    cfg, _, _, jp, _, tp = pair
    rng = np.random.default_rng(1)
    x = rng.normal(size=(_B, _L, cfg.d_model)).astype(np.float32)
    prev = rng.normal(size=(_B, cfg.d_model)).astype(np.float32) if with_prev else None
    want = jr.channel_mix(_block(jp, 0)["cm"], jnp.asarray(x),
                          None if prev is None else jnp.asarray(prev))
    got = tr.channel_mix(tp["blocks"][0]["cm"], torch.from_numpy(x),
                         None if prev is None else torch.from_numpy(prev))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **_TOL)


def test_shift_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 5, 8)).astype(np.float32)
    prev = x[:, 0] * 3
    np.testing.assert_array_equal(tr._shift(torch.from_numpy(x)).numpy(),
                                  np.asarray(jr._shift(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tr._shift(torch.from_numpy(x), torch.from_numpy(prev)).numpy(),
        np.asarray(jr._shift(jnp.asarray(x), jnp.asarray(prev))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_hidden_matches_jax(pair, dtype):
    cfg, _, jm, jp, tm, tp = pair
    toks = _tokens(cfg, 4)
    want = jm.forward_hidden(jp, {"tokens": jnp.asarray(toks)}, dtype=getattr(jnp, dtype),
                             remat=False)
    got = tm.forward_hidden(tp, {"tokens": torch.from_numpy(toks)}, dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (_B, _L, cfg.d_model)
    tol = _TOL if dtype == "float32" else _BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype,chunk", [("float32", 5), ("float32", 512), ("bfloat16", 5)])
def test_loss_matches_jax(pair, dtype, chunk):
    cfg, _, jm, jp, tm, tp = pair
    toks = _tokens(cfg, 5)
    want = jm.loss_fn(jp, {"tokens": jnp.asarray(toks)}, dtype=getattr(jnp, dtype),
                      remat=False, loss_chunk=chunk)
    got = tm.loss_fn(tp, {"tokens": torch.from_numpy(toks)}, dtype=getattr(torch, dtype),
                     loss_chunk=chunk)
    tol = _TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(float(got), float(want), **tol)


def test_decode_step_matches_jax(pair):
    """Five steps from a zero state: the logits and every state leaf after
    each, the port's state updated in place."""
    cfg, _, jm, jp, tm, tp = pair
    js = jm.init_cache(_B, 0, dtype=jnp.float32)
    ts = tm.init_cache(_B, dtype=torch.float32)
    for key in ("wkv", "x_tm", "x_cm"):
        assert tuple(ts[key].shape) == js[key].shape
        assert str(ts[key].dtype).split(".")[1] == str(js[key].dtype)
    toks = _tokens(cfg, 6, l=5)
    for t in range(5):
        want, js = jm.decode_step(jp, js, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t),
                                  dtype=jnp.float32)
        got, ts2 = tm.decode_step(tp, ts, torch.from_numpy(toks[:, t:t + 1]), t,
                                  dtype=torch.float32)
        assert ts2 is ts
        assert got.dtype == torch.float32 and got.shape == (_B, cfg.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **_TOL)
        for key in ("wkv", "x_tm", "x_cm"):
            np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]), **_TOL)


def test_decode_step_bf16_matches_jax(pair):
    cfg, _, jm, jp, tm, tp = pair
    js = jm.init_cache(_B, 0, dtype=jnp.bfloat16)
    ts = tm.init_cache(_B, dtype=torch.bfloat16)
    toks = _tokens(cfg, 7, l=3)
    for t in range(3):
        want, js = jm.decode_step(jp, js, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t),
                                  dtype=jnp.bfloat16)
        got, ts = tm.decode_step(tp, ts, torch.from_numpy(toks[:, t:t + 1]), t,
                                 dtype=torch.bfloat16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **_BF16_TOL)
    assert ts["wkv"].dtype == torch.float32 and ts["x_tm"].dtype == torch.bfloat16


def test_decode_matches_forward(pair):
    """Token-by-token decode equals the parallel forward's per-position
    logits (``tests/test_train_serve.py``'s invariant), in the port alone."""
    cfg, _, _, _, tm, tp = pair
    toks = torch.from_numpy(_tokens(cfg, 8))
    h = tm.forward_hidden(tp, {"tokens": toks}, dtype=torch.float32)
    want = (h @ tp["lm_head"]["w"]).numpy()
    state = tm.init_cache(_B, 32, dtype=torch.float32)
    got = []
    for t in range(_L):
        logits, state = tm.decode_step(tp, state, toks[:, t:t + 1], t, dtype=torch.float32)
        got.append(logits.numpy())
    np.testing.assert_allclose(np.stack(got, axis=1), want, rtol=2e-3, atol=2e-3)


def test_greedy_generate_matches_jax(pair):
    cfg, _, jm, jp, tm, tp = pair
    prompts = _tokens(cfg, 9, l=8)
    want = jax_greedy(jm, jp, prompts, max_new=6, dtype=jnp.float32)
    got = greedy_generate(tm, tp, prompts, max_new=6, dtype=torch.float32)
    assert got.shape == (_B, 6)
    np.testing.assert_array_equal(got, want)


def test_bucket_server_matches_jax_and_solo(pair):
    cfg, _, jm, jp, tm, tp = pair
    rng = np.random.default_rng(10)
    prompts = {7: rng.integers(0, cfg.vocab, size=(3, 7)).astype(np.int32),
               4: rng.integers(0, cfg.vocab, size=(2, 4)).astype(np.int32)}
    reqs = [(0, prompts[7][0], 4), (1, prompts[4][0], 3), (2, prompts[7][1], 4),
            (3, prompts[7][2], 2), (4, prompts[4][1], 5)]
    jax_server = JaxBucketServer(jm, jp, max_batch=2, dtype=jnp.float32)
    server = BucketServer(tm, tp, max_batch=2, dtype=torch.float32)
    for uid, prompt, max_new in reqs:
        jax_server.submit(JaxRequest(uid=uid, prompt=prompt, max_new=max_new))
        server.submit(Request(uid=uid, prompt=prompt, max_new=max_new))
    want = {c.uid: c.tokens for c in jax_server.drain()}
    got = {c.uid: c.tokens for c in server.drain()}
    assert sorted(got) == sorted(want) == [0, 1, 2, 3, 4]
    for uid, prompt, max_new in reqs:
        np.testing.assert_array_equal(got[uid], want[uid])
        solo = greedy_generate(tm, tp, prompt[None], max_new, dtype=torch.float32)
        np.testing.assert_array_equal(got[uid], solo[0])


def test_model_api_of_the_ssm_family(pair):
    """``build_model`` builds the family; ``init_cache`` ignores max_seq (the
    state does not grow with the context); the forward runs the recurrence
    through the wkv6 wrapper once per layer."""
    cfg, tcfg, _, _, tm, tp = pair
    assert tm.decode_step is not None and tm.device == torch.device("cpu")
    a, b = tm.init_cache(3, 10), tm.init_cache(3, 5000)
    assert all(a[key].shape == b[key].shape for key in a)
    assert a["wkv"].shape == (cfg.n_layers, 3, cfg.n_heads, cfg.hd, cfg.hd)
    calls = []
    launched = wk.LAUNCHES["wkv6"]
    orig = tr.wkv6
    tr.wkv6 = lambda *args, **kw: calls.append(args[0].shape) or orig(*args, **kw)
    try:
        tm.forward_hidden(tp, {"tokens": torch.from_numpy(_tokens(cfg, 11))},
                          dtype=torch.float32)
    finally:
        tr.wkv6 = orig
    assert calls == [(_B, _L, cfg.n_heads, cfg.hd)] * cfg.n_layers
    assert wk.LAUNCHES["wkv6"] == launched  # the CPU never launches the kernel


def test_params_from_jax_keeps_the_whole_tree(pair):
    cfg, _, _, jp, _, tp = pair
    assert sorted(tp) == sorted(jp) == ["blocks", "embed", "final_norm", "lm_head", "ln0"]
    np.testing.assert_array_equal(tp["ln0"]["scale"].numpy(), np.asarray(jp["ln0"]["scale"]))
    blk = tp["blocks"][1]
    assert sorted(blk) == ["cm", "ln1", "ln2", "tm"]
    np.testing.assert_array_equal(blk["tm"]["ln_x"]["bias"].numpy(),
                                  np.asarray(jp["blocks"]["tm"]["ln_x"]["bias"][1]))
    np.testing.assert_array_equal(blk["tm"]["u"].numpy(), np.asarray(jp["blocks"]["tm"]["u"][1]))
    assert len(tp["blocks"]) == cfg.n_layers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_params_shapes_match_jax(dtype):
    cfg = jconfigs.get_config(_NAME).reduced()
    want = jax.tree.map(np.shape, jax_build(cfg).init_params(jax.random.PRNGKey(0)))
    got = build_model(tconfigs.get_config(_NAME).reduced(), device="cpu").init_params(0, dtype)
    kept_f32 = {"w0", "wA", "wB", "u", "ln_x", "ln0", "ln1", "ln2", "final_norm"}
    flat_w = jax.tree_util.tree_leaves_with_path(want, is_leaf=lambda x: isinstance(x, tuple))
    assert len(flat_w) == len(jax.tree_util.tree_leaves(
        {k: v for k, v in got.items() if k != "blocks"})) + len(
        jax.tree_util.tree_leaves(got["blocks"][0]))
    for path, shape in flat_w:
        keys = [p.key for p in path]
        node = got["blocks"][0] if keys[0] == "blocks" else got
        for key in keys[1:] if keys[0] == "blocks" else keys:
            node = node[key]
        assert tuple(node.shape) == tuple(shape[1:] if keys[0] == "blocks" else shape), keys
        assert node.dtype == (torch.float32 if kept_f32 & set(keys) else dtype), keys
    assert len(got["blocks"]) == cfg.n_layers
    tm0 = got["blocks"][0]["tm"]
    assert float(tm0["w0"][0]) == -2.0 and float(tm0["mu_w"][0]) == 0.5
    assert not tm0["u"].any() and float(tm0["wB"].float().std()) < 0.02


def test_init_params_is_seeded():
    cfg = tconfigs.get_config(_NAME).reduced()
    a, b = (tr.init_params(cfg, 4, device="cpu") for _ in range(2))
    c = tr.init_params(cfg, 5, device="cpu")
    assert torch.equal(a["blocks"][1]["tm"]["Wk"], b["blocks"][1]["tm"]["Wk"])
    assert not torch.equal(a["blocks"][1]["tm"]["Wk"], c["blocks"][1]["tm"]["Wk"])


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = tconfigs.get_config(_NAME).reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.init_state(cfg, 1)
    assert tr.init_state(cfg, 1, device="cpu")["wkv"].device.type == "cpu"


# ------------------------------------------------------------------ training
# the loss to 2e-5 relative and every gradient to 2e-4 relative with a floor
# of 1e-5, as tests/test_torch_train.py holds the dense family (fp32 sums in
# another order)
_GRAD_TOL = dict(rtol=2e-4, atol=1e-5)


def _grad_params(tcfg, jp):
    params = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    for p in topt.leaves(params):
        p.requires_grad_(True)
    return params


def _flat_grads(params) -> dict:
    return _flatten_with_paths(topt.map_tree(
        lambda p: p.grad if p.grad is not None else torch.zeros_like(p), params))


def _jax_flat(tree) -> dict:
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        flat["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)] = \
            np.asarray(leaf)
    return convert.flat_from_jax_layout(flat)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_gradients_match_jax(pair, remat):
    """``loss_fn`` and the gradient of every parameter (the recurrence's
    through ``Wkv6Fn`` and the plain backward) against ``jax.value_and_grad``
    of the JAX package's ``loss_fn`` (fp32, remat on the JAX side, chunked
    cross-entropy over ragged chunks of 5)."""
    cfg, tcfg, jm, jp, tm, _ = pair
    toks = _tokens(cfg, 6)
    loss, grads = jax.value_and_grad(lambda p: jm.loss_fn(
        p, {"tokens": jnp.asarray(toks)}, dtype=jnp.float32, loss_chunk=5))(jp)
    params = _grad_params(tcfg, jp)
    got = tm.loss_fn(params, {"tokens": torch.from_numpy(toks)}, dtype=torch.float32,
                     remat=remat, loss_chunk=5)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=2e-5)
    want, have = _jax_flat(grads), _flat_grads(params)
    assert sorted(have) == sorted(want)
    for key in want:
        np.testing.assert_allclose(have[key], want[key], err_msg=key, **_GRAD_TOL)
    assert all(np.abs(have[f"blocks/{i}/tm/{n}"]).max() > 0
               for i in range(cfg.n_layers) for n in ("u", "w0", "Wr", "Wk", "Wv"))


def test_remat_gives_the_same_gradients_and_recomputes_every_block(pair, monkeypatch):
    """``remat=True`` recomputes each block in the backward (the recurrence
    runs twice a layer, its backward once): the same gradients as
    ``remat=False``, bit for bit."""
    cfg, tcfg, _, jp, tm, _ = pair
    toks = {"tokens": torch.from_numpy(_tokens(cfg, 7))}
    calls = []
    orig = tr.wkv6
    monkeypatch.setattr(tr, "wkv6", lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    runs = []
    for remat, per_layer in [(True, 2), (False, 1)]:
        params = _grad_params(tcfg, jp)
        calls.clear()
        tm.loss_fn(params, toks, dtype=torch.float32, remat=remat, loss_chunk=5).backward()
        assert len(calls) == per_layer * cfg.n_layers, (remat, len(calls))
        runs.append(_flat_grads(params))
    assert all(np.array_equal(runs[0][k], runs[1][k]) for k in runs[1])


def test_two_train_steps_track_jax(pair):
    """Two ``make_train_step`` steps against the JAX package's jitted step,
    weight decay 0 (the JAX package decays its stacked [L, d] vectors, the
    port's 1-D per-layer vectors are not matrices: ROADMAP's AdamW note):
    loss, grad_norm and lr each step to 2e-4 relative, the params after two
    steps to 1e-3 of the update's own size (as the dense family's test)."""
    from repro import train as jtrain
    from repro.train import optimizer as jopt
    from repro_torch import train as ttrain

    cfg, tcfg, jm, jp, tm, _ = pair
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.0)
    batch = _tokens(cfg, 8)
    jstep = jax.jit(jtrain.make_train_step(jm, jopt.OptConfig(**opt), {"dtype": jnp.float32}))
    tstep = ttrain.make_train_step(tm, topt.OptConfig(**opt), {"dtype": torch.float32})
    js = jopt.init_opt_state(jp)
    tp = _grad_params(tcfg, jp)
    ts = topt.init_opt_state(tp)
    jparams, p0 = jp, _jax_flat(jp)
    for _ in range(2):
        jparams, js, jmet = jstep(jparams, js, {"tokens": jnp.asarray(batch)})
        tp, ts, tmet = tstep(tp, ts, {"tokens": torch.from_numpy(batch)})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=2e-4,
                                       err_msg=key)
    want, have = _jax_flat(jparams), _flatten_with_paths(tp)
    moved = np.sqrt(sum(np.sum((want[k] - p0[k]) ** 2) for k in want))
    diff = np.sqrt(sum(np.sum((have[k] - want[k]) ** 2) for k in want))
    assert diff <= 1e-3 * moved, (diff, moved)


def test_train_state_layout_covers_the_ssm_tree(pair):
    """The JAX package's RWKV-6 training state (blocks stacked, the nested
    ``tm``/``cm``/``ln_x`` dicts, fp32 m and v, int32 step) crosses into the
    port and back through ``models.convert`` leaf for leaf, bit for bit, and
    ``restore_tree`` rebuilds the port's state from the checkpoint's flat
    arrays."""
    from repro.train import optimizer as jopt
    from repro_torch.train import restore_tree

    _, tcfg, _, jp, _, _ = pair
    tree = jax.tree.map(np.asarray, {"params": jp, "opt": jopt.init_opt_state(jp)})
    state = convert.train_state_from_jax(tcfg, tree, device="cpu")
    assert len(state["params"]["blocks"]) == tcfg.n_layers
    back = convert.train_state_to_jax_layout(state)
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    assert all(g.dtype == w.dtype and np.array_equal(g, w) for (_, g), (_, w) in zip(got, want))
    template = {"params": topt.map_tree(torch.zeros_like, state["params"]),
                "opt": topt.init_opt_state(state["params"])}
    restored = restore_tree(template, convert.flat_from_jax_layout(_flatten_with_paths(back)))
    for a, b in zip(topt.leaves(restored), topt.leaves(state)):
        assert torch.equal(a, b)
