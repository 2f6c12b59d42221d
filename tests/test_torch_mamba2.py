"""The port's Zamba2 hybrid (``repro_torch.models.mamba2``, reduced
zamba2-2.7b: 4 Mamba2 layers, the shared block after every 2) against the
JAX package's ``repro.models.mamba2`` on the CPU, on the same weights
(carried by ``params_from_jax``) and the same seeded inputs.

The JAX initialisation sets ``A_log = 0``, ``D = 1``, ``dt_bias = -1``,
zero conv biases and unit norms, so the weights are perturbed first (in
numpy, for both packages) to reach every head's own decay and the norms'
parameters.  Tolerances are relative to each tensor's largest entry, in
fp32: the conv bit for bit, the SSD 2e-4 (the port's chunked matrix form
sums in another order than the JAX package's sequential scan), the
forward, the loss and decode 1e-4, gradients 1e-3 of each leaf's largest
entry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build
from repro.models import mamba2 as jm
from repro.serve import greedy_generate as jax_greedy
from repro_torch import configs as tconfigs
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import mamba2 as tm
from repro_torch.models import transformer as tt
from repro_torch.serve import greedy_generate
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import _flatten_with_paths

_NAME = "zamba2-2.7b"
_B, _L = 2, 20


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _perturb(params: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: np.array(a, dtype=np.float32), params)
    blk = p["blocks"]
    blk["A_log"] = rng.normal(size=blk["A_log"].shape).astype(np.float32) * 0.5
    blk["D"] = (1 + rng.normal(size=blk["D"].shape) * 0.3).astype(np.float32)
    blk["dt_bias"] = (blk["dt_bias"] + rng.normal(size=blk["dt_bias"].shape)).astype(np.float32)
    blk["conv_b"] = (rng.normal(size=blk["conv_b"].shape) * 0.1).astype(np.float32)
    norms = [blk["ln"], p["final_norm"], p["shared_attn"]["ln1"], p["shared_attn"]["ln2"]]
    for norm in norms:
        norm["scale"] = (1 + rng.normal(size=norm["scale"].shape) * 0.1).astype(np.float32)
    blk["norm_scale"] = (1 + rng.normal(size=blk["norm_scale"].shape) * 0.1).astype(np.float32)
    return p


class _Pair:
    def __init__(self):
        self.cfg = jconfigs.get_config(_NAME).reduced()
        self.tcfg = tconfigs.get_config(_NAME).reduced()
        self.jm = jax_build(self.cfg)
        arrays = _perturb(self.jm.init_params(jax.random.PRNGKey(3)), 3)
        self.jp = jax.tree.map(jnp.asarray, arrays)
        self.tm = build_model(self.tcfg, device="cpu")
        self.tp = params_from_jax(self.tcfg, arrays, device="cpu")

    def tokens(self, seed: int, b: int = _B, l: int = _L):
        toks = np.random.default_rng(seed).integers(0, self.cfg.vocab, (b, l)).astype(np.int32)
        return jnp.asarray(toks), torch.from_numpy(toks)


@pytest.fixture(scope="module")
def pair():
    return _Pair()


def test_reduced_config_has_two_groups(pair):
    assert tm._groups(pair.tcfg) == jm._groups(pair.cfg) == (2, 2)
    assert pair.tcfg.n_layers == 4 and pair.tcfg.hybrid_period == 2


# ----------------------------------------------------------------- the mixer
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("l", [1, 7])
def test_causal_conv_matches_jax_bit_for_bit(with_state, l):
    rng = np.random.default_rng(l)
    x = rng.normal(size=(2, l, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    state = rng.normal(size=(2, 3, 24)).astype(np.float32) if with_state else None
    want_y, want_s = jm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                     None if state is None else jnp.asarray(state))
    got_y, got_s = tm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                   None if state is None else torch.from_numpy(state))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def _ssd_inputs(seed: int, l: int, b: int = 2, h: int = 4, p: int = 8, s: int = 8):
    """SSD inputs as ``mamba_mix`` makes them: dt = softplus(.), A < 0 per
    head, a non-zero initial state."""
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, l, h)))).astype(np.float32)
    a = -np.exp(rng.normal(size=h) * 0.5).astype(np.float32)
    log_decay = (dt * a).astype(np.float32)
    bm = rng.normal(size=(b, l, s)).astype(np.float32)
    cm = rng.normal(size=(b, l, s)).astype(np.float32)
    s0 = rng.normal(size=(b, h, p, s)).astype(np.float32)
    return xh, dt, log_decay, bm, cm, s0


@pytest.mark.parametrize("l,chunk", [(64, 64), (100, 64), (1, 64), (130, 32), (5, 64)])
def test_ssd_matches_jax_scan(l, chunk):
    """The chunked matrix form against ``_ssd_scan``'s sequential scan: y and
    the state after token L; L = 100 and 130 pad their last chunk, L = 1 is
    the direct update."""
    xh, dt, log_decay, bm, cm, s0 = _ssd_inputs(l, l)
    want_y, want_s = jm._ssd_scan(jnp.asarray(xh), jnp.asarray(dt),
                                  jnp.exp(jnp.asarray(log_decay)), jnp.asarray(bm),
                                  jnp.asarray(cm), jnp.asarray(s0), chunk)
    got_y, got_s = tm.ssd(*(torch.from_numpy(a) for a in (xh, dt, log_decay, bm, cm, s0)),
                          chunk=chunk)
    assert got_y.shape == (2, l, 4, 8) and got_s.shape == (2, 4, 8, 8)
    assert _rel_err(got_y.numpy(), want_y) <= 2e-4
    assert _rel_err(got_s.numpy(), want_s) <= 2e-4


def test_ssd_strong_decay_stays_finite():
    """A decay that underflows in the JAX package's exp(dt A) (dt A = -200)
    gives finite outputs here: every exponent is a sum of log decays."""
    xh, dt, log_decay, bm, cm, s0 = _ssd_inputs(9, 70)
    log_decay[:, 30:40] = -200.0
    got_y, got_s = tm.ssd(*(torch.from_numpy(a) for a in (xh, dt, log_decay, bm, cm, s0)))
    want_y, want_s = jm._ssd_scan(jnp.asarray(xh), jnp.asarray(dt),
                                  jnp.exp(jnp.asarray(log_decay)), jnp.asarray(bm),
                                  jnp.asarray(cm), jnp.asarray(s0), 64)
    assert bool(torch.isfinite(got_y).all()) and bool(torch.isfinite(got_s).all())
    assert _rel_err(got_y.numpy(), want_y) <= 2e-4
    assert _rel_err(got_s.numpy(), want_s) <= 2e-4


def _block(jp, i):
    return jax.tree.map(lambda a: a[i], jp["blocks"])


@pytest.mark.parametrize("l", [1, 20])
def test_mamba_mix_matches_jax(pair, l):
    """Output, SSM state and conv state of one mixer from given states."""
    rng = np.random.default_rng(l)
    cfg = pair.cfg
    x = rng.normal(size=(_B, l, cfg.d_model)).astype(np.float32)
    hd = cfg.d_inner // cfg.ssm_heads
    s0 = (rng.normal(size=(_B, cfg.ssm_heads, hd, cfg.ssm_state)) * 0.3).astype(np.float32)
    c0 = rng.normal(size=(_B, 3, cfg.d_inner)).astype(np.float32)
    want = jm.mamba_mix(_block(pair.jp, 1), jnp.asarray(x), cfg, ssm_state=jnp.asarray(s0),
                        conv_state=jnp.asarray(c0), chunk=8)
    got = tm.mamba_mix(pair.tp["blocks"][1], torch.from_numpy(x), pair.tcfg,
                       ssm_state=torch.from_numpy(s0), conv_state=torch.from_numpy(c0), chunk=8)
    for g, w in zip(got, want):
        assert _rel_err(g.numpy(), w) <= 1e-4


# ------------------------------------------------------------- the model
def test_forward_hidden_matches_jax(pair):
    jt, tt_ = pair.tokens(0)
    want = pair.jm.forward_hidden(pair.jp, {"tokens": jt}, dtype=jnp.float32, remat=False)
    got = pair.tm.forward_hidden(pair.tp, {"tokens": tt_}, dtype=torch.float32, remat=False)
    assert got.shape == (_B, _L, pair.cfg.d_model)
    assert _rel_err(got.numpy(), want) <= 1e-4


def test_forward_hidden_with_prefix_embeds_matches_jax(pair):
    jt, tt_ = pair.tokens(2)
    pre = np.random.default_rng(2).normal(size=(_B, 5, pair.cfg.d_model)).astype(np.float32)
    want = jm.forward_hidden(pair.cfg, pair.jp, jt, prefix_embeds=jnp.asarray(pre),
                             dtype=jnp.float32, remat=False)
    got = tm.forward_hidden(pair.tcfg, pair.tp, tt_, prefix_embeds=torch.from_numpy(pre),
                            dtype=torch.float32, remat=False)
    assert got.shape == (_B, _L + 5, pair.cfg.d_model)
    assert _rel_err(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("l", [20, 70])
def test_loss_matches_jax(pair, l):
    """L = 70 runs the SSD over two chunks, the second padded."""
    jt, tt_ = pair.tokens(1, l=l)
    want = pair.jm.loss_fn(pair.jp, {"tokens": jt}, dtype=jnp.float32, remat=False, loss_chunk=7)
    got = pair.tm.loss_fn(pair.tp, {"tokens": tt_}, dtype=torch.float32, loss_chunk=7)
    assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))


def test_bf16_loss_is_close_to_jax(pair):
    """bf16 runs the projections in bf16 in both packages, with other
    summation orders in their matmuls: the loss agrees to a few bf16 ulps."""
    jt, tt_ = pair.tokens(8)
    want = pair.jm.loss_fn(pair.jp, {"tokens": jt}, dtype=jnp.bfloat16, remat=False)
    got = pair.tm.loss_fn(pair.tp, {"tokens": tt_}, dtype=torch.bfloat16)
    assert np.isfinite(float(got))
    assert abs(float(got) - float(want)) <= 2e-2 * abs(float(want))


def test_decode_step_matches_jax(pair):
    """Eight decode steps from an empty state in each package: logits each
    step and every leaf of the state after."""
    jt, tt_ = pair.tokens(3, l=8)
    jc = pair.jm.init_cache(_B, 16, dtype=jnp.float32)
    tc = pair.tm.init_cache(_B, 16, dtype=torch.float32)
    for pos in range(8):
        want, jc = pair.jm.decode_step(pair.jp, jc, jt[:, pos:pos + 1], jnp.int32(pos),
                                       dtype=jnp.float32)
        got, tc2 = pair.tm.decode_step(pair.tp, tc, tt_[:, pos:pos + 1], pos,
                                       dtype=torch.float32)
        assert tc2 is tc  # updated in place
        assert _rel_err(got.numpy(), want) <= 1e-4, pos
    assert sorted(tc) == sorted(jc) == ["conv", "k", "ssm", "v"]
    for key in tc:
        assert _rel_err(tc[key].numpy(), jc[key]) <= 1e-4, key


def test_decode_matches_forward(pair):
    """Token-by-token decode over 8 tokens equals the parallel forward's
    per-position logits."""
    _, toks = pair.tokens(5, l=8)
    h = pair.tm.forward_hidden(pair.tp, {"tokens": toks}, dtype=torch.float32)
    want = (h @ tt.logits_table(pair.tcfg, pair.tp).T).numpy()
    cache = pair.tm.init_cache(_B, 8, dtype=torch.float32)
    got = []
    for t in range(8):
        logits, cache = pair.tm.decode_step(pair.tp, cache, toks[:, t:t + 1], t,
                                            dtype=torch.float32)
        got.append(logits.numpy())
    assert _rel_err(np.stack(got, axis=1), want) <= 1e-4


def test_greedy_generate_matches_jax(pair):
    prompts = np.random.default_rng(6).integers(0, pair.cfg.vocab, (2, 6)).astype(np.int32)
    want = jax_greedy(pair.jm, pair.jp, prompts, max_new=5, dtype=jnp.float32)
    got = greedy_generate(pair.tm, pair.tp, prompts, max_new=5, dtype=torch.float32)
    np.testing.assert_array_equal(got, want)


def test_init_state_shapes_match_jax(pair):
    want = pair.jm.init_cache(3, 11, dtype=jnp.bfloat16)
    got = pair.tm.init_cache(3, 11, dtype=torch.bfloat16)
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key
        assert not bool(got[key].any())


# ----------------------------------------------------------------- gradients
def _jax_flat(tree) -> dict:
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        flat[key] = np.asarray(leaf)
    return flat


def _port_flat_stacked(tree) -> dict:
    """The port's tree by the JAX package's keys, blocks stacked."""
    out: dict = {}
    for key, arr in _flatten_with_paths(tree).items():
        parts = key.split("/")
        if parts[0] == "blocks":
            out.setdefault("/".join(["blocks"] + parts[2:]), []).append((int(parts[1]), arr))
        else:
            out[key] = arr
    return {k: np.stack([a for _, a in sorted(v)]) if isinstance(v, list) else v
            for k, v in out.items()}


def test_loss_gradients_with_remat_match_jax(pair):
    """``loss_fn`` with remat and every parameter's gradient against
    ``jax.value_and_grad`` of the JAX package's ``loss_fn`` with remat, on a
    sequence of two SSD chunks (the second padded)."""
    jt, tt_ = pair.tokens(4, l=70)
    loss, grads = jax.value_and_grad(lambda p: pair.jm.loss_fn(
        p, {"tokens": jt}, dtype=jnp.float32, remat=True, loss_chunk=16))(pair.jp)
    params = topt.map_tree(lambda p: p.detach().clone().requires_grad_(True), pair.tp)
    got = pair.tm.loss_fn(params, {"tokens": tt_}, dtype=torch.float32, remat=True,
                          loss_chunk=16)
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= 1e-4 * abs(float(loss))
    want = _jax_flat(grads)
    have = _port_flat_stacked(topt.map_tree(lambda p: p.grad, params))
    assert sorted(have) == sorted(want)
    for key in want:
        assert np.abs(want[key]).max() > 0, key
        if key.startswith("blocks/"):  # each layer against its own largest entry
            for i in range(want[key].shape[0]):
                assert _rel_err(have[key][i], want[key][i]) <= 1e-3, (key, i)
        else:
            assert _rel_err(have[key], want[key]) <= 1e-3, key


def test_remat_gives_the_same_gradients(pair):
    _, toks = pair.tokens(6)
    runs = []
    for remat in (True, False):
        params = topt.map_tree(lambda p: p.detach().clone().requires_grad_(True), pair.tp)
        pair.tm.loss_fn(params, {"tokens": toks}, dtype=torch.float32, remat=remat).backward()
        runs.append([p.grad.clone() for p in topt.leaves(params)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------- init
def test_init_params_shapes_match_jax(pair):
    want = _jax_flat(jax.tree.map(np.zeros_like, pair.jm.init_params(jax.random.PRNGKey(0))))
    got = _port_flat_stacked(pair.tm.init_params(0))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key


def test_init_params_in_bf16_keeps_the_decay_parameters_in_fp32():
    cfg = tconfigs.get_config(_NAME).reduced()
    f32 = tm.init_params(cfg, 4, "cpu", torch.float32)
    bf16 = tm.init_params(cfg, 4, "cpu", torch.bfloat16)
    for (key, a), b in zip(_flatten_with_paths(f32).items(), topt.leaves(bf16)):
        fp32_kept = key.split("/")[-1] in ("A_log", "D", "dt_bias")
        assert b.dtype == (torch.float32 if fp32_kept else torch.bfloat16), key
        assert torch.equal(torch.from_numpy(a).to(b.dtype), b), key
    assert "lm_head" not in f32  # the embedding is tied


def test_train_step_matches_jax(pair):
    """Two AdamW steps of ``make_train_step`` against the JAX package's
    jitted step: losses and gradient norms to 2e-5, the params by the norm
    of their difference against the update's (1e-3), as
    ``tests/test_torch_moe.py`` holds the MoE step; weight decay 0, as
    there (the JAX package decays its stacked [L, d] vectors)."""
    from repro import train as jtrain
    from repro_torch import train as ttrain

    jt, tt_ = pair.tokens(7, l=40)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.0)
    jstep = jax.jit(jtrain.make_train_step(pair.jm, jtrain.OptConfig(**opt),
                                           {"dtype": jnp.float32, "loss_chunk": 16}))
    tstep = ttrain.make_train_step(pair.tm, ttrain.OptConfig(**opt),
                                   {"dtype": torch.float32, "loss_chunk": 16})
    jp, js = pair.jp, jtrain.init_opt_state(pair.jp)
    tp = topt.map_tree(lambda p: p.detach().clone().requires_grad_(True), pair.tp)
    ts = topt.init_opt_state(tp)
    for _ in range(2):
        jp, js, jmet = jstep(jp, js, {"tokens": jt})
        tp, ts, tmet = tstep(tp, ts, {"tokens": tt_})
        for key in ("loss", "grad_norm"):
            assert abs(float(tmet[key]) - float(jmet[key])) <= 2e-5 * abs(float(jmet[key])), key
    want, start = _jax_flat(jp), _jax_flat(pair.jp)
    have = _port_flat_stacked(topt.map_tree(lambda p: p.detach(), tp))
    assert sorted(have) == sorted(want)
    moved = np.sqrt(sum(((want[k] - start[k]).astype(np.float64) ** 2).sum() for k in want))
    diff = np.sqrt(sum(((have[k] - want[k]).astype(np.float64) ** 2).sum() for k in want))
    assert diff <= 1e-3 * moved, (diff, moved)
