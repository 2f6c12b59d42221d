"""The port's MoE family (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the CPU in fp32, on the reduced configs
of qwen2-moe-a2.7b (a shared expert, q/k/v bias) and qwen3-moe-30b-a3b (no
shared expert, qk-norm, GQA); weights carried by ``params_from_jax``,
inputs drawn with numpy from a seed.

The integer half of the dispatch is held bit for bit: the replica plan,
the top-k order on ties, destinations, bins, valid, loads and drops (the
JAX side is its own functions called as ``moe_ffn`` calls them).  Floats:
``moe_ffn``, ``forward_hidden``, ``loss_fn`` and ``decode_step`` to rtol =
atol = 2e-4 (fp32 sums in another order; measured about 5e-6), gradients
to 2e-4 relative with an absolute floor of 1e-5, decode against the
forward to 2e-3 (``tests/test_train_serve.py``'s bound)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.mapreduce.hashing import mix32_jnp
from repro.mapreduce.local_join import group_by_reducer as jax_group_by_reducer
from repro.models import build_model as jax_build
from repro.models import moe as jm
from repro.serve import greedy_generate as jax_greedy
from repro_torch import configs as tconfigs
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import moe as tm
from repro_torch.models import transformer as tt
from repro_torch.serve import greedy_generate
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import _flatten_with_paths

_NAMES = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]
_TOL = dict(rtol=2e-4, atol=2e-4)
_GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
_B, _L = 2, 12


class _Pair:
    """One reduced MoE config in both packages, on the same weights."""

    def __init__(self, name: str):
        self.cfg = jconfigs.get_config(name).reduced()
        self.tcfg = tconfigs.get_config(name).reduced()
        self.jm = jax_build(self.cfg)
        self.jp = self.jm.init_params(jax.random.PRNGKey(3))
        self.tm = build_model(self.tcfg, device="cpu")
        self.tp = params_from_jax(self.tcfg, jax.tree.map(np.asarray, self.jp), device="cpu")

    def tokens(self, seed: int, b: int = _B, l: int = _L):
        toks = np.random.default_rng(seed).integers(0, self.cfg.vocab, (b, l)).astype(np.int32)
        return jnp.asarray(toks), torch.from_numpy(toks)


@pytest.fixture(scope="module", params=_NAMES)
def pair(request):
    return _Pair(request.param)


def _block(tree) -> dict:
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, dtype=np.float32)), tree)


# ------------------------------------------------------------ the replica plan
_PLANS = {  # name: (counts, capacity, extra_slots)
    "ties_and_zero_grants": ([5, 17, 17, 0, 9, 17, 3, 0], 8, 4),
    "budget_exceeded": ([40, 33, 25, 25, 1, 0, 7, 12], 8, 5),
    "padded_with_last_expert": ([0, 20, 0, 12, 0], 8, 6),
    "all_zero_grants": ([1, 2, 3, 4, 5], 8, 3),
    "no_replica_slots": ([40, 33, 25, 25, 1, 0, 7, 12], 8, 0),
    "one_hot_expert": ([0, 0, 0, 200, 0, 0, 0, 0], 16, 8),
    "every_expert_over": ([30] * 8, 10, 8),
}


@pytest.mark.parametrize("case", sorted(_PLANS))
def test_plan_replica_slots_matches_jax(case):
    counts, capacity, extra = _PLANS[case]
    e = len(counts)
    want = jm.plan_replica_slots(jnp.asarray(counts, jnp.int32), capacity, e, extra)
    got = tm.plan_replica_slots(torch.tensor(counts, dtype=torch.int32), capacity, e, extra)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("e,extra", [(16, 4), (60, 8), (60, 16), (128, 16)])
def test_plan_replica_slots_seeded_counts_match_jax(e, extra):
    """Zipf counts with a third of the experts at zero, at capacities from
    1 to 39."""
    rng = np.random.default_rng(e + extra)
    plan = jax.jit(jm.plan_replica_slots, static_argnums=(2, 3))
    for _ in range(6):
        counts = rng.zipf(1.4, e).clip(max=500).astype(np.int32)
        counts[rng.random(e) < 0.3] = 0
        capacity = int(rng.integers(1, 40))
        want = plan(jnp.asarray(counts), capacity, e, extra)
        got = tm.plan_replica_slots(torch.from_numpy(counts), capacity, e, extra)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------- top-k order on ties
@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_top_k_order_on_ties_matches_jax(k, dtype):
    """One-hot tokens read the router's rows as their logits exactly, so
    rows drawn from four values tie everywhere; the row [1, 3, 3, 2, 3]
    gives JAX's [1, 2, 4] at k = 3."""
    rng = np.random.default_rng(k)
    e, d = 8, 24
    router = rng.choice([0.0, 0.5, 1.0, 1.5], size=(d, e)).astype(np.float32)
    router[0, :5] = [1, 3, 3, 2, 3]
    router[0, 5:] = -1
    x = np.eye(d, dtype=np.float32)[None]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    logits = (jnp.asarray(x, jdt) @ jnp.asarray(router).astype(jdt)).astype(jnp.float32)
    want_w, want_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    _, got_w, got_i = tm.route({"router": torch.from_numpy(router)},
                               torch.from_numpy(x).to(tdt), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    want_w = want_w / want_w.sum(-1, keepdims=True)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6)
    if k == 3:
        assert got_i[0, 0].tolist() == [1, 2, 4]


# ------------------------------------------------------- the integer dispatch
def _topi(kind: str, g: int, tg: int, k: int, e: int) -> np.ndarray:
    """Each token's k distinct experts, drawn from a seed: uniform, Zipf
    skewed, or every token's first choice on expert 3."""
    rng = np.random.default_rng(["uniform", "skewed", "one_hot"].index(kind) + g + tg + k + e)
    if kind == "skewed":
        p = 1.0 / np.arange(1, e + 1) ** 1.2
        return np.stack([rng.choice(e, k, replace=False, p=p / p.sum())
                         for _ in range(g * tg)]).reshape(g, tg, k).astype(np.int32)
    out = np.argsort(rng.random((g, tg, e)), -1)[..., :k].astype(np.int32)
    if kind == "one_hot":
        first = out == 3
        out[first] = out[..., :1].repeat(k, -1)[first]  # keep the choices distinct
        out[..., 0] = 3
    return out


def _jax_dispatch(topi: np.ndarray, e: int, cap: int, extra: int) -> dict:
    """The integer half of ``repro.models.moe.moe_ffn`` (its lines 149-181
    and the ``vmap`` of ``group_by_reducer`` in ``dispatch_compute_combine``),
    with the replica slots' bins after the primaries'."""
    out = _jax_dispatch_jit(jnp.asarray(topi), e, cap, extra)
    return {key: None if v is None else np.asarray(v) for key, v in out.items()}


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_dispatch_jit(topi, e: int, cap: int, extra: int) -> dict:
    g, tg, k = topi.shape
    flat_e = topi.reshape(g, tg * k).astype(jnp.int32)
    flat_t = jnp.broadcast_to(jnp.repeat(jnp.arange(tg, dtype=jnp.int32), k)[None], (g, tg * k))
    flat_c = jnp.broadcast_to(jnp.arange(tg * k, dtype=jnp.int32)[None], (g, tg * k))
    out = {"slot_expert": None, "replica_count": None, "extra_base": None, "dest_x": None}
    dest_p = flat_e
    if extra > 0:
        counts = jnp.zeros(e, jnp.int32).at[topi.reshape(-1)].add(1)
        slot_expert, replica_count, extra_base = jm.plan_replica_slots(counts, cap * g, e, extra)
        gid = jnp.arange(g, dtype=jnp.int32)[:, None] * (tg * k) + flat_c
        r = (mix32_jnp(gid, 0xD15C) % replica_count[flat_e].astype(jnp.uint32)).astype(jnp.int32)
        dest_p = jnp.where(r == 0, flat_e, jnp.int32(-1))
        out.update(slot_expert=slot_expert, replica_count=replica_count, extra_base=extra_base,
                   dest_x=jnp.where(r > 0, extra_base[flat_e] - e + r - 1, jnp.int32(-1)))
    rows = jnp.stack([flat_t, flat_c], axis=-1)
    parts = [jax.vmap(lambda dd, rr, n=n: jax_group_by_reducer(dd, rr, n, cap))(dest, rows)
             for dest, n in [(dest_p, e), (out["dest_x"], extra)] if dest is not None]
    out["dest_p"] = dest_p
    for i, key in enumerate(("bins", "valid", "loads")):
        out[key] = jnp.concatenate([p[i] for p in parts], axis=1)
    return out


def _port_dispatch(topi: np.ndarray, e: int, cap: int, extra: int) -> dict:
    """The port's dispatch in the JAX layout: destinations from
    ``assign_slots``, the plan from ``plan_replica_slots`` as
    ``assign_slots`` calls it, bins and valid from each buffer row's
    choice."""
    g, tg, k = topi.shape
    n = tg * k
    flat_e = torch.from_numpy(topi).reshape(g, n).long()
    disp = tm.dispatch(torch.from_numpy(topi), e, cap, extra)
    slot, slot_expert = tm.assign_slots(flat_e, e, cap, extra)
    out = {"slot_expert": slot_expert, "replica_count": None, "extra_base": None,
           "dest_p": torch.where(slot < e, slot, -1).int(), "dest_x": None}
    if extra:
        counts = torch.bincount(flat_e.reshape(-1), minlength=e)
        _, out["replica_count"], out["extra_base"] = tm.plan_replica_slots(counts, cap * g, e,
                                                                           extra)
        out["dest_x"] = torch.where(slot >= e, slot - e, -1).int()
    choice = disp.choice.view(e + extra, g, cap)
    valid = choice >= 0
    c = torch.where(valid, choice - torch.arange(g)[None, :, None] * n, 0)
    out.update(bins=torch.stack([c // k, c], -1).permute(1, 0, 2, 3),
               valid=valid.permute(1, 0, 2), loads=disp.loads.T)
    return {key: None if v is None else v.numpy() for key, v in out.items()}, disp


@pytest.mark.parametrize("kind", ["uniform", "skewed", "one_hot"])
@pytest.mark.parametrize("extra", [0, 3, 8])
@pytest.mark.parametrize("cf", [1.25, 1.0, 0.5])
def test_dispatch_matches_jax(kind, extra, cf):
    """Given the same ``topi``, every integer of the dispatch equals the
    JAX package's; the inverse map ``pos`` sends each kept choice to the
    buffer row that holds it."""
    g, tg, k, e = 3, 40, 2, 8
    topi = _topi(kind, g, tg, k, e)
    cap = max(8, int(np.ceil(tg * k * cf / (e + extra))))
    want = _jax_dispatch(topi, e, cap, extra)
    got, disp = _port_dispatch(topi, e, cap, extra)
    for key, w in want.items():
        if w is None:
            assert got[key] is None, key
            continue
        np.testing.assert_array_equal(got[key], w.astype(got[key].dtype), err_msg=key)
    valid = disp.choice >= 0
    assert int((disp.pos >= 0).sum()) == int(valid.sum())
    rows = disp.pos[disp.pos >= 0]
    assert bool(valid[rows].all())
    choice = torch.nonzero(disp.pos >= 0)[:, 0]
    group = choice // (tg * k)
    assert torch.equal(disp.choice[rows], choice)
    if kind == "one_hot" and cf < 1.25:
        assert int(valid.sum()) < g * tg * k  # the hot expert drops
    # the buffer rows the inverse map names are the bins' own rows
    assert torch.equal(disp.src[rows], group * tg + (choice - group * tg * k) // k)


def test_dispatch_gathers_have_the_gradients_of_gathers():
    """The dispatch gather and the combine's gather differentiate through
    the inverse maps (no scatter): ``gradcheck`` in fp64 on a dispatch with
    drops and replica slots."""
    g, tg, k, e = 2, 12, 2, 8
    disp = tm.dispatch(torch.from_numpy(_topi("skewed", g, tg, k, e)), e, 2, 3)
    assert int((disp.pos < 0).sum()) > 0  # some choices drop
    x = torch.randn(g, tg, 5, dtype=torch.float64, requires_grad=True)
    torch.autograd.gradcheck(lambda x: tm._gather(x, disp, e + 3), (x,))
    y = torch.randn(e + 3, g * 2, 5, dtype=torch.float64, requires_grad=True)
    w = torch.rand(g, tg, k, dtype=torch.float64, requires_grad=True)
    torch.autograd.gradcheck(lambda y, w: tm._combine(y, disp, w), (y, w))


@pytest.mark.parametrize("sx", [[0, 3, 3, 7, 7, 7], [1, 2, 5]])
def test_slot_weights_sum_each_experts_replicas(sx):
    """The replica slots' weight gather: ``gradcheck`` in fp64, and each
    expert's gradient the sum of its slots' rows (an expert with several
    replicas, and E - 1 serving the slots past the grants)."""
    sx = torch.tensor(sx)
    w = torch.randn(8, 3, 4, dtype=torch.float64, requires_grad=True)
    torch.autograd.gradcheck(lambda w: tm._SlotWeights.apply(w, sx), (w,))
    grad = torch.randn(len(sx), 3, 4, dtype=torch.float64)
    tm._SlotWeights.apply(w, sx).backward(grad)
    want = torch.zeros_like(w)
    for j, e in enumerate(sx.tolist()):
        want[e] += grad[j]
    assert torch.equal(w.grad, want)


# ----------------------------------------------------------------- the layer
@pytest.mark.parametrize("extra,cf", [(0, 1.25), (0, 0.5), (4, 1.0), (8, 0.5)])
def test_moe_ffn_matches_jax(pair, extra, cf):
    """One layer on [3, 40, d]: the output, the aux loss and the stats
    (drops and slot loads exactly)."""
    x = np.random.default_rng(1).normal(size=(3, 40, pair.cfg.d_model)).astype(np.float32)
    blk = jax.tree.map(lambda a: a[0], pair.jp["blocks"])
    ffn = jax.jit(jm.moe_ffn, static_argnums=(2, 3, 4, 5, 6))
    want, want_aux, want_st = ffn(blk, jnp.asarray(x), pair.cfg, cf, extra, 0, True)
    got, got_aux, got_st = tm.moe_ffn(pair.tp["blocks"][0], torch.from_numpy(x), pair.tcfg,
                                      cf, extra, return_stats=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **_TOL)
    np.testing.assert_allclose(float(got_st["aux_loss"]), float(want_st["aux_loss"]), **_TOL)
    assert int(got_st["dropped"]) == int(want_st["dropped"])
    np.testing.assert_allclose(float(got_st["drop_rate"]), float(want_st["drop_rate"]),
                               rtol=1e-7)
    np.testing.assert_array_equal(got_st["slot_loads"].numpy(), np.asarray(want_st["slot_loads"]))
    assert got_st["slot_loads"].shape[0] == pair.cfg.n_experts + extra


@pytest.mark.parametrize("extra", [0, 4])
def test_forward_hidden_matches_jax(pair, extra):
    jt, tt_ = pair.tokens(0)
    want, want_aux = pair.jm.forward_hidden(pair.jp, {"tokens": jt}, dtype=jnp.float32,
                                            remat=False, extra_slots=extra, capacity_factor=1.0)
    got, got_aux = pair.tm.forward_hidden(pair.tp, {"tokens": tt_}, dtype=torch.float32,
                                          extra_slots=extra, capacity_factor=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **_TOL)


@pytest.mark.parametrize("extra", [0, 4])
def test_loss_matches_jax(pair, extra):
    jt, tt_ = pair.tokens(1)
    kw = dict(loss_chunk=5, extra_slots=extra, capacity_factor=1.0, aux_coef=0.5)
    want = pair.jm.loss_fn(pair.jp, {"tokens": jt}, dtype=jnp.float32, remat=False, **kw)
    got = pair.tm.loss_fn(pair.tp, {"tokens": tt_}, dtype=torch.float32, **kw)
    np.testing.assert_allclose(float(got), float(want), **_TOL)


def test_decode_step_matches_jax(pair):
    """Five decode steps from an empty cache in each package: logits each
    step and the caches after."""
    jt, tt_ = pair.tokens(3, l=5)
    jc = pair.jm.init_cache(_B, 16, dtype=jnp.float32)
    tc = pair.tm.init_cache(_B, 16, dtype=torch.float32)
    for pos in range(5):
        want, jc = pair.jm.decode_step(pair.jp, jc, jt[:, pos:pos + 1], jnp.int32(pos),
                                       dtype=jnp.float32)
        got, tc2 = pair.tm.decode_step(pair.tp, tc, tt_[:, pos:pos + 1], pos,
                                       dtype=torch.float32)
        assert tc2 is tc  # updated in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **_TOL)


def test_decode_matches_forward(pair):
    """Token-by-token decode over a sequence equals the parallel forward's
    per-position logits at a capacity factor where nothing drops (the twin
    of ``tests/test_train_serve.py``'s MoE case)."""
    _, toks = pair.tokens(5)
    h, _ = pair.tm.forward_hidden(pair.tp, {"tokens": toks}, dtype=torch.float32,
                                  capacity_factor=8.0)
    want = (h @ tt.logits_table(pair.tcfg, pair.tp).T).numpy()
    cache = pair.tm.init_cache(_B, 32, dtype=torch.float32)
    got = []
    for t in range(_L):
        logits, cache = pair.tm.decode_step(pair.tp, cache, toks[:, t:t + 1], t,
                                            dtype=torch.float32, capacity_factor=8.0)
        got.append(logits.numpy())
    np.testing.assert_allclose(np.stack(got, axis=1), want, rtol=2e-3, atol=2e-3)


def test_greedy_generate_matches_jax():
    pair = _Pair("qwen2-moe-a2.7b")
    prompts = np.random.default_rng(5).integers(0, pair.cfg.vocab, (2, 8)).astype(np.int32)
    want = jax_greedy(pair.jm, pair.jp, prompts, max_new=5, dtype=jnp.float32)
    got = greedy_generate(pair.tm, pair.tp, prompts, max_new=5, dtype=torch.float32)
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------- gradients
def _jax_flat(tree) -> dict:
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        flat[key] = np.asarray(leaf)
    return flat


def _port_flat_stacked(tree) -> dict:
    """The port's gradients by the JAX package's keys, blocks stacked."""
    flat = _flatten_with_paths(tree)
    out: dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "blocks":
            out.setdefault("/".join(["blocks"] + parts[2:]), []).append((int(parts[1]), arr))
        else:
            out[key] = arr
    return {k: np.stack([a for _, a in sorted(v)]) if isinstance(v, list) else v
            for k, v in out.items()}


@pytest.mark.parametrize("extra", [0, 4])
def test_loss_gradients_with_remat_match_jax(pair, extra):
    """``loss_fn`` with remat and every parameter's gradient against
    ``jax.value_and_grad`` of the JAX package's ``loss_fn`` (remat on both
    sides; a capacity factor of 1.0, so some choices drop)."""
    jt, tt_ = pair.tokens(4)
    kw = dict(loss_chunk=5, extra_slots=extra, capacity_factor=1.0)
    loss, grads = jax.value_and_grad(
        lambda p: pair.jm.loss_fn(p, {"tokens": jt}, dtype=jnp.float32, remat=True, **kw))(pair.jp)
    params = topt.map_tree(lambda p: p.detach().clone().requires_grad_(True), pair.tp)
    got = pair.tm.loss_fn(params, {"tokens": tt_}, dtype=torch.float32, remat=True, **kw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=2e-5)
    want = _jax_flat(grads)
    have = _port_flat_stacked(topt.map_tree(
        lambda p: p.grad if p.grad is not None else torch.zeros_like(p), params))
    assert sorted(have) == sorted(want)
    for key in want:
        np.testing.assert_allclose(have[key], want[key], err_msg=key, **_GRAD_TOL)
    for leaf in ("router", "experts/w_gate", "experts/w_down", "attn/wq"):
        assert np.abs(have[f"blocks/{leaf}"]).max() > 0, leaf


def test_remat_gives_the_same_gradients():
    """``remat`` recomputes each block, the dispatch included, in the
    backward: the same gradients as without it, bit for bit."""
    pair = _Pair("qwen2-moe-a2.7b")
    _, toks = pair.tokens(6)
    runs = []
    for remat in (True, False):
        params = topt.map_tree(lambda p: p.detach().clone().requires_grad_(True), pair.tp)
        pair.tm.loss_fn(params, {"tokens": toks}, dtype=torch.float32, remat=remat,
                        extra_slots=4, capacity_factor=1.0).backward()
        runs.append([p.grad.clone() for p in topt.leaves(params)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_train_step_matches_jax():
    """Two AdamW steps of ``make_train_step`` with MoE's knobs in
    ``loss_kwargs`` against the JAX package's: losses and gradient norms to
    2e-5, the params by the norm of their difference against the update's
    (1e-3; AdamW divides each gradient by its RMS, so an entry whose
    gradient is near zero moves by up to lr on one side only, as
    ``tests/test_torch_gpu.py`` holds the dense step).  Weight decay is 0:
    the JAX package decays its stacked [L, d] norm scales and biases, which
    are 2-D there, and the port decays matrices only (ROADMAP "Facts")."""
    from repro import train as jtrain
    from repro_torch import train as ttrain

    pair = _Pair("qwen3-moe-30b-a3b")
    jt, tt_ = pair.tokens(7)
    kw = {"extra_slots": 4, "capacity_factor": 1.25, "loss_chunk": 6}
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.0)
    jstep = jax.jit(jtrain.make_train_step(pair.jm, jtrain.OptConfig(**opt),
                                           {"dtype": jnp.float32, **kw}))
    tstep = ttrain.make_train_step(pair.tm, ttrain.OptConfig(**opt), {"dtype": torch.float32, **kw})
    jp, js = pair.jp, jtrain.init_opt_state(pair.jp)
    tp = topt.map_tree(lambda p: p.detach().clone().requires_grad_(True), pair.tp)
    ts = topt.init_opt_state(tp)
    for _ in range(2):
        jp, js, jmet = jstep(jp, js, {"tokens": jt})
        tp, ts, tmet = tstep(tp, ts, {"tokens": tt_})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=2e-5)
    want, start = _jax_flat(jp), _jax_flat(pair.jp)
    have = _port_flat_stacked(topt.map_tree(lambda p: p.detach(), tp))
    assert sorted(have) == sorted(want)
    moved = np.sqrt(sum(((want[k] - start[k]).astype(np.float64) ** 2).sum() for k in want))
    diff = np.sqrt(sum(((have[k] - want[k]).astype(np.float64) ** 2).sum() for k in want))
    assert diff <= 1e-3 * moved, (diff, moved)


# -------------------------------------------------------- bench_moe_skew's cell
def test_bench_moe_skew_cell_matches_jax():
    """``benchmarks/bench_moe_skew.py:22-40``: 16 experts, top-2, d = 64, the
    router biased toward experts 0 (+0.35) and 3 (+0.25), x [8, 256, 64]
    from ``default_rng(0)``; drops and slot loads equal the JAX package's
    at extra_slots 0 and 8, cf 1.25 and 1.0, and replica slots drop no
    more than the capacity router."""
    cfg = dataclasses.replace(jconfigs.get_config("qwen2-moe-a2.7b").reduced(),
                              n_experts=16, top_k=2, d_model=64)
    tcfg = dataclasses.replace(tconfigs.get_config("qwen2-moe-a2.7b").reduced(),
                               n_experts=16, top_k=2, d_model=64)
    blk = jm.init_moe_block(jax.random.PRNGKey(0), cfg)
    bias = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    bias[:, 0] = 0.35
    bias[:, 3] = 0.25
    blk["router"] = blk["router"] + jnp.asarray(bias)
    x = np.random.default_rng(0).normal(size=(8, 256, cfg.d_model))
    xj, xt = jnp.asarray(x, jnp.float32), torch.from_numpy(x.astype(np.float32))
    ffn = jax.jit(lambda b, x, cf, extra: jm.moe_ffn(b, x, cfg, capacity_factor=cf,
                                                     extra_slots=extra, return_stats=True),
                  static_argnums=(2, 3))
    drops = {}
    for cf in (1.25, 1.0):
        for extra in (0, 8):
            _, _, want = ffn(blk, xj, cf, extra)
            _, _, got = tm.moe_ffn(_block(blk), xt, tcfg, capacity_factor=cf,
                                   extra_slots=extra, return_stats=True)
            assert int(got["dropped"]) == int(want["dropped"]), (cf, extra)
            np.testing.assert_array_equal(got["slot_loads"].numpy(),
                                          np.asarray(want["slot_loads"]))
            drops[cf, extra] = int(got["dropped"])
    assert drops[1.25, 8] <= drops[1.25, 0] and drops[1.0, 8] <= drops[1.0, 0]
    assert drops[1.0, 0] > 0  # the skewed router does overflow its hot experts


# ---------------------------------------------------------------------- init
@pytest.mark.parametrize("name", _NAMES)
def test_init_params_shapes_match_jax(name):
    cfg = jconfigs.get_config(name).reduced()
    want = _jax_flat(jax.tree.map(np.zeros_like, jax_build(cfg).init_params(
        jax.random.PRNGKey(0))))
    got = _port_flat_stacked(build_model(tconfigs.get_config(name).reduced(),
                                         device="cpu").init_params(0))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key


def test_init_params_in_bf16_draws_the_fp32_values():
    """A bf16 model is the fp32 one rounded, tensor by tensor."""
    cfg = tconfigs.get_config("qwen2-moe-a2.7b").reduced()
    f32 = tm.init_params(cfg, 4, "cpu", torch.float32)
    bf16 = tm.init_params(cfg, 4, "cpu", torch.bfloat16)
    for a, b in zip(topt.leaves(f32), topt.leaves(bf16)):
        assert b.dtype == torch.bfloat16 and torch.equal(a.to(torch.bfloat16), b)
    experts = f32["blocks"][0]["experts"]
    assert tuple(experts["w_gate"].shape) == (cfg.n_experts, cfg.d_model, cfg.d_expert)
    assert tuple(experts["w_down"].shape) == (cfg.n_experts, cfg.d_expert, cfg.d_model)
