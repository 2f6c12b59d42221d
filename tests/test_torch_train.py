"""The port's training path against the JAX package's, on the CPU in fp32:
the token pipeline (bit for bit), AdamW, its schedule and the clip, the
loss and every gradient of five reduced dense-family configs (weights
carried by ``params_from_jax``), remat, three train steps, checkpoints
(async, elastic, across the packages both ways).  Tolerances: the loss and
gradients to 2e-4 relative with an absolute floor of 1e-5 (fp32 sums in
another order; measured about 2e-6 of each gradient's largest entry);
optimizer arithmetic to 1e-6 relative (the same fp32 formula, one rounding
apart); three train steps as stated at that test."""
import dataclasses
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import train as jtrain
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.models import build_model as jax_build
from repro.models import layers as jlayers
from repro.models import make_batch as jax_make_batch
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch import train as ttrain
from repro_torch.data import TokenPipeline
from repro_torch.models import build_model, convert, make_batch
from repro_torch.models import layers as tlayers
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import _flatten_with_paths

_NAMES = ["olmo-1b", "gemma3-4b", "internvl2-1b", "hubert-xlarge", "granite-3-8b"]
_GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20, grad_clip=1.0)


def _jax_flat(tree) -> dict:
    """A JAX tree's leaves by path, blocks unstacked into the port's keys."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        flat[key] = np.asarray(leaf)
    return convert.flat_from_jax_layout(flat)


def _grads(params) -> dict:
    return _flatten_with_paths(topt.map_tree(
        lambda p: p.grad if p.grad is not None else torch.zeros_like(p), params))


def _requires_grad(params):
    for p in topt.leaves(params):
        p.requires_grad_(True)
    return params


class _Pair:
    """One reduced config in both packages, on the same weights and batch."""

    def __init__(self, name: str, seed: int = 3):
        self.cfg = jconfigs.get_config(name).reduced()
        self.tcfg = tconfigs.get_config(name).reduced()
        self.jm = jax_build(self.cfg)
        self.jp = self.jm.init_params(jax.random.PRNGKey(seed))
        self.tm = build_model(self.tcfg, device="cpu")
        self.jb = jax_make_batch(self.cfg, np.random.default_rng(seed), 2, 16)
        self.tb = make_batch(self.tcfg, np.random.default_rng(seed), 2, 16, device="cpu")
        if "prefix_embeds" in self.tb:  # fp32 on both sides: the point is the algorithm
            pe = np.asarray(self.jb["prefix_embeds"], np.float32)
            self.jb["prefix_embeds"] = jnp.asarray(pe)
            self.tb["prefix_embeds"] = torch.from_numpy(pe)

    def params(self):
        return _requires_grad(convert.params_from_jax(
            self.tcfg, jax.tree.map(np.asarray, self.jp), device="cpu"))


# ------------------------------------------------------------------ pipeline
def test_pipeline_matches_jax_bit_for_bit():
    """Batches, a resume from ``state_dict``, disjoint shards and the
    prefetch thread: the port's pipeline is the JAX package's, bit for bit."""
    for cls_args in [dict(vocab=100, batch=4, seq=8, seed=7),
                     dict(vocab=50304, batch=4, seq=64, seed=1)]:
        p, j = TokenPipeline(**cls_args), JaxPipeline(**cls_args)
        for _ in range(3):
            a, b = p.next_batch(), j.next_batch()
            assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    p1 = TokenPipeline(vocab=100, batch=4, seq=8, seed=7)
    p1.next_batch(), p1.next_batch()
    state = p1.state_dict()
    c = p1.next_batch()
    p2 = TokenPipeline(vocab=100, batch=4, seq=8, seed=7)
    p2.load_state_dict(state)
    assert np.array_equal(p2.next_batch(), c)
    shards = [TokenPipeline(vocab=100, batch=4, seq=8, seed=7, shard=s, num_shards=2)
              for s in (0, 1)]
    jshards = [JaxPipeline(vocab=100, batch=4, seq=8, seed=7, shard=s, num_shards=2)
               for s in (0, 1)]
    got = [s.next_batch() for s in shards]
    assert not np.array_equal(*got)
    assert all(np.array_equal(g, j.next_batch()) for g, j in zip(got, jshards))
    pre = TokenPipeline(vocab=50, batch=2, seq=4, seed=1, prefetch=3)
    pre.start()
    fetched = [pre.next_prefetched() for _ in range(3)]
    pre.stop()
    assert pre.step == 3
    for i, f in enumerate(fetched):
        assert np.array_equal(f, JaxPipeline(vocab=50, batch=2, seq=4, seed=1).batch_at(i))


# ----------------------------------------------------------------- optimizer
def test_schedule_matches_jax():
    cfg, jcfg = topt.OptConfig(**_OPT), jopt.OptConfig(**_OPT)
    steps = np.arange(0, 25, dtype=np.int32)
    got = topt.schedule(cfg, torch.from_numpy(steps)).numpy()
    want = np.asarray(jopt.schedule(jcfg, jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("clip", [1.0, 1e3], ids=["clipped", "unclipped"])
def test_adamw_update_matches_jax(clip):
    """Three updates of seeded params (matrices, vectors, a scalar) from
    seeded grads: params, m, v, step, grad_norm and lr as the JAX
    package's, with the clip binding or not."""
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,), "blocks": [{"k": (3, 4, 2)}, {"k": (3, 4, 2)}], "s": ()}

    def draw(scale):
        return {"w": rng.normal(size=shapes["w"]) * scale,
                "b": rng.normal(size=shapes["b"]) * scale,
                "blocks": [{"k": rng.normal(size=(3, 4, 2)) * scale} for _ in range(2)],
                "s": np.asarray(rng.normal() * scale)}

    p_np = jax.tree.map(lambda a: np.asarray(a, np.float32), draw(1.0))
    jcfg = jopt.OptConfig(**{**_OPT, "grad_clip": clip})
    cfg = topt.OptConfig(**{**_OPT, "grad_clip": clip})
    jp = jax.tree.map(jnp.asarray, p_np)
    js = jopt.init_opt_state(jp)
    tp = topt.map_tree(lambda a: torch.from_numpy(a.copy()), p_np)
    ts = topt.init_opt_state(tp)
    for _ in range(3):
        g_np = jax.tree.map(lambda a: np.asarray(a, np.float32), draw(0.5))
        jp, js, jm = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, g_np), js, jcfg)
        tp, ts, tm = topt.adamw_update(tp, topt.map_tree(torch.from_numpy, g_np), ts, cfg)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)
        assert int(ts["step"]) == int(js["step"]) and ts["step"].dtype == torch.int32
        for got, want in [(tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])]:
            for g, w in zip(topt.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    norm = float(topt.global_norm(topt.map_tree(torch.from_numpy, g_np)))
    clipped, n = topt.clip_by_global_norm(topt.map_tree(torch.from_numpy, g_np), 1.0)
    jclipped, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g_np), 1.0)
    np.testing.assert_allclose([norm, float(n)], [float(jn)] * 2, rtol=1e-6)
    for g, w in zip(topt.leaves(clipped), jax.tree.leaves(jclipped)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-8)


# ------------------------------------------------------- loss and gradients
@pytest.mark.parametrize("name", _NAMES)
def test_loss_and_gradients_match_jax(name):
    """``loss_fn`` and the gradient of every parameter against
    ``jax.value_and_grad`` of the JAX package's ``loss_fn`` (fp32, remat on
    both sides, chunked cross-entropy over ragged chunks of 5)."""
    pair = _Pair(name)
    loss, grads = jax.value_and_grad(
        lambda p: pair.jm.loss_fn(p, pair.jb, dtype=jnp.float32, loss_chunk=5))(pair.jp)
    params = pair.params()
    got = pair.tm.loss_fn(params, pair.tb, dtype=torch.float32, loss_chunk=5)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=2e-5)
    want, have = _jax_flat(grads), _grads(params)
    assert sorted(have) == sorted(want)
    for key in want:
        np.testing.assert_allclose(have[key], want[key], err_msg=key, **_GRAD_TOL)
    assert any("attn/wq" in k and np.abs(have[k]).max() > 0 for k in have)


@pytest.mark.parametrize("name", ["olmo-1b", "gemma3-4b"])
def test_remat_gives_the_same_gradients(name, monkeypatch):
    """``remat=True`` recomputes each block (and each attention and loss
    chunk) in the backward: the same gradients as ``remat=False``, bit for
    bit.  The attention is forced onto ``_sdpa_chunked`` (chunks of 8 over
    L = 16), whose chunks are checkpointed too; its gradients equal those
    of the unchunked branches."""
    pair = _Pair(name)
    runs = []
    for remat, threshold in [(True, 8), (False, 8), (True, 4096)]:
        monkeypatch.setattr(tlayers, "ATTN_CHUNK_THRESHOLD", threshold)
        monkeypatch.setattr(tlayers, "ATTN_CHUNK", 8)
        params = pair.params()
        pair.tm.loss_fn(params, pair.tb, dtype=torch.float32, remat=remat,
                        loss_chunk=5).backward()
        runs.append(_grads(params))
    chunked_remat, chunked_plain, unchunked = runs
    for key in unchunked:
        assert np.array_equal(chunked_remat[key], chunked_plain[key]), key
        np.testing.assert_allclose(chunked_remat[key], unchunked[key], err_msg=key,
                                   **_GRAD_TOL)


@pytest.mark.parametrize("name", ["olmo-1b", "hubert-xlarge"])
def test_remat_recomputes_every_block(name, monkeypatch):
    """Under ``remat`` every block's forward runs again in the backward,
    the first one too where the input needs no gradient (hubert's frames)
    but the block's parameters do; without it, once."""
    from repro_torch.models import transformer as ttransformer

    cfg = tconfigs.get_config(name).reduced()
    model = build_model(cfg, device="cpu")
    batch = make_batch(cfg, np.random.default_rng(0), 2, 16, device="cpu")
    if "prefix_embeds" in batch:
        batch["prefix_embeds"] = batch["prefix_embeds"].float()
    block_apply, calls = ttransformer._block_apply, []

    def counted(*args):
        calls.append(1)
        return block_apply(*args)

    monkeypatch.setattr(ttransformer, "_block_apply", counted)
    for remat, per_block in [(True, 2), (False, 1)]:
        params, _ = ttrain.init_train_state(model, 0)
        calls.clear()
        model.loss_fn(params, batch, dtype=torch.float32, remat=remat).backward()
        assert len(calls) == per_block * cfg.n_layers, (remat, len(calls))


def _jax_state(pair: _Pair):
    return pair.jp, jopt.init_opt_state(pair.jp)


def _port_state(pair: _Pair):
    state = convert.train_state_from_jax(
        pair.tcfg, jax.tree.map(np.asarray, {"params": pair.jp,
                                             "opt": jopt.init_opt_state(pair.jp)}),
        device="cpu")
    return _requires_grad(state["params"]), state["opt"]


def test_three_train_steps_track_jax():
    """Three ``make_train_step`` steps on one batch against the JAX
    package's jitted step: loss, grad_norm and lr each step to 2e-4
    relative; the params after three steps to 1e-3 of the update's own size
    (AdamW divides each gradient by its running RMS, so an entry whose
    gradient is near zero may move by as much as lr on one side and not the
    other; the norm of the difference bounds how many do)."""
    pair = _Pair("olmo-1b")
    jstep = jax.jit(jtrain.make_train_step(pair.jm, jopt.OptConfig(**_OPT),
                                           {"dtype": jnp.float32}))
    tstep = ttrain.make_train_step(pair.tm, topt.OptConfig(**_OPT), {"dtype": torch.float32})
    jp, js = _jax_state(pair)
    tp, ts = _port_state(pair)
    p0 = {k: v.copy() for k, v in _jax_flat(jp).items()}
    for _ in range(3):
        jp, js, jm = jstep(jp, js, pair.jb)
        tp, ts, tm = tstep(tp, ts, pair.tb)
        assert all(isinstance(tm[k], torch.Tensor) for k in ("loss", "grad_norm", "lr"))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=2e-4, err_msg=key)
        assert all(p.grad is None for p in topt.leaves(tp))
    want, have = _jax_flat(jp), _flatten_with_paths(tp)
    moved = np.sqrt(sum(np.sum((want[k] - p0[k]) ** 2) for k in want))
    diff = np.sqrt(sum(np.sum((have[k] - want[k]) ** 2) for k in want))
    assert diff <= 1e-3 * moved, (diff, moved)


# ---------------------------------------- test_train_serve.py's, on the port
def _port_setup(seed=0):
    cfg = tconfigs.get_config("olmo-1b").reduced()
    model = build_model(cfg, device="cpu")
    params, opt_state = ttrain.init_train_state(model, seed)
    step = ttrain.make_train_step(model, ttrain.OptConfig(**_OPT), {"dtype": torch.float32})
    batch = make_batch(cfg, np.random.default_rng(seed), batch=2, seq=32, device="cpu")
    return cfg, model, params, opt_state, step, batch


def test_loss_decreases_over_steps():
    _, _, params, opt_state, step, batch = _port_setup()
    losses = []
    for _ in range(8):
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    assert all(np.isfinite(losses))


def test_grad_clip_bounds_update():
    _, _, params, opt_state, step, batch = _port_setup()
    _, _, m = step(params, opt_state, batch)
    assert float(m["grad_norm"]) >= 0
    assert float(m["lr"]) <= _OPT["lr"]


def _state(params, opt_state):
    return {"params": params, "opt": opt_state}


def test_checkpoint_roundtrip_and_resume(tmp_path):
    """Save in the JAX layout, restore into a fresh state: one more step from
    each gives the same loss and the same params, bit for bit."""
    cfg, model, params, opt_state, step, batch = _port_setup()
    for _ in range(3):
        params, opt_state, _ = step(params, opt_state, batch)
    d = str(tmp_path / "ckpt")
    ttrain.save_checkpoint(d, 3, convert.train_state_to_jax_layout(_state(params, opt_state)))
    assert ttrain.latest_step(d) == 3
    _, flat = ttrain.load_checkpoint(d)
    fresh_p, fresh_o = ttrain.init_train_state(model, 1)
    restored = ttrain.restore_tree(_state(fresh_p, fresh_o), convert.flat_from_jax_layout(flat))
    _requires_grad(restored["params"])
    assert restored["opt"]["step"].dtype == torch.int32 and int(restored["opt"]["step"]) == 3
    p1, _, m1 = step(params, opt_state, batch)
    p2, _, m2 = step(restored["params"], restored["opt"], batch)
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(topt.leaves(p1), topt.leaves(p2)):
        assert torch.equal(a, b)


def test_checkpoint_keep_and_atomicity(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = {"a": torch.arange(10.0)}
    for s in range(5):
        ttrain.save_checkpoint(d, s, tree, keep=2)
    kept = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]
    assert ttrain.latest_step(d) == 4


def test_async_checkpointer_snapshots_before_its_thread(tmp_path):
    d = str(tmp_path / "ckpt")
    ck = ttrain.AsyncCheckpointer(d, keep=2)
    x = torch.ones(4)
    ck.save(1, {"x": x})
    x.mul_(2)  # updated in place after save: the snapshot was taken first
    ck.save(2, {"x": x})  # waits for save 1
    ck.wait()
    assert ttrain.latest_step(d) == 2
    assert np.array_equal(ttrain.load_checkpoint(d, 1)[1]["x"], np.ones(4))
    assert np.array_equal(ttrain.load_checkpoint(d)[1]["x"], np.full(4, 2.0))


def test_restore_tree_takes_device_and_dtype_and_checks_shapes():
    template = {"w": torch.zeros(2, 3), "n": [torch.zeros((), dtype=torch.int32)], "z": None}
    flat = {"w": np.arange(6, dtype=np.float64).reshape(2, 3), "n/0": np.int64(5)}
    out = ttrain.restore_tree(template, flat, device="cpu")
    assert out["w"].dtype == torch.float32 and out["w"].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert out["n"][0].dtype == torch.int32 and int(out["n"][0]) == 5 and out["z"] is None
    with pytest.raises(KeyError, match="missing n/0"):
        ttrain.restore_tree(template, {"w": flat["w"]})
    with pytest.raises(ValueError, match="shape"):
        ttrain.restore_tree(template, {**flat, "w": np.zeros(3)})


def test_elastic_loop_checkpoints_on_preemption(tmp_path):
    """``run_elastic_loop`` under a ``PreemptionGuard``: a SIGTERM during
    step 3 checkpoints at that step and stops; periodic saves before it."""
    saved, done = [], []

    def step_fn(step):
        done.append(step)
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    with ttrain.PreemptionGuard() as guard:
        last = ttrain.run_elastic_loop(10, step_fn, saved.append, checkpoint_every=2,
                                       guard=guard)
    assert (last, done, saved) == (3, [0, 1, 2, 3], [1, 3])
    assert ttrain.run_elastic_loop(5, done.append, saved.append, checkpoint_every=0) == 4
    plan = ttrain.plan_mesh_shape(250, model_parallel=16, chips_per_pod=256)
    assert plan.pods == 1 and plan.model == 16 and plan.chips_used == plan.data * 16 <= 250


# ------------------------------------------- checkpoints across the packages
def test_jax_training_checkpoint_restores_in_port(tmp_path):
    """The JAX package's trainer saves its state after two steps; the port
    restores it (unstacking the blocks) and equals the JAX state exactly,
    then one more step in each package agrees."""
    pair = _Pair("olmo-1b")
    jstep = jax.jit(jtrain.make_train_step(pair.jm, jopt.OptConfig(**_OPT),
                                           {"dtype": jnp.float32}))
    jp, js = _jax_state(pair)
    for _ in range(2):
        jp, js, _ = jstep(jp, js, pair.jb)
    d = str(tmp_path)
    jtrain.save_checkpoint(d, 2, {"params": jp, "opt": js})
    _, flat = ttrain.load_checkpoint(d)
    tp, to = _port_state(pair)
    restored = ttrain.restore_tree(_state(tp, to), convert.flat_from_jax_layout(flat),
                                   device="cpu")
    got, want = _flatten_with_paths(restored), _jax_flat({"params": jp, "opt": js})
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    tstep = ttrain.make_train_step(pair.tm, topt.OptConfig(**_OPT), {"dtype": torch.float32})
    _, _, tm = tstep(_requires_grad(restored["params"]), restored["opt"], pair.tb)
    _, _, jm = jstep(jp, js, pair.jb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-5)


def test_port_training_checkpoint_restores_in_jax(tmp_path):
    """In a process where JAX cannot import, the port trains reduced OLMo two
    steps and saves through ``AsyncCheckpointer`` in the JAX layout; here
    the JAX package's ``restore_tree`` reads it onto its own template, and
    it equals the same two port steps taken in this process, bit for bit."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "from repro_torch import configs, train\n"
        "from repro_torch.models import build_model, convert, make_batch\n"
        "cfg = configs.get_config('olmo-1b').reduced()\n"
        "model = build_model(cfg, device='cpu')\n"
        "p, o = train.init_train_state(model, 0)\n"
        f"step = train.make_train_step(model, train.OptConfig(**{_OPT!r}),\n"
        "                              {'dtype': torch.float32})\n"
        "batch = make_batch(cfg, np.random.default_rng(0), 2, 32, device='cpu')\n"
        "for _ in range(2):\n"
        "    p, o, m = step(p, o, batch)\n"
        f"ck = train.AsyncCheckpointer({str(tmp_path)!r})\n"
        "ck.save(2, convert.train_state_to_jax_layout({'params': p, 'opt': o}))\n"
        "ck.wait()\n"
        "assert not any(k == 'repro' or k.startswith('repro.') for k in sys.modules)\n"
        "print(repr(float(m['loss'])))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(src)})
    assert out.returncode == 0, out.stderr
    cfg, _, p, o, step, batch = _port_setup()
    for _ in range(2):
        p, o, m = step(p, o, batch)
    assert float(out.stdout.split()[-1]) == float(m["loss"])
    jcfg = jconfigs.get_config("olmo-1b").reduced()
    jm = jax_build(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(9))
    template = {"params": jp, "opt": jopt.init_opt_state(jp)}
    step_no, flat = jtrain.load_checkpoint(str(tmp_path))
    restored = jtrain.restore_tree(template, flat)
    assert step_no == 2 and int(restored["opt"]["step"]) == 2
    got, want = _jax_flat(restored), _flatten_with_paths({"params": p, "opt": o})
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    # the JAX package continues from it
    loss = jm.loss_fn(restored["params"], {"tokens": jnp.asarray(batch["tokens"].numpy())},
                      dtype=jnp.float32)
    assert np.isfinite(float(loss))


def test_train_state_layout_roundtrip():
    """``train_state_to_jax_layout`` stacks the port's blocks as the JAX
    package stacks them; ``train_state_from_jax`` takes them back."""
    pair = _Pair("gemma3-4b")
    tree = jax.tree.map(np.asarray, {"params": pair.jp, "opt": jopt.init_opt_state(pair.jp)})
    state = convert.train_state_from_jax(pair.tcfg, tree, device="cpu")
    assert len(state["params"]["blocks"]) == pair.cfg.n_layers
    back = convert.train_state_to_jax_layout(state)
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert dataclasses.asdict(pair.tcfg)["n_layers"] == pair.cfg.n_layers
