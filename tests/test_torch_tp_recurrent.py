"""Tensor parallelism over "model" for the recurrent families: RWKV-6
(``repro_torch.models.rwkv6`` under ``tensor_parallel.TensorParallel``)
and the Zamba2 hybrid (``models.mamba2``), on the CPU.

Gloo ranks of a (data, model) mesh run the ``RECURRENT`` cases of
``torch_tp_cases`` (reduced rwkv6-3b and zamba2-2.7b, and ``rwkv_mid_head``)
and are held against the whole model on one rank, in fp32, on the (1, 2),
(2, 2) and (1, 4) meshes: hidden states and the decode-step logits after
the prompt 1e-5 of their largest entry, the loss 1e-6 relative, the first
step's gradients 1e-4 of each leaf's largest entry, the two steps' losses
and global norms 1e-5 relative, parameters after two clipped steps 2e-4 of
each leaf's largest entry (1e-3 for ``rwkv_mid_head``, below), initial
parameters and greedy tokens equal.  The split sums partial products,
Mamba2's squares and the vocab blocks' exponents in another order than one
rank: in fp32 the global norm moves by up to 2.4e-6 relative (zamba2's
first step 1.7e-6; the transformers' 1.6e-7), the gradients by up to
2.5e-5 of a leaf's largest entry.

``rwkv_mid_head``'s parameters after the two steps sit on a noise floor of
their own: its one-rank model with the channel mix's v summed in two or
four parts (the same arithmetic in another order) moves them by 4.0e-4 and
5.6e-4 of a leaf's largest entry (``test_mid_head_steps_follow_the_sum_
order``: block 1's ``ln1`` bias, an entry whose clipped gradient is below
Adam's eps, so its update follows its gradient's rounding), so its split
is held to 1e-3 there.  Replicated leaves (the layer norms,
RWKV-6's ``mu_*``, ``w0``, ``u``, ``ln_x``, Mamba2's ``conv_w``, ``A_log``,
``D``, ``dt_bias``, ``norm_scale``; several of them used by a rank only on
its own heads, their gradients summed over the group) are bit-identical
across a model group.

The awkward cases, covered:
  * ``rwkv_mid_head``: 6 heads of 16 at model = 4, where the rules cut the
    time mix's 96 columns a head and a half a rank; every rank runs every
    head on whole leaves (its channel mix still splits d_ff);
  * reduced zamba2's ``in_proj`` (276 columns: z 128, x 128, B 8, C 8, dt 4)
    cut into 138 or 69 columns a rank, across its segments;
  * the decay LoRA: at full size the generic rule splits the stacked
    ``wA`` on its rows and ``wB`` on its columns (each >= 2^22 elements),
    which no reduced config reaches; ``lora_block`` forces those specs on
    one block and holds its output and gradients to the whole block's.

Against the JAX package (``tests/test_torch_tp.py::
test_two_by_two_losses_equal_jax_sharded_step``, parametrised over both
families) and a checkpoint saved on (2, 2) that resumes on (1, 2)
(``test_checkpoint_of_rwkv6_resumes_on_another_mesh`` here).
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import torch_tp_cases as cases
from repro_torch import configs as tconfigs
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import shard_tree
from repro_torch.models import build_model, rwkv6
from repro_torch.models.zoo import tensor_parallel
from repro_torch.train import load_checkpoint
from repro_torch.train.optimizer import leaves, map_tree

_ROOT = Path(__file__).resolve().parents[1]
_MESHES = [(1, 2), (2, 2), (1, 4)]
_ENV = {"PYTHONPATH": f"{_ROOT / 'src'}:{_ROOT / 'tests'}", "PATH": "/usr/bin:/bin:/usr/local/bin",
        "OMP_NUM_THREADS": "1"}


def _fake_mesh(model: int, rank: int = 0, data: int = 1) -> Mesh:
    """One rank's view of a (data, model) mesh, without process groups."""
    return Mesh(("data", "model"), (data, model), (rank // model, rank % model))


# ------------------------------------------------------------ the placement
@pytest.mark.parametrize("model,name,split", [
    (2, "rwkv6", (0, 2)), (4, "rwkv6", (3, 4)), (2, "rwkv_mid_head", (0, 3)),
    (4, "rwkv_mid_head", None), (2, "zamba2", (0, 2)), (4, "zamba2", (0, 1)),
])
def test_heads_split_as_the_rules_place_the_leaves(model, name, split):
    """A rank's heads (RWKV-6's time mix, Mamba2's SSM heads), and the
    leaves the docstrings lean on: RWKV-6's ``tm/Wv`` on its input dim and
    ``cm/Wr`` on its columns, Mamba2's ``in_proj`` across its segments."""
    cfg = cases.RECURRENT[name]()
    rank = model - 1 if name == "rwkv6" and model == 4 else 0
    tp = tensor_parallel(cfg, _fake_mesh(model, rank))
    if cfg.family == "ssm":
        assert tp.block(cfg.n_heads) == split
        d = cfg.d_model
        assert tp.leaf_split["tm/Wv"] == ((d, d), 0) and tp.leaf_split["cm/Wv"] == ((128, d), 0)
        assert tp.leaf_split["tm/Wr"] == ((d, d), 1) and tp.leaf_split["cm/Wr"] == ((d, d), 1)
        assert tp.leaf_split["tm/wA"] == ((d, 64), None)  # below 2^22 stacked: whole
    else:
        assert tp.block(cfg.ssm_heads) == split
        assert tp.leaf_split["in_proj"] == ((64, 276), 1)
        assert tp.leaf_split["conv_w"] == ((4, 128), None)
        assert tp.leaf_split["attn/wq"] == ((64, 64), 1)  # the shared block's


@pytest.mark.parametrize("model", [2, 4, 16])
def test_full_size_decay_lora_splits_on_d(model):
    """At full size the generic rule splits rwkv6-3b's stacked ``wA`` [32,
    2560, 64] on d (its rows) and ``wB`` [32, 64, 2560] on d (its columns),
    the split ``lora_block`` forces; zamba2-2.7b's ``in_proj`` [2560,
    10448] splits on its columns (5,224 a rank at model 2), so a rank
    gathers 53 MB of it in bf16 a layer."""
    with FakeTensorMode():
        tp = tensor_parallel(tconfigs.get_config("rwkv6-3b"), _fake_mesh(model))
        assert tp.leaf_split["tm/wA"] == ((2560, 64), 0)
        assert tp.leaf_split["tm/wB"] == ((64, 2560), 1)
        cfg = tconfigs.get_config("zamba2-2.7b")
        tp = tensor_parallel(cfg, _fake_mesh(model))
    assert tp.leaf_split["in_proj"] == ((2560, 10448), 1)


@pytest.mark.parametrize("model", [2, 4, 16])
@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
def test_leaves_split_as_the_jax_rules_place_them(arch, model):
    """Every leaf of the port's full-size tree takes the JAX rules' spec
    (``repro.launch.sharding.param_specs`` on the JAX package's tree; a
    block leaf the stacked leaf's spec without its layer dim), and the dry
    run's ``split_params_bytes`` at model = 16 is what a rank of the split
    model holds."""
    import jax

    from repro.launch import sharding as jrules
    from repro.models import build_model as jax_build
    from repro_torch.launch import dryrun
    from repro_torch.launch.sharding import param_specs

    cfg = tconfigs.get_config(arch)
    jspec = jrules.param_specs(jax.eval_shape(jax_build(cfg).init_params,
                                              jax.random.PRNGKey(0)), model)
    with FakeTensorMode():
        params = build_model(cfg, "cpu").init_params(0)
    pspec = param_specs(params, model)

    def check(node, spec, jnode, stacked):
        if isinstance(node, dict):
            for key in node:
                check(node[key], spec[key], jnode[key], stacked)
            return
        want = tuple(jnode) + (None,) * (node.dim() + stacked - len(tuple(jnode)))
        assert spec == want[stacked:], (spec, want)

    for key in params:
        if key == "blocks":
            for blk, spec in zip(params["blocks"], pspec["blocks"]):
                check(blk, spec, jspec["blocks"], 1)
        else:
            check(params[key], pspec[key], jspec[key], 0)
    if model == 16:
        rec = dryrun.reckon_cell(arch, "train_4k", False)
        with FakeTensorMode():
            held = build_model(cfg, "cpu", tp=_fake_mesh(16, data=16)).init_params(0)
        assert rec["split_params_bytes"] == sum(p.numel() * p.element_size()
                                                for p in leaves(held))


# ------------------------------------------------------------- gloo ranks
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """mesh -> each rank's results; the three meshes run at once."""
    tmp = tmp_path_factory.mktemp("tp_rec")
    procs, out = {}, {}
    for data, model in _MESHES:
        world = data * model
        stem = tmp / f"out{data}{model}"
        procs[(data, model)] = [
            subprocess.Popen([sys.executable, str(_ROOT / "tests" / "torch_tp_cases.py"),
                              str(r), str(world), str(tmp / f"store{data}{model}"), str(stem),
                              str(data), str(model), "recurrent"],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             cwd=_ROOT, env=_ENV)
            for r in range(world)]
    try:
        for mesh, ps in procs.items():
            for p in ps:
                _, err = p.communicate(timeout=240)
                assert p.returncode == 0, err[-3000:]
            out[mesh] = [dict(np.load(f"{tmp}/out{mesh[0]}{mesh[1]}.{r}.npz"))
                         for r in range(len(ps))]
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
                p.wait(timeout=30)
    return out


_REF = {}


def _reference(name: str) -> dict:
    """The whole model on one rank, on the whole batch."""
    if name not in _REF:
        cfg = cases.RECURRENT[name]()
        got = cases.outputs(cfg, build_model(cfg, "cpu"), cases.batch_of(cfg),
                            slice(0, cases.BATCH), grads=True)
        _REF[name] = {k: (v if isinstance(v, list) else v.numpy()) for k, v in got.items()}
    return _REF[name]


def _rows(results, mesh, name, key):
    """``key`` of every data group, in row order (each group's first rank)."""
    data, model = mesh
    return np.concatenate([results[d * model][f"{name}/{key}"] for d in range(data)])


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


_PARAMS = [(m, n) for m in _MESHES for n in cases.RECURRENT]
_IDS = [f"{d}x{m}-{n}" for (d, m), n in _PARAMS]


@pytest.mark.parametrize("mesh,name", _PARAMS, ids=_IDS)
def test_forward_and_loss_equal_one_rank(ranks, mesh, name):
    """Hidden states, the logits after the prompt (decode steps: the state
    of the rank's heads) and the loss (the data groups' mean) equal the
    whole model's on one rank in fp32; the initial parameters, put back
    together, equal its draw bit for bit."""
    ref, got = _reference(name), ranks[mesh]
    assert _rel(_rows(got, mesh, name, "hidden"), ref["hidden"]) < 1e-5
    assert _rel(_rows(got, mesh, name, "prefill"), ref["prefill"]) < 1e-5
    assert _rel(got[0][f"{name}/loss"], ref["loss"]) < 1e-6
    for j, want in enumerate(ref["init"]):
        assert np.array_equal(got[0][f"{name}/init/{j}"], want.numpy())


@pytest.mark.parametrize("mesh,name", _PARAMS, ids=_IDS)
def test_first_gradients_equal_one_rank(ranks, mesh, name):
    """The first step's gradients (the data groups' mean, every leaf put
    back together) to 1e-4 of each leaf's largest entry."""
    ref, got = _reference(name), ranks[mesh]
    for j, want in enumerate(ref["grads"]):
        assert _rel(got[0][f"{name}/grads/{j}"], want.numpy()) < 1e-4, j


@pytest.mark.parametrize("mesh,name", _PARAMS, ids=_IDS)
def test_two_clipped_steps_equal_one_rank(ranks, mesh, name):
    """Two fp32 steps with a clip of 1e-3 (engaged): the losses and global
    norms (1e-5 relative; measured at most 2.4e-6), and every parameter
    after them, equal the whole model's steps on one rank."""
    ref, got = _reference(name), ranks[mesh]
    assert (ref["metrics"][:, 1] > 10 * cases.OPT.grad_clip).all()
    assert np.abs(got[0][f"{name}/metrics"] / ref["metrics"] - 1).max() < 1e-5
    for j, want in enumerate(ref["params"]):
        above, below = _param_errors(got[0][f"{name}/params/{j}"], want.numpy(), ref, j)
        assert above < 2e-4, j
        assert below < (_BELOW_EPS_TOL if name == "rwkv_mid_head" else 2e-4), j


# rwkv_mid_head's entries whose clipped first gradient is at most Adam's eps
# (an ln1 bias among them): Adam divides by that eps, so their steps follow
# the sum's rounding (test_mid_head_steps_follow_the_sum_order)
_BELOW_EPS_TOL = 1e-3


def _param_errors(got, want, ref, j) -> tuple[float, float]:
    """The largest error of leaf ``j`` after the two steps, relative to its
    largest entry, over the entries whose clipped first gradient in the
    one-rank run is above Adam's eps, and over the others."""
    err = np.abs(np.asarray(got, np.float64) - want) / max(np.abs(want).max(), 1e-30)
    scale = min(cases.OPT.grad_clip / float(ref["metrics"][0, 1]), 1.0)
    small = np.abs(ref["grads"][j].numpy()) * scale <= cases.OPT.eps
    return (float(err[~small].max()) if (~small).any() else 0.0,
            float(err[small].max()) if small.any() else 0.0)


@pytest.mark.parametrize("parts", [2, 4])
def test_mid_head_steps_follow_the_sum_order(monkeypatch, parts):
    """The noise floor ``rwkv_mid_head``'s tolerance rests on: its whole
    model on one rank, with the channel mix's v = k Wv summed over ``parts``
    blocks of d_ff (what a split does), ends its two clipped steps within
    2e-4 of a leaf's largest entry of the plain sum on the entries whose
    clipped first gradient is above Adam's eps and within 1e-3 on the
    others, its metrics within 1e-5."""
    cfg = cases.RECURRENT["rwkv_mid_head"]()
    want = _reference("rwkv_mid_head")
    plain = rwkv6.channel_mix

    def in_parts(cm, x, x_prev=None, tp=None):
        dx = rwkv6._shift(x, x_prev) - x
        lerp = lambda mu: x + dx * cm[mu].to(x.dtype)
        k = torch.square(torch.relu(lerp("mu_k") @ cm["Wk"]))
        n = k.shape[-1] // parts
        v = sum(k[..., i * n:(i + 1) * n] @ cm["Wv"][i * n:(i + 1) * n] for i in range(parts))
        return torch.sigmoid(lerp("mu_r") @ cm["Wr"]) * v, x[:, -1]

    monkeypatch.setattr(rwkv6, "channel_mix", in_parts)
    got = cases.outputs(cfg, build_model(cfg, "cpu"), cases.batch_of(cfg), slice(0, cases.BATCH))
    monkeypatch.setattr(rwkv6, "channel_mix", plain)
    for j, (a, b) in enumerate(zip(got["params"], want["params"])):
        above, below = _param_errors(a.numpy(), b.numpy(), want, j)
        assert above < 2e-4 and below < _BELOW_EPS_TOL, (j, above, below)
    assert np.abs(got["metrics"].numpy() / want["metrics"] - 1).max() < 1e-5


def test_bf16_gradient_noise_is_the_models():
    """The witness phase 60's bf16 checks are read against: at the port's
    seed-0 weights (reduced rwkv6, one rank, [2, 64]) the first bf16
    gradient lies far from the fp32 one in the JAX package's own model too
    (over 5 % of the fp32 gradient's norm; 11.8 % measured): the model
    amplifies bf16's rounding there.  The port's lies within twice that
    (17.8 % measured)."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import rwkv6 as jrwkv6
    from repro_torch.models.convert import _stack_blocks

    cfg, jcfg = cases.RECURRENT["rwkv6"](), jconfigs.get_config("rwkv6-3b").reduced()
    params = rwkv6.init_params(cfg, 0, "cpu")
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (2, 64))

    def port(dtype):
        p = map_tree(lambda t: t.detach().clone().requires_grad_(True), params)
        rwkv6.loss_fn(cfg, p, {"tokens": torch.from_numpy(tokens)}, dtype=dtype).backward()
        return [t.grad.double().numpy() for t in leaves(p)]

    jparams = jax.tree.map(jnp.asarray, _stack_blocks(params))

    def ref(dtype):
        grads = jax.grad(lambda q: jrwkv6.loss_fn(jcfg, q, {"tokens": jnp.asarray(tokens)},
                                                  dtype=dtype))(jparams)
        return [np.asarray(g, np.float64) for g in jax.tree_util.tree_leaves(grads)]

    def off(g16, g32):
        norm = lambda gs: sum(float(np.square(g).sum()) for g in gs) ** 0.5
        return norm([a - b for a, b in zip(g16, g32)]) / norm(g32)

    jax_off = off(ref(jnp.bfloat16), ref(jnp.float32))
    port_off = off(port(torch.bfloat16), port(torch.float32))
    assert jax_off > 0.05, jax_off
    assert port_off < 2 * jax_off, (port_off, jax_off)


@pytest.mark.parametrize("mesh,name", _PARAMS, ids=_IDS)
def test_replicated_leaves_bit_identical_across_model_group(ranks, mesh, name):
    """The leaves no rule splits are the same bits on every rank of a model
    group after two steps, those a rank uses on its own heads included."""
    data, model = mesh
    got = ranks[mesh]
    for r in range(data * model):
        first = got[(r // model) * model][f"{name}/replicated"]
        assert np.array_equal(got[r][f"{name}/replicated"], first)
    assert got[0][f"{name}/replicated"].size > 0


@pytest.mark.parametrize("mesh,name", _PARAMS, ids=_IDS)
def test_greedy_tokens_equal_one_rank(ranks, mesh, name):
    """``greedy_generate`` on every rank of the mesh gives the whole model's
    tokens."""
    got = ranks[mesh]
    data, model = mesh
    assert np.array_equal(_rows(got, mesh, name, "greedy"), _reference(name)["greedy"])
    for r in range(data * model):
        assert np.array_equal(got[r][f"{name}/greedy"], got[(r // model) * model][f"{name}/greedy"])


@pytest.mark.parametrize("mesh", _MESHES, ids=[f"{d}x{m}" for d, m in _MESHES])
def test_decay_lora_split_on_d_equals_whole_block(ranks, mesh):
    """One RWKV-6 block with ``wA`` split on its rows and ``wB`` on its
    columns (the full-size specs, forced): the output and the input's
    gradient to 1e-5 of their largest entry, every gradient (put back
    together) to 1e-4 of its leaf's largest entry, against the whole
    block on one rank."""
    want = cases.lora_block()
    data, model = mesh
    for r in range(data * model):
        got = ranks[mesh][r]
        assert got["lora/split"].tolist() == [0, 1, 64 // model]
        assert _rel(got["lora/y"], want["y"].numpy()) < 1e-5
        assert _rel(got["lora/dx"], want["dx"].numpy()) < 1e-5
        for j, g in enumerate(want["grads"]):
            assert _rel(got[f"lora/grads/{j}"], g.numpy()) < 1e-4, j


# ------------------------------------------------- checkpoints under the split
_LAUNCH = textwrap.dedent("""
    import json, sys
    sys.modules["jax"] = None
    import torch.distributed as dist
    from repro_torch.launch import mesh as launch_mesh, train as launcher

    rank, world, store, ckpt, steps, model_axis = sys.argv[1:7]
    dist.init_process_group("gloo", init_method="file://" + store, rank=int(rank),
                            world_size=int(world))
    argv = ["--arch", "rwkv6-3b", "--reduced", "--steps", steps, "--batch", "4", "--seq", "24",
            "--device", "cpu", "--ckpt-dir", ckpt, "--ckpt-every", "2"]
    if int(world) == 4:  # the production mesh's path, on a (2, 2) stand-in for (16, 16)
        launch_mesh.production_axes = lambda multi_pod=False: {"data": 2, "model": 2}
        argv += ["--mesh", "prod"]
    else:
        argv += ["--resume", "--model-axis", model_axis]
    out = launcher.run(launcher.parse_args(argv))
    print("RESULT " + json.dumps({"start": out["start"], "losses": out["losses"]}))
    dist.destroy_process_group()
""")


def _spawn(argv_of_rank, world: int, timeout: float = 240) -> list[str]:
    procs = [subprocess.Popen([sys.executable, *argv_of_rank(rank)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=_ROOT, env=_ENV)
             for rank in range(world)]
    try:
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
        return outs
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)


def _result(out: str):
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert line, out[-2000:]
    return json.loads(line[-1][len("RESULT "):])


def test_checkpoint_of_rwkv6_resumes_on_another_mesh(tmp_path):
    """The launcher trains reduced rwkv6-3b two steps on a (2, 2) mesh
    through ``--mesh prod`` (its axes patched to (2, 2)) and saves the whole
    model in the JAX layout; a (1, 2) run resumes from it and steps.  The
    checkpoint holds every leaf whole, and the losses are those of the
    launcher at a world of one, to bf16 rounding (tolerance 2e-3)."""
    ckpt = tmp_path / "ckpt"
    run = lambda world, steps, model_axis: [_result(o) for o in _spawn(
        lambda r: ["-c", _LAUNCH, str(r), str(world), str(tmp_path / f"store{world}"),
                   str(ckpt), str(steps), str(model_axis)], world)]
    first = run(4, 2, 2)
    step, flat = load_checkpoint(str(ckpt))
    assert step == 2
    cfg = tconfigs.get_config("rwkv6-3b").reduced()
    assert flat["params/blocks/tm/Wv"].shape == (cfg.n_layers, cfg.d_model, cfg.d_model)
    assert flat["params/lm_head/w"].shape == (cfg.d_model, cfg.vocab)
    second = run(2, 3, 2)
    assert all(r == first[0] for r in first) and all(r == second[0] for r in second)
    assert second[0]["start"] == 2 and len(second[0]["losses"]) == 1
    from repro_torch.launch import train as launcher
    one = launcher.run(launcher.parse_args(
        ["--arch", "rwkv6-3b", "--reduced", "--steps", "3", "--batch", "4", "--seq", "24",
         "--device", "cpu"]))
    got = first[0]["losses"] + second[0]["losses"]
    assert np.allclose(got, one["losses"], rtol=2e-3, atol=0), (got, one["losses"])


def test_init_blocks_equal_shard_tree_of_the_whole_draw():
    """``init_params`` under ``tp`` keeps exactly ``shard_tree``'s blocks of
    the one-rank draw, bit for bit, for both families at model 2 and 4."""
    for name in ("rwkv6", "zamba2"):
        cfg = cases.RECURRENT[name]()
        whole = build_model(cfg, "cpu").init_params(0)
        for model in (2, 4):
            for r in range(model):
                mesh = _fake_mesh(model, r)
                tp = tensor_parallel(cfg, mesh)
                want = shard_tree(whole, tp.specs, mesh)
                got = build_model(cfg, "cpu", tp=mesh).init_params(0)
                assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))
